"""The training slice of the port against the JAX package: the posed query
(inverse skinning, the weight volume, the posed render), BatchNorm in
training mode, the train step, finetuning, the optimizer, the schedules
and checkpoints.

One fixture holds the JAX oracle: the JAX package's build_train_env at a
small size (batch 2, 32 rays x 8 samples, 256 + 64 points, a 128^2
position map, the toy body) with GeoTexAvatar from PRNGKey(0), whose
density head and offset head are redrawn from numpy (as
tests/test_torch_nerf.py does) so that the rays carry density and the
warp field moves the points; the port loads the same weights through
weights.avatar_state_dict_from_jax. Its batch is the port's
tools.bench_workloads.train_batch(posed=True) on the JAX body's vertices:
the JAX batch's draws (checked equal), then seeded rigid joint transforms.
Sample jitter: JAX's own uniform draws, passed to the port as ``t_rand``.

Tolerances. Both sides run the same float32 formulas in different
summation orders: the stateless geometry at 1e-6; the pose features in
training mode agree to ~3e-6 relative (batch statistics of 13 layers), and
the template's PE(10) turns the warped points' float32 noise into
gradients that agree to ~1e-3 relative. Adam's first step moves every
weight by lr * g / (|g| + eps): an element whose gradient is ~0 (every
bias that feeds a BatchNorm has a gradient of exactly 0 in exact
arithmetic, float32 noise on each side) moves by +-lr on either side, so
parameters are held by their share within 1e-6 and every element within
2 lr + 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

KW = dict(batch_size=2, n_rays=32, n_surf=256, n_vol=64, pos_map_res=128)
N_SAMPLES = 8
B, R = KW["batch_size"], KW["n_rays"]
# the share of each group's parameter elements that must agree within
# 1e-6 after a first Adam step (measured 99.86-99.95%; the rest are the
# +-lr moves of gradients ~0), and within 1e-5 after a second (measured
# 99.78-99.95%: its step divides by the root of two gradients' squares,
# which turns their ~1e-3 relative agreement into ~1e-3 lr)
STEP_SHARE = 0.995
STEP_TOL = (1e-6, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Fewer torch threads beside XLA's in one process: with torch's
    default (one per core) this file's steps ran ~10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def env():
    from avatarcap_tpu.tools.bench_workloads import build_train_env
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.tools.bench_workloads import train_batch
    from avatarcap_tpu_torch.utils.toy_body import make_toy_smpl_params
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax

    jenv = build_train_env(n_samples=N_SAMPLES, dense=False, **KW)
    js = jenv["statics"]
    rs = np.random.RandomState(7)
    params = _np(jenv["state"].params)
    geo = params["cano_template"]["geo_mlp"]
    geo["fc1_kernel"] = (0.3 * rs.standard_normal((128, 2))).astype(
        np.float32)
    geo["fc1_bias"] = np.full((2,), 0.5, np.float32)
    params["warping_field"]["out_layer_coord_affine"]["kernel"] = \
        rs.uniform(-0.002, 0.002, (256, 3)).astype(np.float32)
    variables = {"params": params,
                 "batch_stats": _np(jenv["state"].batch_stats)}
    v = np.asarray(js.cano_smpl_vertices)
    center = np.asarray(js.cano_smpl_center)
    smpl = make_toy_smpl_params()
    flat = train_batch(smpl, v, center, **KW)
    posed = train_batch(smpl, v, center, posed=True, **KW)
    tstatics = AvatarStatics(*(torch.from_numpy(np.array(a)) for a in js))

    def port_model():
        m = GeoTexAvatar()
        m.load_state_dict(avatar_state_dict_from_jax(variables))
        return m

    return dict(jenv=jenv, module=jenv["trainer"].module, js=js,
                variables=variables, batch=posed, flat_batch=flat,
                tstatics=tstatics, port_model=port_model)


def _jbatch(batch):
    return {k: jnp.asarray(a) for k, a in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


def _frames(batch):
    from avatarcap_tpu.pipeline.avatar import FrameInputs as JF
    from avatarcap_tpu_torch.pipeline.avatar import FrameInputs as TF
    keys = ("live_smpl_v", "cano2live_jnt_mats", "smpl_pos_map")
    return (JF(*(jnp.asarray(batch[k]) for k in keys)),
            TF(*(torch.from_numpy(batch[k]) for k in keys)))


def _t_rand(seed):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.uniform(key, (B, R, N_SAMPLES)))


def test_train_batch_matches_jax(env):
    """The port's train_batch draws the JAX batch exactly; posed=True
    changes only the joint mats and the live vertices."""
    jb = env["jenv"]["batch"]
    assert set(jb) == set(env["flat_batch"])
    for k, a in jb.items():
        np.testing.assert_array_equal(env["flat_batch"][k], a, err_msg=k)
        if k not in ("cano2live_jnt_mats", "live_smpl_v"):
            np.testing.assert_array_equal(env["batch"][k], a, err_msg=k)
    mats = env["batch"]["cano2live_jnt_mats"]
    rot = mats[..., :3, :3]
    np.testing.assert_allclose(rot @ np.swapaxes(rot, -1, -2),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-6)
    assert np.abs(rot - np.eye(3)).max() > 0.05


def test_rigid_inverse_skin_points_knn_gather():
    from avatarcap_tpu.body.skinning import skin_points as jskin
    from avatarcap_tpu.ops.knn import knn_gather as jgather
    from avatarcap_tpu.ops.se3 import (axis_angle_to_matrix,
                                       rigid_inverse as jinv)
    from avatarcap_tpu_torch.body.skinning import skin_points
    from avatarcap_tpu_torch.ops.knn import knn_gather
    from avatarcap_tpu_torch.ops.se3 import rigid_inverse

    rs = np.random.RandomState(0)
    J, N = 24, 500
    mats = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    mats[:, :3, :3] = np.asarray(axis_angle_to_matrix(
        jnp.asarray(rs.uniform(-1, 1, (J, 3)).astype(np.float32))))
    mats[:, :3, 3] = rs.uniform(-1, 1, (J, 3))
    got = rigid_inverse(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jinv(jnp.asarray(mats))),
                               atol=1e-6)
    np.testing.assert_allclose(got @ mats,
                               np.broadcast_to(np.eye(4), mats.shape),
                               atol=1e-6)

    lbs = rs.uniform(0, 1, (N, J)).astype(np.float32)
    lbs /= lbs.sum(-1, keepdims=True)
    pts = rs.uniform(-1, 1, (N, 3)).astype(np.float32)
    ref = np.asarray(jskin(jnp.asarray(pts), jnp.asarray(lbs),
                           jnp.asarray(mats)))
    got = skin_points(*map(torch.from_numpy, (pts, lbs, mats))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)

    idx = rs.randint(0, J, (N, 3))
    np.testing.assert_array_equal(
        knn_gather(torch.from_numpy(mats.reshape(J, 16)),
                   torch.from_numpy(idx)).numpy(),
        np.asarray(jgather(jnp.asarray(mats.reshape(J, 16)),
                           jnp.asarray(idx))))


def test_sample_weight_volume():
    """Non-cubic volume (the [2, 1, 0] axis swap shows), points inside
    and past the border."""
    from avatarcap_tpu.models.avatar import sample_weight_volume as jswv
    from avatarcap_tpu_torch.models.avatar import sample_weight_volume
    rs = np.random.RandomState(1)
    vol = rs.uniform(0, 1, (7, 5, 4, 24)).astype(np.float32)
    pts = rs.uniform(-0.1, 1.1, (2, 300, 3)).astype(np.float32)
    ref = np.asarray(jswv(jnp.asarray(vol), jnp.asarray(pts)))
    got = sample_weight_volume(torch.from_numpy(vol),
                               torch.from_numpy(pts)).numpy()
    assert got.shape == (2, 300, 24)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_unet_batch_statistics(env):
    """The U-Net in training mode on the batch's position maps: outputs,
    then the running statistics after one and two updates against flax's
    batch_stats (biased running variance; upconv3 updates twice per
    forward)."""
    from avatarcap_tpu_torch.pipeline.avatar import compute_pose_features
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    module, variables = env["module"], env["variables"]
    model = env["port_model"]().eval()
    pos = env["batch"]["smpl_pos_map"]
    stats = variables["batch_stats"]
    for update in (1, 2):
        feat, upd = module.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(pos), True, method=lambda m, x, t: m.pose_features(
                x, t), mutable=["batch_stats"])
        stats = _np(upd["batch_stats"])
        got = compute_pose_features(model, torch.from_numpy(pos),
                                    train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(feat),
                                   rtol=1e-4, atol=1e-4)
        ref = avatar_state_dict_from_jax({"params": variables["params"],
                                          "batch_stats": stats})
        sd = model.state_dict()
        keys = [k for k in ref if ".unet." in k and "running" in k]
        assert len(keys) == 2 * 10
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert int(sd["warping_field.unet.upconv3.bn.num_batches_tracked"]
                   ) == 2 * update
    assert not model.warping_field.unet.training      # its mode restored


def test_offset_decoder_batch_statistics():
    """The OffsetDecoder (affine BatchNorm1d) in training mode on (2, 300,
    67) points: outputs and the running statistics after one and two
    updates against flax's."""
    from avatarcap_tpu.models.mlp import OffsetDecoder as JOD
    from avatarcap_tpu_torch.models.mlp import OffsetDecoder
    rs = np.random.RandomState(2)
    x = (rs.standard_normal((2, 300, 67)) + 0.5).astype(np.float32)
    jm = JOD()
    variables = _np(jax.jit(jm.init)(jax.random.PRNGKey(1),
                                     jnp.asarray(x)))
    port = OffsetDecoder(67)
    sd = port.state_dict()
    for i in range(1, 8):
        p, s = variables["params"], variables["batch_stats"]
        sd[f"conv{i}.weight"] = torch.from_numpy(
            p[f"conv{i}"]["kernel"].T[:, :, None].copy())
        sd[f"conv{i}.bias"] = torch.from_numpy(p[f"conv{i}"]["bias"])
        sd[f"bn{i}.weight"] = torch.from_numpy(
            rs.uniform(0.8, 1.2, 256).astype(np.float32))
        sd[f"bn{i}.bias"] = torch.from_numpy(
            rs.uniform(-0.1, 0.1, 256).astype(np.float32))
        p[f"bn{i}"] = {"scale": sd[f"bn{i}.weight"].numpy(),
                       "bias": sd[f"bn{i}.bias"].numpy()}
        sd[f"bn{i}.running_mean"] = torch.from_numpy(s[f"bn{i}"]["mean"])
        sd[f"bn{i}.running_var"] = torch.from_numpy(s[f"bn{i}"]["var"])
    port.load_state_dict(sd)
    port.train()
    stats = variables["batch_stats"]
    for _ in range(2):
        ref, upd = jm.apply({"params": variables["params"],
                             "batch_stats": stats}, jnp.asarray(x), True,
                            mutable=["batch_stats"])
        stats = _np(upd["batch_stats"])
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
        for i in range(1, 8):
            for ours, theirs in (("running_mean", "mean"),
                                 ("running_var", "var")):
                np.testing.assert_allclose(
                    getattr(port, f"bn{i}").__getattr__(ours).numpy(),
                    stats[f"bn{i}"][theirs], rtol=1e-5, atol=1e-6,
                    err_msg=f"bn{i}.{ours}")


def test_inverse_skin_points(env):
    """Ray samples of the posed batch: canonical points and near flags
    (the same KNN on both sides: the flags equal)."""
    from avatarcap_tpu.pipeline.avatar import inverse_skin_points as jisp
    from avatarcap_tpu_torch.pipeline.avatar import inverse_skin_points
    b = env["batch"]
    rs = np.random.RandomState(3)
    z = rs.uniform(1.5, 2.5, (B, 256, 1)).astype(np.float32)
    wpts = (b["ray_o"][:, :1] + b["ray_d"][:, :1] * z
            + rs.uniform(-0.4, 0.4, (B, 256, 3))).astype(np.float32)
    jf, tf = _frames(b)
    cano_j, near_j = jisp(jnp.asarray(wpts), jf, env["js"])
    cano_t, near_t = inverse_skin_points(torch.from_numpy(wpts), tf,
                                         env["tstatics"])
    np.testing.assert_array_equal(near_t.numpy(), np.asarray(near_j))
    assert 0.05 < near_t.float().mean() < 0.95
    np.testing.assert_allclose(cano_t.numpy(), np.asarray(cano_j),
                               atol=1e-6)
    assert np.abs(cano_t.numpy() - wpts).max() > 0.05     # posed != cano


def test_render_rays_posed(env):
    """render_rays(pts_space="posed") in eval mode with JAX's jitter."""
    from avatarcap_tpu.pipeline.avatar import (
        compute_pose_features as jfeat, render_rays as jrender)
    from avatarcap_tpu_torch.pipeline.avatar import (
        compute_pose_features, render_rays)
    b = env["batch"]
    jf, tf = _frames(b)
    model = env["port_model"]().eval()
    key, t_rand = _t_rand(11)
    jb = _jbatch(b)
    feat_j, _ = jfeat(env["module"], env["variables"], jf.smpl_pos_map)
    ref, _ = jrender(env["module"], env["variables"], jb["ray_o"],
                     jb["ray_d"], jb["near"], jb["far"], jb["depth"], feat_j,
                     jf, env["js"], n_samples=N_SAMPLES, perturb=True,
                     rng=key)
    tb = _tbatch(b)
    with torch.no_grad():
        got = render_rays(model, tb["ray_o"], tb["ray_d"], tb["near"],
                          tb["far"], tb["depth"],
                          compute_pose_features(model, tf.smpl_pos_map),
                          env["tstatics"], n_samples=N_SAMPLES, perturb=True,
                          t_rand=torch.from_numpy(t_rand), pts_space="posed",
                          frame=tf)
    assert float(np.asarray(ref["acc_map"]).max()) > 0.05
    for k in ("rgb_map", "acc_map", "depth_map", "raw", "occ",
              "nonrigid_offset"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=2e-5, err_msg=k)


def test_occupancy_form_train_step(env):
    """The occupancy form (a sigmoid geometry head, trained with BCE
    against inside labels): one train step of GeoTexAvatar(if_type=
    "occupancy") on the module fixture's weights against JAX's
    make_train_step with if_type="occupancy" (perturb on, JAX's draws):
    the five losses, the BatchNorm statistics and the parameters, by the
    first step's share rule. An if_type neither package has is
    refused."""
    from avatarcap_tpu.models.avatar import GeoTexAvatar as JGeoTex
    from avatarcap_tpu.train.trainer import AvatarTrainer as JTrainer
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    with pytest.raises(ValueError, match="if_type"):
        GeoTexAvatar(if_type="udf")
    lrs = np.asarray((1e-3, 1e-4), np.float32)
    jtrainer = JTrainer(module=JGeoTex(if_type="occupancy"),
                        statics=env["js"], net_ckpt_dir="unused",
                        if_type="occupancy", n_samples=N_SAMPLES)
    jstate = jtrainer.init_state(jax.tree.map(jnp.asarray,
                                              env["variables"]))
    model = GeoTexAvatar(if_type="occupancy")
    model.load_state_dict(avatar_state_dict_from_jax(env["variables"]))
    trainer = AvatarTrainer(statics=env["tstatics"], net_ckpt_dir="unused",
                            if_type="occupancy", n_samples=N_SAMPLES,
                            device="cpu")
    state = trainer.init_state(model)
    key, t_rand = _t_rand(300)
    jstate, jm = jtrainer.train_step(jstate, _jbatch(env["batch"]),
                                     jnp.asarray(lrs), key)
    state, m = trainer.train_step(state, _tbatch(env["batch"]), lrs,
                                  t_rand=torch.from_numpy(t_rand))
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    _check_state(state, jstate, lrs, STEP_TOL[0])


def test_geometry_losses():
    """The SDF L1 and the occupancy BCE of the loss, against the JAX
    step's formulas."""
    from avatarcap_tpu.train.trainer import _bce as jbce
    from avatarcap_tpu_torch.train.trainer import geometry_loss
    rs = np.random.RandomState(4)
    pred = rs.uniform(-0.2, 1.2, (2, 50, 1)).astype(np.float32)
    target = rs.uniform(-0.3, 0.3, (2, 50)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    sdf = np.mean(np.abs(pred[..., 0] - np.clip(target, -0.1, 0.1) / 0.1))
    np.testing.assert_allclose(float(geometry_loss(tp, tt)), sdf, rtol=1e-6)
    bce = float(jnp.mean(jbce(jnp.asarray(pred[..., 0]),
                              jnp.asarray((target > 0).astype(np.float32)))))
    np.testing.assert_allclose(float(geometry_loss(tp, tt, "occupancy")),
                               bce, rtol=1e-6)


def _adam_flat(opt_state, group, variables, port_params):
    """One group's (mu, nu, count) of the JAX optimizer state, flattened
    in the port's parameter order."""
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    inner = opt_state.inner_states[
        "template" if group == "cano_template" else "warp"].inner_state[0]
    out = []
    for tree in (inner.mu, inner.nu):
        full = dict(_np(variables["params"]))
        full[group] = _np(tree[group])
        sd = avatar_state_dict_from_jax({"params": full,
                                         "batch_stats":
                                             variables["batch_stats"]})
        out.append(torch.cat([sd[n].reshape(-1) for n in port_params]))
    return out[0], out[1], int(inner.count)


def _param_names(model, group):
    return [n for n, _ in model.named_parameters()
            if n.startswith("cano_template.") == (group == "cano_template")]


def _check_state(port_state, jstate, lrs, tol):
    """The port's state after a step against JAX's: every element within
    2 lr + 1e-6 and STEP_SHARE of each group within ``tol``; the
    BatchNorm statistics."""
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    ref = avatar_state_dict_from_jax({"params": _np(jstate.params),
                                      "batch_stats": _np(
                                          jstate.batch_stats)})
    sd = port_state.model.state_dict()
    for gi, group in enumerate(("cano_template", "warping_field")):
        d = np.concatenate([np.abs(sd[n].numpy() - ref[n].numpy()).ravel()
                            for n in _param_names(port_state.model, group)])
        assert d.max() <= 2 * lrs[gi] + 1e-6, (group, d.max())
        assert (d <= tol).mean() >= STEP_SHARE, (group, (d <= tol).mean())
    for k in ref:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("lrs", [(1e-3, 1e-4), (1e-3, 0.0)])
def test_train_steps_match_jax(env, lrs):
    """One and two train steps against JAX's train_step (perturb on, JAX's
    draws): the five losses, the BatchNorm statistics and the parameters.

    The second step starts both sides from JAX's state after the first
    (parameters, statistics, Adam moments and count loaded into the
    port): a first step of lr 1e-3 moves every template weight by ~lr, and
    gradients that agree to ~1e-3 would otherwise make the second step's
    comparison one of the two implementations' drift."""
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    lrs = np.asarray(lrs, np.float32)
    jtrainer = env["jenv"]["trainer"]
    jstate = jtrainer.init_state(jax.tree.map(jnp.asarray,
                                              env["variables"]))
    trainer = AvatarTrainer(statics=env["tstatics"], net_ckpt_dir="unused",
                            n_samples=N_SAMPLES, device="cpu")
    model = env["port_model"]()
    state = trainer.init_state(model)
    jb, tb = _jbatch(env["batch"]), _tbatch(env["batch"])
    for step in range(2):
        key, t_rand = _t_rand(100 + step)
        jstate, jm = jtrainer.train_step(jstate, jb, jnp.asarray(lrs), key)
        state, m = trainer.train_step(state, tb, lrs,
                                      t_rand=torch.from_numpy(t_rand))
        assert state.step == step + 1
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                       err_msg=k)
        _check_state(state, jstate, lrs, STEP_TOL[step])
        if lrs[1] == 0:
            for n, p in state.model.named_parameters():
                if n.startswith("warping_field."):
                    assert torch.equal(p, model.state_dict()[n]), n
        # the next step from JAX's state
        variables = {"params": _np(jstate.params),
                     "batch_stats": _np(jstate.batch_stats)}
        state.model.load_state_dict(avatar_state_dict_from_jax(variables))
        for g, opt in state.opt.items():
            mu, nu, count = _adam_flat(jstate.opt_state, g, variables,
                                       _param_names(state.model, g))
            assert count == opt.count == step + 1
            # the first moments carry the gradients: held relative to
            # their norm (measured 1.4e-4 to 8.7e-3)
            rel = float((opt.mu - mu).norm() / mu.norm())
            assert rel < 2e-2, (g, rel)
            opt.load_state_dict({"mu": mu, "nu": nu, "count": count})


def test_finetune_step_matches_jax(env):
    """One finetune step against JAX's make_finetune_step (Adam 5e-4 on
    the template, the rest set to zero): losses, template parameters by
    the share rule, the warp field unchanged bit for bit, its BatchNorm
    statistics updated as JAX's, the anchor model untouched."""
    import optax
    from avatarcap_tpu.train.finetune import make_finetune_step as jmake
    from avatarcap_tpu.train.trainer import TrainState
    from avatarcap_tpu_torch.train.finetune import (finetune_state,
                                                    make_finetune_step)
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax

    def label_fn(p):
        return jax.tree.map_with_path(
            lambda path, _: "train" if path[0].key == "cano_template"
            else "freeze", p)
    opt = optax.multi_transform(
        {"train": optax.adam(5e-4), "freeze": optax.set_to_zero()}, label_fn)
    jstep = jmake(env["module"], opt, env["js"], n_samples=N_SAMPLES)
    v = jax.tree.map(jnp.asarray, env["variables"])
    init_vars = jax.tree.map(jnp.copy, v)
    jstate = TrainState(jax.tree.map(jnp.copy, v["params"]),
                        jax.tree.map(jnp.copy, v["batch_stats"]),
                        opt.init(v["params"]), jnp.zeros((), jnp.int32))
    key, t_rand = _t_rand(200)
    jstate, jm = jstep(jstate, init_vars, _jbatch(env["batch"]), key)

    init_model = env["port_model"]()
    before = {k: t.clone() for k, t in init_model.state_dict().items()}
    state = finetune_state(env["port_model"]())
    step = make_finetune_step(env["tstatics"], n_samples=N_SAMPLES)
    state, m = step(state, init_model, _tbatch(env["batch"]),
                    t_rand=torch.from_numpy(t_rand))
    for k, val in jm.items():
        np.testing.assert_allclose(float(m[k]), float(val), rtol=1e-5,
                                   err_msg=k)
    ref = avatar_state_dict_from_jax({"params": _np(jstate.params),
                                      "batch_stats": _np(
                                          jstate.batch_stats)})
    sd = state.model.state_dict()
    d = np.concatenate([np.abs(sd[n].numpy() - ref[n].numpy()).ravel()
                        for n in _param_names(state.model,
                                              "cano_template")])
    assert d.max() <= 2 * 5e-4 + 1e-6
    assert (d <= STEP_TOL[0]).mean() >= STEP_SHARE
    for n in _param_names(state.model, "warping_field"):
        assert torch.equal(sd[n], before[n]), n
    for k in ref:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            assert not torch.equal(sd[k], before[k]), k
    for k, t in init_model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_adam_matches_optax():
    """Three steps of the port's Adam against optax.adam's order of
    operations (the trainer's lr injection), a zero learning rate on the
    second: bit-level agreement, and the moments advance at lr 0."""
    import optax
    from avatarcap_tpu_torch.ops.adam import Adam
    rs = np.random.RandomState(5)
    shapes = [(3, 4), (5,)]
    params = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    tx = optax.scale_by_adam()
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = Adam(tp)
    for lr in (1e-3, 0.0, 1e-4):
        g = [rs.standard_normal(s).astype(np.float32) for s in shapes]
        u, st = tx.update([jnp.asarray(x) for x in g], st)
        jp = optax.apply_updates(
            jp, jax.tree.map(lambda x: -jnp.float32(lr) * x, u))
        mu_before = opt.mu.clone()
        new = opt.step(tp, [torch.from_numpy(x) for x in g], lr)
        for a, b in zip(new, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
        if lr == 0.0:
            assert all(torch.equal(a, b) for a, b in zip(new, tp))
            assert not torch.equal(opt.mu, mu_before)
        tp = new
    assert opt.count == 3 and int(st.count) == 3
    np.testing.assert_allclose(
        opt.mu.numpy(),
        np.concatenate([np.asarray(x).ravel() for x in st.mu]), atol=1e-7)


def test_schedules_and_epoch_lrs(tmp_path):
    from avatarcap_tpu.train import schedules as js
    from avatarcap_tpu.train.trainer import AvatarTrainer as JTrainer
    from avatarcap_tpu_torch.train import schedules as ts
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    cases = [("Step", dict(Initial=1e-3, Interval=7, Factor=0.5)),
             ("Warmup", dict(Initial=0.0, Final=1e-3, Length=10)),
             ("Constant", dict(Value=3e-4))]
    for kind, kw in cases:
        a = js.get_learning_rate_schedule(kind, **kw)
        b = ts.get_learning_rate_schedule(kind, **kw)
        assert [a(s) for s in range(0, 40, 3)] == \
            [b(s) for s in range(0, 40, 3)], kind
    with pytest.raises(ValueError, match="Unknown"):
        ts.get_learning_rate_schedule("Cosine")
    with pytest.raises(ValueError, match="Interval"):
        ts.get_learning_rate_schedule("Step", Initial=1.0, Factor=0.5)
    z = torch.zeros(2, 3)
    port = AvatarTrainer(statics=AvatarStatics(z, z, z, z, z[0]),
                         net_ckpt_dir=str(tmp_path), device="cpu")
    jt = object.__new__(JTrainer)
    jt.lr_schedule_template = js.StepSchedule(1e-3, 5000, 0.5)
    jt.lr_schedule_warp = js.StepSchedule(1e-4, 20000, 0.5)
    for batch_num in (1, 2500, 12000):
        for epoch in range(4):
            np.testing.assert_array_equal(
                port.epoch_lrs(epoch, batch_num),
                JTrainer.epoch_lrs(jt, epoch, batch_num))
    assert port.epoch_lrs(0, 10)[1] == 0.0
    np.testing.assert_allclose(port.epoch_lrs(3, 12000), [5e-4, 5e-5])


def test_checkpoint_round_trip(env, tmp_path):
    """save_train_state / load_train_state after a step give back every
    parameter, statistic and Adam moment bit for bit, and the step."""
    from avatarcap_tpu_torch.train import checkpoints as ckpt
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    trainer = AvatarTrainer(statics=env["tstatics"], net_ckpt_dir="unused",
                            n_samples=4, device="cpu")
    batch = {k: v[:, :8] if k in ("rgb", "ray_o", "ray_d", "near", "far",
                                  "depth") else v
             for k, v in _tbatch(env["batch"]).items()}
    state, _ = trainer.train_step(trainer.init_state(env["port_model"]()),
                                  batch, [1e-3, 1e-4],
                                  generator=torch.Generator().manual_seed(0))
    ckpt.save_train_state(str(tmp_path / "epoch_0"), state)
    fresh = trainer.init_state(env["port_model"]())
    back = ckpt.load_train_state(str(tmp_path / "epoch_0"), fresh)
    assert back.step == state.step == 1
    a, b = state.model.state_dict(), back.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for g in state.opt:
        for k in ("mu", "nu"):
            assert torch.equal(getattr(state.opt[g], k),
                               getattr(back.opt[g], k)), (g, k)
        assert back.opt[g].count == 1
