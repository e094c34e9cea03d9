"""The fitted bench subject (tools/bench_workloads.py: wrinkle_field, the
two fit targets, the template and decoder fits, build_capture_subject(
fit=True)) against the JAX package's (avatarcap_tpu/tools/
bench_workloads.py), on the sparse toy body and a 48 x 48 x 32 grid.

Tolerances:
- wrinkle_field and the targets: float32 rounding (atol 1e-6 on values of
  size ~1 and 0.05); the KNN's cross term rounds differently on the two
  sides, so a point equidistant to two vertices may take the other one:
  at most 0.1% of the inside flags may differ.
- three steps of each fit, fed the points (or batch indices) the JAX fit
  draws from PRNGKey(7) / PRNGKey(11): the final losses within 1e-4
  relative. The first step's gradients agree to ~1e-4 of each tensor's
  largest entry (the PE's high frequencies and the summation order), but
  Adam's first step moves every weight by about the learning rate
  whatever its gradient's size, so an entry whose gradient is below that
  noise may move the other way, and the next steps' gradients inherit
  the difference: every fitted entry within 2 x 3 x lr = 6e-3 of JAX's,
  99% of all fitted entries and 97% of each tensor's within 0.1 lr
  (measured: 99.4% and 98.0% at worst).
- the fitted subject: the f32 frames of the port and of the JAX package
  on the port's fitted weights have equal triangle counts.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

N_FIT = 2048            # points (template) and batch (decoder) of a step
LR = 1e-3
# capacities of the fitted small subject's frames, its counts plus ~25%
# (the way CAPTURE_OPTIONS are sized to the full-size fitted subject):
# the random subject's coarse-to-fine queries refine more nodes than that
SIZED = dict(use_fused_query=False, refine_capacity=24576,
             recon_refine_capacity=8192)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    # beside the other test workers more threads made the fits crawl; the
    # module scope caps them before the module's subjects are built
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def jax_statics_grid(statics, grid):
    """The port's statics and grid as the JAX package's."""
    from avatarcap_tpu.pipeline.avatar import AvatarStatics
    from avatarcap_tpu.pipeline.capture import CaptureGrid
    js = AvatarStatics(**{k: jnp.asarray(_np(getattr(statics, k)))
                          for k in statics._fields})
    jg = CaptureGrid(jnp.asarray(_np(grid.valid_pts)),
                     jnp.asarray(_np(grid.valid_idx)),
                     jnp.asarray(_np(grid.prior_volume)), grid.vol_res)
    return js, jg


def jax_capture_of(capture, **extra):
    """A JAX AvatarCapture with the port capture's weights (through the
    reference checkpoint converter), statics, grid and options."""
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.models.recon import ReconNetwork
    from avatarcap_tpu.pipeline.capture import AvatarCapture, CaptureOptions
    from avatarcap_tpu.tools.convert_torch_ckpt import (convert_geotex_avatar,
                                                        convert_recon_network)

    def sd(module):
        return {k: v.detach().cpu() for k, v in module.state_dict().items()}

    js, jg = jax_statics_grid(capture.statics, capture.grid)
    opts = dict(dataclasses.asdict(capture.opt), **extra)
    return AvatarCapture(GeoTexAvatar(if_type="sdf"),
                         convert_geotex_avatar(sd(capture.avatar)), js, jg,
                         recon=ReconNetwork(),
                         recon_vars=convert_recon_network(sd(capture.recon)),
                         options=CaptureOptions(**opts))


@pytest.fixture(scope="module")
def body():
    """The port's small toy statics and grid, and JAX-initialised networks
    (PRNGKey(0) avatar, PRNGKey(1) ReconNet) on both sides."""
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.models.recon import ReconNetwork
    from avatarcap_tpu_torch.tools.bench_workloads import (bench_camera,
                                                           build_capture_grid,
                                                           toy_avatar_statics)
    _, statics, _ = toy_avatar_statics(dense=False)
    grid, _ = build_capture_grid(statics, (48, 48, 32), pad_to=4096)
    js, jg = jax_statics_grid(statics, grid)
    module = GeoTexAvatar(if_type="sdf")
    avars = jax.tree.map(np.asarray, jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
        jnp.zeros((1, 128, 128, 6)), js.cano_smpl_center[None]))
    recon = ReconNetwork()
    rvars = jax.tree.map(np.asarray, jax.jit(recon.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 6)),
        jnp.zeros((1, 8, 3)), jnp.zeros((1, 3))))
    return dict(statics=statics, grid=grid, js=js, jg=jg, module=module,
                avars=avars, recon=recon, rvars=rvars,
                inferred=bench_camera(128)[2])


@pytest.mark.parametrize("amp", [0.0, 0.006], ids=["smooth", "wrinkled"])
def test_wrinkle_field_and_targets_match_jax(body, amp):
    from avatarcap_tpu.tools.bench_workloads import wrinkle_field
    from avatarcap_tpu.ops.knn import knn
    from avatarcap_tpu_torch.tools import bench_workloads as bw
    st = body["statics"]
    lo, hi = _np(st.cano_bounds)
    rs = np.random.RandomState(3)
    pts = (lo + rs.uniform(0, 1, (4000, 3)) * (hi - lo)).astype(np.float32)
    c = _np(st.cano_smpl_center)
    np.testing.assert_allclose(
        _np(bw.wrinkle_field(torch.as_tensor(pts - c))),
        np.asarray(wrinkle_field(jnp.asarray(pts - c))), atol=1e-6)
    # the JAX fits' targets, written out as the JAX functions compute them
    verts = body["js"].cano_smpl_vertices
    d2, idx = knn(jnp.asarray(pts), verts, k=1)
    inside = (np.linalg.norm(pts - c, axis=-1)
              < np.linalg.norm(np.asarray(verts)[np.asarray(idx[:, 0])] - c,
                               axis=-1))
    d = np.sqrt(np.maximum(np.asarray(d2[:, 0]), 0.0))
    sd = np.where(inside, d, -d)
    if amp > 0:
        sd = sd + amp * np.asarray(wrinkle_field(jnp.asarray(pts - c)))
    ref_sdf = np.clip(sd, -0.05, 0.05)
    ref_in = (sd > 0.0) if amp > 0 else inside
    tp = torch.as_tensor(pts)
    got_sdf = _np(bw.body_sdf_target(tp, st.cano_smpl_vertices,
                                     st.cano_smpl_center, amp))
    got_in = _np(bw.body_inside_target(tp, st.cano_smpl_vertices,
                                       st.cano_smpl_center, amp))
    flips = got_in != ref_in.astype(np.float32)
    assert flips.mean() <= 1e-3
    np.testing.assert_allclose(got_sdf[~flips], ref_sdf[~flips], atol=1e-6)
    assert 0.05 < got_in.mean() < 0.95 and (np.abs(got_sdf) == 0.05).any()


def _held(pairs, steps):
    """Every entry of the (got, ref) pairs within 2 x steps x lr; 99% of
    all entries and 97% of each pair's within 0.1 lr."""
    ds = [np.abs(got - ref).reshape(-1) for got, ref in pairs]
    for d in ds:
        assert d.max() <= 2 * steps * LR, d.max()
        assert (d <= 0.1 * LR).mean() >= 0.97, (d <= 0.1 * LR).mean()
    pooled = np.concatenate(ds)
    assert (pooled <= 0.1 * LR).mean() >= 0.99, (pooled <= 0.1 * LR).mean()


def test_template_fit_steps_match_jax(body):
    from avatarcap_tpu.tools.bench_workloads import fit_template_to_body
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.ops.adam import Adam
    from avatarcap_tpu_torch.tools.bench_workloads import template_fit_step
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    amp, steps = 0.006, 3
    ref_vars, ref_loss = fit_template_to_body(
        body["module"], body["avars"], body["js"], steps=steps, n_pts=N_FIT,
        lr=LR, wrinkle_amp=amp)
    port = GeoTexAvatar()
    port.load_state_dict(avatar_state_dict_from_jax(body["avars"]))
    adam = Adam(list(port.cano_template.parameters()))
    js = body["js"]
    lo, hi = js.cano_bounds[0], js.cano_bounds[1]
    verts = js.cano_smpl_vertices
    rng = jax.random.PRNGKey(7)
    for _ in range(steps):
        # the JAX fit's draws, in its order
        rng, k1, k2 = jax.random.split(rng, 3)
        pu = jax.random.uniform(k1, (N_FIT // 2, 3)) * (hi - lo) + lo
        vi = jax.random.randint(k2, (N_FIT // 2,), 0, verts.shape[0])
        pn = verts[vi] + 0.03 * jax.random.normal(rng, (N_FIT // 2, 3))
        pts = torch.as_tensor(np.array(jnp.concatenate([pu, pn])))
        loss = template_fit_step(port, adam, body["statics"], pts, LR, amp)
    assert abs(float(loss) - ref_loss) <= 1e-4 * ref_loss
    ref = avatar_state_dict_from_jax(jax.tree.map(np.asarray, ref_vars))
    start = avatar_state_dict_from_jax(body["avars"])
    fitted = []
    for name, p in port.state_dict().items():
        if name.startswith("cano_template."):
            fitted.append((_np(p), ref[name].numpy()))
        else:                                     # frozen: untouched
            np.testing.assert_array_equal(_np(p), ref[name].numpy())
    _held(fitted, steps)
    moved = [name for name in ref if name.startswith("cano_template.")
             and not np.array_equal(ref[name].numpy(), start[name].numpy())]
    assert len(moved) >= 18                  # the color head has no gradient


def test_recon_fit_steps_match_jax(body):
    from avatarcap_tpu.tools.bench_workloads import fit_recon_decoder
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.ops.adam import Adam
    from avatarcap_tpu_torch.tools.bench_workloads import (recon_fit_features,
                                                           recon_fit_step)
    from avatarcap_tpu_torch.weights import recon_state_dict_from_jax
    amp, steps = 0.006, 3
    ref_vars, ref_loss = fit_recon_decoder(
        body["recon"], body["rvars"], body["js"], body["jg"],
        body["inferred"], steps=steps, batch=N_FIT, lr=LR, wrinkle_amp=amp)
    port = ReconNetwork()
    port.load_state_dict(recon_state_dict_from_jax(body["rvars"]))
    grid = body["grid"]
    feats = recon_fit_features(port, body["statics"], grid, body["inferred"])
    assert feats.shape == (grid.valid_pts.shape[0], 33)
    adam = Adam(list(port.image_decoder.parameters()))
    rng = jax.random.PRNGKey(11)
    for _ in range(steps):
        rng, k1 = jax.random.split(rng)
        idx = torch.as_tensor(np.array(jax.random.randint(
            k1, (N_FIT,), 0, feats.shape[0]))).long()
        loss = recon_fit_step(port, adam, body["statics"], feats[idx],
                              grid.valid_pts[idx], LR, amp)
    assert abs(float(loss) - ref_loss) <= 1e-4 * ref_loss
    ref = recon_state_dict_from_jax(jax.tree.map(np.asarray, ref_vars))
    fitted = []
    for name, p in port.state_dict().items():
        if name.startswith("image_decoder."):
            fitted.append((_np(p), ref[name].numpy()))
        else:
            np.testing.assert_array_equal(_np(p), ref[name].numpy())
    _held(fitted, steps)


@pytest.fixture(scope="module")
def subjects():
    """The small subject, random and fitted (SMALL_FIT, no cache), with
    capacities sized to the fitted one."""
    from avatarcap_tpu_torch.tools.bench_workloads import (
        SMALL_CAPTURE_OPTIONS, SMALL_FIT, SMALL_SUBJECT, build_capture_subject)
    out = {}
    for fit in (False, True):
        out[fit] = build_capture_subject(
            "cpu", options=dict(SMALL_CAPTURE_OPTIONS, **SIZED), fit=fit,
            fit_kw=dict(SMALL_FIT, use_cache=False), **SMALL_SUBJECT)
    return out


def test_fitted_subject_against_random(subjects):
    """The fits' losses fall well below the random networks' on the same
    points; the random subject overflows the capacities sized to the
    fitted one, which the fitted subject's frames keep clear."""
    from avatarcap_tpu_torch.tools import bench_workloads as bw
    rand, fitted = subjects[False][0], subjects[True][0]
    info = subjects[True][3]
    assert info["fit"]["cache_hit"] is False and subjects[False][3]["fit"] is None
    st = fitted.statics
    gen = torch.Generator().manual_seed(5)
    pts = bw.template_fit_points(st, 4096, gen)
    with torch.no_grad():
        lr_ = float(bw.template_fit_loss(rand.avatar, st, pts, 0.006))
        lf = float(bw.template_fit_loss(fitted.avatar, st, pts, 0.006))
    assert lf < 0.1 * lr_, (lf, lr_)
    idx = bw.recon_fit_indices(fitted.grid.valid_pts.shape[0], 4096, gen)
    item, kw = subjects[True][1], subjects[True][2]
    with torch.no_grad():
        losses = [float(bw.recon_fit_loss(
            c.recon, st, bw.recon_fit_features(c.recon, st, c.grid,
                                               kw["inferred_normal"])[idx],
            c.grid.valid_pts[idx], 0.006)) for c in (rand, fitted)]
    assert losses[1] < 0.7 * losses[0], losses
    for w_recon in (False, True):
        r = rand.process_frame(subjects[False][1], w_recon=w_recon,
                               **(subjects[False][2] if w_recon else {}))
        f = fitted.process_frame(item, w_recon=w_recon,
                                 **(kw if w_recon else {}))
        assert bool(r["overflow"]) and not bool(f["overflow"]), w_recon
        assert int(f["cano_mesh"].num_tris) > 1000


def test_jax_frame_on_fitted_weights_matches(subjects):
    """The JAX production frame (f32 path) on the port's fitted weights,
    statics, grid and options gives the port frame's triangle counts and
    overflow bit, and so do the triangle rows of the port's
    capacity_stats."""
    from avatarcap_tpu_torch.tools.capacity_stats import capacity_stats
    capture, item, kw, _ = subjects[True]
    got = capture.process_frame(item, w_recon=True, **kw)
    ref = jax_capture_of(capture).process_frame(item, w_recon=True,
                                                w_nerf=False, **kw)
    stats = capacity_stats(capture, item,
                           inferred_normal=kw["inferred_normal"],
                           camera=kw["camera"])
    for key, row in (("cano_mesh", "avatar_tris"),
                     ("recon_mesh", "recon_tris")):
        n = int(ref[key].num_tris)
        assert int(got[key].num_tris) == n > 1000, key
        assert stats[row]["count"] == n, row
    assert (bool(got["overflow"]) == bool(np.asarray(ref["overflow"]))
            == stats["frame_overflow"])
