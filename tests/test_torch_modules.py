"""Port modules against their JAX counterparts, on the same numpy-seeded
inputs and the same weights (JAX init -> numpy -> the weight bridge).

Both sides run in float32 on the CPU (conftest pins JAX matmuls to
"highest"), so tolerances are float32 rounding-order ones: ~1e-5 for the
point networks, 1e-4 for the 14-conv U-Net and the 5- and 6-downsample
ones.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_toy_smpl_params


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def env():
    from avatarcap_tpu.body.smpl import smpl_forward, canonical_pose
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar as TGeoTex
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics as TStatics
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax

    params = make_toy_smpl_params()
    cano = smpl_forward(params, jnp.asarray(canonical_pose()), jnp.zeros(10))
    v = np.asarray(cano.vertices)
    lo, hi = v.min(0) - 0.1, v.max(0) + 0.1
    statics = AvatarStatics(
        weight_volume=jnp.zeros((4, 4, 4, 24)),
        cano_smpl_vertices=cano.vertices,
        smpl_skinning_weights=jnp.asarray(params.weights),
        cano_bounds=jnp.asarray(np.stack([lo, hi])),
        cano_smpl_center=jnp.asarray(0.5 * (lo + hi)))
    module = GeoTexAvatar(if_type="sdf")
    variables = _np_tree(jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
        jnp.zeros((1, 128, 128, 6)), statics.cano_smpl_center[None]))
    # non-trivial BN statistics and output heads, drawn with numpy
    rs = np.random.RandomState(3)

    def perturb(tree):
        for k, val in tree.items():
            if isinstance(val, dict):
                perturb(val)
            elif k == "mean":
                tree[k] = rs.uniform(-0.2, 0.2, val.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rs.uniform(0.5, 1.5, val.shape).astype(np.float32)
    perturb(variables["batch_stats"])
    wf = variables["params"]["warping_field"]
    wf["out_layer_coord_affine"]["kernel"] = rs.uniform(
        -0.05, 0.05, (256, 3)).astype(np.float32)
    geo = variables["params"]["cano_template"]["geo_mlp"]
    geo["fc1_kernel"] = rs.uniform(-0.1, 0.1, (128, 2)).astype(np.float32)

    port = TGeoTex()
    port.load_state_dict(avatar_state_dict_from_jax(variables))
    port.eval()
    tstatics = TStatics(*(torch.as_tensor(np.array(t)) for t in statics))
    pos_map = rs.standard_normal((1, 128, 128, 6)).astype(np.float32)
    return module, variables, statics, port, tstatics, pos_map, rs


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_weight_bridge_roundtrip(env):
    """JAX variables -> port state_dict -> the JAX converter gives back the
    original tree, leaf for leaf."""
    from avatarcap_tpu.tools.convert_torch_ckpt import convert_geotex_avatar
    _, variables, _, port, _, _, _ = env
    back = convert_geotex_avatar(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))


def test_reference_checkpoint_loads_with_dead_upconv4(env):
    """A reference state_dict carries the dead U-Net upconv4; the port's
    loader drops exactly that prefix and loads the rest strictly."""
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.weights import load_reference_state_dict
    _, _, _, port, _, _, _ = env
    sd = dict(port.state_dict())
    sd["warping_field.unet.upconv4.up.weight"] = torch.zeros(512, 128, 4, 4)
    fresh = GeoTexAvatar()
    load_reference_state_dict(fresh, sd)
    for k, val in fresh.state_dict().items():
        assert torch.equal(val, port.state_dict()[k]), k


def test_positional_encoding(env):
    from avatarcap_tpu.ops.embed import positional_encoding
    from avatarcap_tpu_torch.ops.embed import positional_encoding as tpe
    rs = env[-1]
    x = rs.uniform(-1.5, 1.5, (257, 3)).astype(np.float32)
    ref = np.asarray(positional_encoding(jnp.asarray(x), 10))
    got = tpe(_t(x), 10).numpy()
    assert got.shape == (257, 63)
    # sin/cos of arguments up to 2^9 * 1.5 rad: one f32 ulp of the
    # argument is ~1e-4 of the phase, so compare at 1e-4
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got[:, :3], x)


def test_grid_sample(env):
    from avatarcap_tpu.ops.grid_sample import (grid_sample_3d,
                                               sample_feature_map_at_points)
    from avatarcap_tpu_torch.ops import grid_sample as tgs
    rs = env[-1]
    fmap = rs.standard_normal((1, 5, 16, 12)).astype(np.float32)
    pts = rs.uniform(-1.3, 1.3, (1, 200, 3)).astype(np.float32)   # border
    ref = np.asarray(sample_feature_map_at_points(jnp.asarray(fmap),
                                                  jnp.asarray(pts)))
    got = tgs.sample_feature_map_at_points(_t(fmap), _t(pts)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    vol = rs.standard_normal((1, 4, 6, 7, 8)).astype(np.float32)
    grid = rs.uniform(-1.2, 1.2, (1, 3, 5, 2, 3)).astype(np.float32)
    ref3 = np.asarray(grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid)))
    got3 = tgs.grid_sample_3d(_t(vol), _t(grid)).numpy()
    np.testing.assert_allclose(got3, ref3, atol=1e-5)


def test_mlp_and_offset_decoder(env):
    from avatarcap_tpu.models.mlp import MLP, OffsetDecoder
    _, variables, _, port, _, _, rs = env
    tpl = variables["params"]["cano_template"]
    x = rs.standard_normal((2, 300, 63)).astype(np.float32)
    jmlp = MLP(out_channels=256, inter_channels=(256,) * 6, res_layers=(4,),
               nlactv="relu")
    ref = np.asarray(jmlp.apply({"params": tpl["shared_mlp"]},
                                jnp.asarray(x)))
    with torch.no_grad():
        got = port.cano_template.shared_mlp(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    wf = variables["params"]["warping_field"]
    wfs = variables["batch_stats"]["warping_field"]
    xo = rs.standard_normal((2, 300, 67)).astype(np.float32)
    ref_o = np.asarray(OffsetDecoder().apply(
        {"params": wf["mlp"], "batch_stats": wfs["mlp"]}, jnp.asarray(xo),
        False))
    with torch.no_grad():
        got_o = port.warping_field.mlp(_t(xo)).numpy()
    np.testing.assert_allclose(got_o, ref_o, atol=1e-5, rtol=1e-5)


def test_unet_and_pose_features(env):
    from avatarcap_tpu.models.unets import UnetNoCond7DS
    from avatarcap_tpu.pipeline.avatar import compute_pose_features
    from avatarcap_tpu_torch.pipeline.avatar import (
        compute_pose_features as t_compute)
    module, variables, _, port, _, pos_map, _ = env
    wf = variables["params"]["warping_field"]
    wfs = variables["batch_stats"]["warping_field"]
    ref_u = np.asarray(UnetNoCond7DS(output_nc=64, nf=32).apply(
        {"params": wf["unet"], "batch_stats": wfs["unet"]},
        jnp.asarray(pos_map), False))
    with torch.no_grad():
        got_u = port.warping_field.unet(
            _t(pos_map).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_u, ref_u, atol=1e-4, rtol=1e-4)

    ref, _ = compute_pose_features(module, variables, jnp.asarray(pos_map))
    with torch.no_grad():
        got = t_compute(port, _t(pos_map)).numpy()
    assert got.shape == (1, 128, 128, 64)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind,up_mode", [("5ds", "upconv"),
                                           ("5ds", "upsample"),
                                           ("6ds", "upconv")])
def test_unets_5ds_6ds(kind, up_mode):
    """UnetNoCond5DS / 6DS at nf=8 on a 64^2 map against JAX's (eval mode,
    numpy-drawn BatchNorm statistics), the weights through
    unet_state_dict_from_jax, the reference's key names."""
    from avatarcap_tpu.models import unets
    from avatarcap_tpu_torch.models import unets as tunets
    from avatarcap_tpu_torch.weights import unet_state_dict_from_jax
    name = {"5ds": "UnetNoCond5DS", "6ds": "UnetNoCond6DS"}[kind]
    rs = np.random.RandomState(len(kind + up_mode))
    x = rs.standard_normal((2, 64, 64, 3)).astype(np.float32)
    module = getattr(unets, name)(output_nc=5, nf=8, up_mode=up_mode)
    variables = _np_tree(jax.jit(module.init)(jax.random.PRNGKey(4),
                                              jnp.asarray(x)))
    for block in variables["batch_stats"].values():
        bn = block["bn"]
        bn["mean"] = rs.uniform(-0.2, 0.2, bn["mean"].shape).astype(
            np.float32)
        bn["var"] = rs.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    port = getattr(tunets, name)(3, 5, nf=8, up_mode=up_mode)
    sd = unet_state_dict_from_jax(variables)
    port.load_state_dict(sd)
    port.eval()
    last = "upconv5" if kind == "5ds" else "upconvC6"
    assert (f"{last}.up.weight" if kind == "5ds" and up_mode == "upconv"
            else f"{last}.up.1.weight") in sd
    ref = np.asarray(module.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 5)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_query_occupancy(env):
    from avatarcap_tpu.pipeline.avatar import (compute_pose_features,
                                               query_occupancy)
    from avatarcap_tpu_torch.pipeline import avatar as tav
    module, variables, statics, port, tstatics, pos_map, rs = env
    feat, _ = compute_pose_features(module, variables, jnp.asarray(pos_map))
    c = np.asarray(statics.cano_smpl_center)
    pts = (c + rs.uniform(-0.3, 0.3, (1, 700, 3))).astype(np.float32)
    ref, _ = query_occupancy(module, variables, jnp.asarray(pts), feat,
                             statics)
    with torch.no_grad():
        got = tav.query_occupancy(port, _t(pts), _t(feat), tstatics)
    # the offsets are O(1e-2) here, so the template sees warped points
    assert np.abs(np.asarray(ref["nonrigid_offset"])).max() > 1e-3
    np.testing.assert_allclose(got["nonrigid_offset"].numpy(),
                               np.asarray(ref["nonrigid_offset"]),
                               atol=1e-5)
    # the template's PE(10) multiplies the warped points by up to 2^9, so
    # a float32-rounding difference in the offsets reaches the SDF ~500x
    # amplified: compare it at the PE test's 1e-4
    np.testing.assert_allclose(got["cano_pts_ov"].numpy(),
                               np.asarray(ref["cano_pts_ov"]), atol=1e-4)


@pytest.mark.parametrize("mode", ["full", "flat_idx", "columns_bf16"])
def test_grid_pose_features(env, mode):
    from avatarcap_tpu.pipeline.avatar import grid_pose_features
    from avatarcap_tpu_torch.pipeline import avatar as tav
    _, _, statics, _, tstatics, _, rs = env
    feat = rs.standard_normal((1, 64, 64, 16)).astype(np.float32)
    gs = (6, 5, 4)
    if mode == "full":
        ref = grid_pose_features(jnp.asarray(feat), statics, gs)
        got = tav.grid_pose_features(_t(feat), tstatics, gs)
    elif mode == "flat_idx":
        idx = np.array([0, 7, 23, 119, 120], np.int32)   # 120 = pad slot
        ref = grid_pose_features(jnp.asarray(feat), statics, gs,
                                 jnp.asarray(idx))
        got = tav.grid_pose_features(_t(feat), tstatics, gs, _t(idx))
    else:
        ref = grid_pose_features(jnp.asarray(feat), statics, gs,
                                 dtype=jnp.bfloat16, columns=True)
        got = tav.grid_pose_features(_t(feat), tstatics, gs,
                                     dtype=torch.bfloat16, columns=True)
        assert got.dtype == torch.bfloat16 and got.shape == (30, 16)
    # bf16 columns: the f32 values agree to ~1e-6, so the rounded values
    # agree to one bf16 ulp at most
    atol = 2e-2 if mode == "columns_bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32), atol=atol)


def test_f32_convolutions_flags():
    """Inside the port's convolution context cuDNN runs in full float32
    with deterministic algorithms (a non-deterministic transposed
    convolution made the card's pose features drift from run to run); the
    caller's other flags pass through and every flag is restored after."""
    from avatarcap_tpu_torch.models.layers import f32_convolutions
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32)
    with cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                     allow_tf32=True):
        with f32_convolutions():
            assert cudnn.deterministic and not cudnn.allow_tf32
            assert cudnn.enabled and cudnn.benchmark
        assert not cudnn.deterministic and cudnn.allow_tf32
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32) == before
