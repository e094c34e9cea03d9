"""The avatar's other forms against the JAX package: the occupancy head
(``if_type="occupancy"``, a sigmoid on the geometry head) and positional
encodings other than the capture's (10, 0), through the module, K1's
per-point query ``query_occupancy_fused`` and the capture's geometry
stage.

One JAX GeoTexAvatar init per encoding, its BatchNorm statistics, offset
head and geometry head redrawn with numpy (so the warp moves the points
and the field crosses its level), carried to the port by
weights.avatar_state_dict_from_jax; the occupancy form has the same
parameters as the SDF one. Module outputs are float32 on both sides
(conftest pins JAX matmuls to "highest"): 1e-5, the template's PE(10)
amplifying the warped points' rounding to 1e-4 on the geometry output, as
tests/test_torch_modules.py holds it. K1 (the port's plain version on the
CPU, the Pallas kernel in interpret mode) at tests/test_torch_fused_query.py's
bf16 tolerances, and against the f32 path at the 2e-2 of
tests/test_pallas_query.py.

Reference behaviour the port does not copy: JAX's fused path returns K1's
raw geometry output whatever the if_type (pallas_query.py's kernel, its
wrapper and pipeline/avatar.py:query_occupancy_fused), while the flax
module applies the sigmoid. The port applies the sigmoid after K1, so its
fused query matches the module path, as JAX's docstring promises;
test_query_occupancy_fused_occupancy shows the difference.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from avatarcap_tpu_torch import kernels
from conftest import make_toy_smpl_params

# K1's plain version against the interpret-mode Pallas kernel
# (tests/test_torch_fused_query.py), and the kernel against the f32 path
# (tests/test_pallas_query.py)
K1_ATOL = {"cano_pts_ov": 5e-3, "nonrigid_offset": 5e-4}
KERNEL_VS_F32 = 2e-2
ENCODINGS = {"10_0": (10, 0), "8_2": (8, 2)}
VOL_RES = (32, 32, 24)
# the geometry stage's capacities; knn skinning (no skinning volume to
# build: no test here skins)
OPTS = dict(max_tris=1 << 14, max_active=1 << 12, refine_capacity=1 << 15,
            skinning_mode="knn")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Fewer torch threads beside XLA's in one process (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def body():
    """The toy body's statics and a 32 x 32 x 24 capture grid over it
    (tests/capture_cases.py's construction, smaller, made with the
    port's body, KNN and inside test: inputs both sides are given)."""
    from avatarcap_tpu_torch.body.smpl import canonical_pose, smpl_forward
    from avatarcap_tpu_torch.ops.inside import points_inside_mesh
    from avatarcap_tpu_torch.ops.knn import knn
    params = make_toy_smpl_params()
    v = smpl_forward(params, torch.as_tensor(canonical_pose()),
                     torch.zeros(10)).vertices.numpy()
    lo = v.min(0) - np.array([0.05, 0.05, 0.15], np.float32)
    hi = v.max(0) + np.array([0.05, 0.05, 0.15], np.float32)
    wv = np.zeros((16, 16, 16, params.num_joints), np.float32)
    wv[..., 0] = 1.0
    statics = dict(weight_volume=wv, cano_smpl_vertices=v,
                   smpl_skinning_weights=np.asarray(params.weights),
                   cano_bounds=np.stack([lo, hi]),
                   cano_smpl_center=(0.5 * (lo + hi)).astype(np.float32))
    lin = [np.linspace(0, 1, r, dtype=np.float32) for r in VOL_RES]
    g = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    pts = g * (hi - lo) + lo
    d2, _ = knn(_t(pts), _t(v), k=1)
    near = (d2[:, 0] < 0.1 ** 2).numpy()
    inside = points_inside_mesh(_t(pts), _t(v[params.faces])).numpy()
    # outside the band: -1 / +1, on the right side of 0 and of 0.5
    prior = np.where(near, 0.0, 2.0 * inside.astype(np.float32) - 1.0
                     ).astype(np.float32)
    idx = np.where(near)[0].astype(np.int32)
    pad = (-len(idx)) % 1024
    grid = dict(valid_pts=np.concatenate([pts[idx],
                                          np.zeros((pad, 3), np.float32)]),
                valid_idx=np.pad(idx, (0, pad), constant_values=len(pts)),
                prior_volume=prior)
    rs = np.random.RandomState(21)
    pos_map = (rs.standard_normal((1, 128, 128, 6)) * 0.1).astype(np.float32)
    return statics, grid, pos_map


def _variables(encoding):
    """JAX GeoTexAvatar variables of ``encoding`` (numpy), with numpy-drawn
    BatchNorm statistics, ~1 cm offsets and an O(0.1) geometry head."""
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    pe_t, pe_w = encoding
    module = GeoTexAvatar(pos_encoding_template=pe_t, pos_encoding_warp=pe_w)
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(pe_t + pe_w),
                             jnp.zeros((1, 8, 3)),
                             jnp.zeros((1, 128, 128, 6)), jnp.zeros((1, 3))))
    rs = np.random.RandomState(pe_t * 10 + pe_w)
    for bn in variables["batch_stats"]["warping_field"]["mlp"].values():
        bn["mean"] = rs.uniform(-0.2, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rs.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    variables["params"]["warping_field"]["out_layer_coord_affine"][
        "kernel"] = rs.uniform(-0.001, 0.001, (256, 3)).astype(np.float32)
    variables["params"]["cano_template"]["geo_mlp"]["fc1_kernel"] = \
        rs.uniform(-0.1, 0.1, (128, 2)).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def weights():
    return {k: _variables(e) for k, e in ENCODINGS.items()}


def _modules(variables, encoding, if_type):
    """(JAX module, port module in eval mode) of one form."""
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar as TGeoTex
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    pe_t, pe_w = encoding
    module = GeoTexAvatar(if_type=if_type, pos_encoding_template=pe_t,
                          pos_encoding_warp=pe_w)
    port = TGeoTex(if_type=if_type, pos_encoding_template=pe_t,
                   pos_encoding_warp=pe_w)
    port.load_state_dict(avatar_state_dict_from_jax(variables))
    return module, port.eval()


def _pose_features(module, variables, pos_map):
    """JAX's pose features, jitted (eager, the U-Net's first call takes
    seconds)."""
    from avatarcap_tpu.pipeline.avatar import compute_pose_features
    return jax.jit(lambda v, x: compute_pose_features(module, v, x)[0])(
        variables, jnp.asarray(pos_map))


def _statics(statics):
    from avatarcap_tpu.pipeline.avatar import AvatarStatics as JS
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics as TS
    return (JS(**{k: jnp.asarray(a) for k, a in statics.items()}),
            TS(**{k: _t(a) for k, a in statics.items()}))


@pytest.mark.parametrize("if_type", ["sdf", "occupancy"])
@pytest.mark.parametrize("enc", ["10_0", "8_2"])
def test_avatar_forms_match_jax(body, weights, enc, if_type):
    """GeoTexAvatar's pose features and warp + template query (the JAX
    module's combined __call__) in each form; the OffsetDecoder's input
    is embed_dim(warp PE) + 64 wide."""
    from avatarcap_tpu_torch.ops.embed import embed_dim
    from avatarcap_tpu_torch.pipeline.avatar import (
        compute_pose_features as tfeat)
    statics, _, pos_map = body
    encoding = ENCODINGS[enc]
    module, port = _modules(weights[enc], encoding, if_type)
    assert port.warping_field.mlp.conv1.weight.shape[1] == \
        embed_dim(encoding[1]) + 64
    assert port.encodings == encoding and port.if_type == if_type
    c = statics["cano_smpl_center"]
    pts = (c + np.random.RandomState(5).uniform(-0.4, 0.4, (1, 600, 3))
           ).astype(np.float32)
    ref = jax.jit(module.apply)(weights[enc], jnp.asarray(pts),
                                jnp.asarray(pos_map), jnp.asarray(c)[None])
    feat = _pose_features(module, weights[enc], pos_map)
    with torch.no_grad():
        np.testing.assert_allclose(tfeat(port, _t(pos_map)).numpy(),
                                   np.asarray(feat), atol=1e-4, rtol=1e-4)
        center = _t(c)[None]
        off = port.query_offsets(_t(pts), _t(feat), center)
        rgb, alpha, occ = port.query_template(_t(pts) + off)
    assert np.abs(np.asarray(ref["nonrigid_offset"])).max() > 1e-3
    for name, got, atol in (("nonrigid_offset", off, 1e-5),
                            ("rgb", rgb, 1e-5), ("alpha", alpha, 1e-4),
                            ("occ", occ, 1e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[name]),
                                   atol=atol, rtol=1e-5, err_msg=name)
    o = occ.numpy()
    if if_type == "occupancy":
        assert o.min() > 0.0 and o.max() < 1.0
        assert o.min() < 0.5 < o.max()
    else:
        assert o.min() < 0.0 < o.max()


def _fused_inputs(body, weights, if_type):
    """The JAX and the port (10, 0) modules of ``if_type``, their pose
    features and packed K1 weights, 512 query points and the statics."""
    from avatarcap_tpu.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.pipeline.avatar import (
        pack_fused_query_weights as tpack)
    statics, _, pos_map = body
    module, port = _modules(weights["10_0"], (10, 0), if_type)
    jst, tst = _statics(statics)
    feat = _pose_features(module, weights["10_0"], pos_map)
    pts = (statics["cano_smpl_center"] + np.random.RandomState(7).uniform(
        -0.3, 0.3, (1, 512, 3))).astype(np.float32)
    with torch.no_grad():
        tp = tpack(port)
    assert tp["if_type"] == if_type
    return (module, port, feat, pack_fused_query_weights(weights["10_0"]),
            tp, pts, jst, tst)


def test_query_occupancy_fused_sdf(body, weights):
    """The port's query_occupancy_fused (the plain K1 on the CPU) against
    JAX's, its Pallas call in interpret mode, and against the f32 path."""
    from avatarcap_tpu.pipeline.avatar import query_occupancy_fused
    from avatarcap_tpu_torch.pipeline.avatar import (
        query_occupancy as tquery, query_occupancy_fused as tfused)
    module, port, feat, jp, tp, pts, jst, tst = _fused_inputs(
        body, weights, "sdf")
    with pltpu.force_tpu_interpret_mode():
        ref = query_occupancy_fused(jp, jnp.asarray(pts), feat, jst)
    before = kernels.launches["k1"]
    with torch.no_grad():
        got = tfused(tp, _t(pts), _t(feat), tst)
        f32 = tquery(port, _t(pts), _t(feat), tst)
    assert kernels.launches["k1"] == before       # the plain version
    for k, atol in K1_ATOL.items():
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), f32[k].numpy(),
                                   atol=KERNEL_VS_F32, err_msg=k)


def test_query_occupancy_fused_occupancy(body, weights):
    """An occupancy avatar through the port's query_occupancy_fused: the
    sigmoid of JAX's interpret-mode fused output, and JAX's XLA
    query_occupancy at the kernel's 2e-2. JAX's own fused output is the
    raw head (the quirk the port does not copy): it misses the XLA path
    by the sigmoid."""
    from avatarcap_tpu.pipeline.avatar import (query_occupancy,
                                               query_occupancy_fused)
    from avatarcap_tpu_torch.pipeline.avatar import (
        query_occupancy_fused as tfused)
    module, port, feat, jp, tp, pts, jst, tst = _fused_inputs(
        body, weights, "occupancy")
    with pltpu.force_tpu_interpret_mode():
        raw = query_occupancy_fused(jp, jnp.asarray(pts), feat, jst)
    xla, _ = jax.jit(lambda v, p, f: query_occupancy(module, v, p, f, jst))(
        weights["10_0"], jnp.asarray(pts), feat)
    with torch.no_grad():
        got = tfused(tp, _t(pts), _t(feat), tst)
    occ = got["cano_pts_ov"].numpy()
    np.testing.assert_allclose(
        occ, np.asarray(jax.nn.sigmoid(raw["cano_pts_ov"])),
        atol=K1_ATOL["cano_pts_ov"])
    np.testing.assert_allclose(occ, np.asarray(xla["cano_pts_ov"]),
                               atol=KERNEL_VS_F32)
    np.testing.assert_allclose(got["nonrigid_offset"].numpy(),
                               np.asarray(xla["nonrigid_offset"]),
                               atol=KERNEL_VS_F32)
    assert occ.min() < 0.5 < occ.max()
    quirk = np.abs(np.asarray(raw["cano_pts_ov"])
                   - np.asarray(xla["cano_pts_ov"])).max()
    assert quirk > 0.3, quirk


def _captures(body, weights, enc, if_type, fused, **extra):
    """The JAX capture (f32 XLA path off the TPU) and the port's on the
    CPU, iso at the form's level."""
    from avatarcap_tpu.pipeline.capture import (AvatarCapture, CaptureGrid,
                                                CaptureOptions)
    from avatarcap_tpu_torch.pipeline import capture as tcap
    statics, grid, _ = body
    module, port = _modules(weights[enc], ENCODINGS[enc], if_type)
    jst, tst = _statics(statics)
    iso = 0.5 if if_type == "occupancy" else 0.0
    jgrid = CaptureGrid(*(jnp.asarray(grid[k]) for k in
                          ("valid_pts", "valid_idx", "prior_volume")),
                        VOL_RES)
    jcap = AvatarCapture(module, weights[enc], jst, jgrid,
                         options=CaptureOptions(use_fused_query=False,
                                                iso_value=iso, **OPTS,
                                                **extra))
    tgrid = tcap.CaptureGrid(*(_t(grid[k]) for k in
                               ("valid_pts", "valid_idx", "prior_volume")),
                             VOL_RES)
    cap = tcap.AvatarCapture(
        port, tst, tgrid, options=tcap.CaptureOptions(
            use_fused_query=fused, iso_value=iso, **OPTS, **extra),
        device="cpu")
    return jcap, cap


def _frames(pos_map):
    from avatarcap_tpu.pipeline.avatar import FrameInputs as JF
    from avatarcap_tpu_torch.pipeline.avatar import FrameInputs as TF
    eye = np.tile(np.eye(4, dtype=np.float32), (1, 24, 1, 1))
    return (JF(jnp.zeros((1, 1, 3)), jnp.asarray(eye), jnp.asarray(pos_map)),
            TF(torch.zeros((1, 1, 3)), _t(eye), _t(pos_map)))


@pytest.mark.parametrize("enc", ["10_0", "8_2"])
def test_occupancy_volume_and_mesh_f32_path(body, weights, enc):
    """The occupancy avatar's canonical volume (coarse to fine at iso
    0.5) and mesh through the port's f32 module path against the JAX
    capture's XLA path (its geometry stage, and its hierarchical volume
    on the JAX package's own query_occupancy), in both encodings: equal
    triangle counts and overflow, and the slots within the bf16 corner
    interpolation's bounds (tests/test_torch_capture.py)."""
    from avatarcap_tpu.pipeline.avatar import query_occupancy
    from avatarcap_tpu.pipeline.capture import hierarchical_volume
    jcap, cap = _captures(body, weights, enc, "occupancy", fused=False)
    jframe, tframe = _frames(body[2])
    ref_mesh, jfeat = jcap._avatar_geometry(jcap.state, jcap.avatar_vars,
                                            jframe)
    with torch.inference_mode():
        mesh, feat = cap.avatar_geometry_stage(tframe)
        vol, ovf = cap.avatar_volume(feat)
    g, o = jcap.grid, jcap.opt

    @jax.jit
    def jax_volume(variables, feat):
        def vf(pts, fidx):
            out, _ = query_occupancy(jcap.avatar, variables, pts[None], feat,
                                     jcap.statics)
            return out["cano_pts_ov"][0, :, 0]
        return hierarchical_volume(
            vf, g, jcap.statics.cano_bounds, g.c_prior, g.prior_volume,
            o.iso_value, o.hier_alpha, o.refine_capacity)
    ref_vol, ref_ovf = jax_volume(jcap.avatar_vars, jfeat)
    rv = np.asarray(ref_vol)
    assert rv.min() < 0.5 < rv.max()
    np.testing.assert_allclose(vol.numpy(), rv, atol=1e-4)
    assert bool(ovf) == bool(ref_ovf)
    n = int(ref_mesh.num_tris)
    assert int(mesh.num_tris) == n > 100
    assert bool(mesh.overflow) == bool(ref_mesh.overflow)
    a, b = mesh.vertices.numpy()[:3 * n], np.asarray(ref_mesh.vertices)[:3 * n]
    np.testing.assert_allclose(a, b, atol=2e-4)
    assert (np.abs(a - b).max(-1) <= 1e-5).mean() >= 0.99


def test_occupancy_kernel_path_matches_f32_path(body, weights):
    """The port's kernel path for an occupancy avatar (the plain K1 on the
    CPU, the sigmoid after it) against its f32 module path, at
    tests/test_torch_capture.py's kernel-frame tolerances: triangle
    counts within 0.5% and 95% of the vertices within 2e-3, and the
    volumes 99.9% within its 5e-3. There two bf16 kernels are compared;
    here the kernel and the f32 path, so a flipped bf16 rounding can
    reach the 2e-2 at which tests/test_pallas_query.py holds the kernel
    against the f32 path (measured: 3 of 24,576 nodes above 5e-3, at
    most 1.2e-2), and one cube's changed triangle count shifts every
    later soup slot, so the vertices are matched by their volume-edge
    keys, not by slot."""
    kw = dict(nerf_unique_capacity=1 << 12)        # the meshes' edge keys
    _, f32 = _captures(body, weights, "10_0", "occupancy", False, **kw)
    _, fused = _captures(body, weights, "10_0", "occupancy", True, **kw)
    assert fused.packed_query["if_type"] == "occupancy"
    _, tframe = _frames(body[2])
    with torch.inference_mode():
        ref, feat = f32.avatar_geometry_stage(tframe, want_edge_ids=True)
        got, _ = fused.avatar_geometry_stage(tframe, want_edge_ids=True)
        ref_vol, _ = f32.avatar_volume(feat)
        vol, _ = fused.avatar_volume(feat)
    d = np.abs(vol.numpy() - ref_vol.numpy())
    assert d.max() <= KERNEL_VS_F32 and (d <= 5e-3).mean() >= 0.999
    n = int(ref.num_tris)
    assert n > 100 and abs(int(got.num_tris) - n) <= max(2, n // 200)
    assert bool(got.overflow) == bool(ref.overflow)

    def by_edge(mesh):
        ids = mesh.edge_ids.numpy()
        keep = ids >= 0
        uid, first = np.unique(ids[keep], return_index=True)
        return uid, mesh.vertices.numpy()[keep][first]
    ug, vg = by_edge(got)
    ur, vr = by_edge(ref)
    _, ig, ir = np.intersect1d(ug, ur, return_indices=True)
    # chip_smoke.py's bound on the edge keys two textured frames share
    # (measured here: 98.9%)
    assert len(ig) >= 0.95 * len(ur)
    close = np.all(np.abs(vg[ig] - vr[ir]) < 2e-3, axis=-1)
    assert close.mean() > 0.95


def test_other_encodings_refuse_the_kernel_path(body, weights):
    """K1 takes the (10, 0) encodings only: packing an (8, 2) avatar, and
    a capture of one (or of a texture avatar of one) with
    use_fused_query=True, raise and name the f32 path; the f32 capture
    runs."""
    from avatarcap_tpu_torch.pipeline import capture as tcap
    from avatarcap_tpu_torch.pipeline.avatar import pack_fused_query_weights
    _, odd = _modules(weights["8_2"], (8, 2), "sdf")
    with pytest.raises(ValueError, match="use_fused_query=False"):
        pack_fused_query_weights(odd)
    with pytest.raises(ValueError, match="use_fused_query=False"):
        _captures(body, weights, "8_2", "sdf", fused=True)
    _, cap = _captures(body, weights, "10_0", "sdf", fused=False)
    with pytest.raises(ValueError, match="use_fused_query=False"):
        tcap.AvatarCapture(cap.avatar, cap.statics, cap.grid, tex_avatar=odd,
                           options=dataclasses.replace(cap.opt,
                                                       use_fused_query=True),
                           device="cpu")
    _, f32 = _captures(body, weights, "8_2", "sdf", fused=False)
    assert f32.packed_query is None
