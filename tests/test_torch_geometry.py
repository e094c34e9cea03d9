"""Port geometry stages against their JAX counterparts on numpy-seeded
inputs: compaction, marching tets, the skinning volume and volume
skinning, and the canonical mirror-pair raster with interpolation.

Everything runs in float32 on the CPU with the same formulas in the same
order, so meshes and images compare slot for slot and pixel for pixel.
Tolerances are float32 rounding ones; raster pixels inside the -1e-6
barycentric slack of an edge may be enumerated differently, so masks may
differ on a few pixels and values are compared outside that band.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_toy_smpl_params


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("max_out", [50, 300, 4096])
def test_compaction_contract(max_out):
    from avatarcap_tpu.ops.compaction import compact_mask_indices
    from avatarcap_tpu_torch.ops.compaction import compact_mask_indices as tc
    mask = np.random.RandomState(max_out).rand(3000) < 0.07
    ri, rc, rv = compact_mask_indices(jnp.asarray(mask), max_out)
    gi, gc, gv = tc(_t(mask), max_out)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert int(gc) == int(rc) == mask.sum()
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert gi.dtype == torch.int32


@pytest.mark.parametrize("kind,max_out", [
    ("empty", 64), ("full", 3000), ("full", 1000), ("at_capacity", None),
    ("overflow", 100), ("overflow", 1), ("sparse_blocks", 512)])
def test_compaction_edge_masks(kind, max_out):
    """The sync-free compaction (a prefix sum and a scatter, the dropped
    entries parked in a slot that is cut off) against JAX's on seeded
    masks: empty, full, exactly at capacity, and overflowing, where many
    entries share the parking slot and count exceeds max_out."""
    from avatarcap_tpu.ops.compaction import compact_mask_indices
    from avatarcap_tpu_torch.ops.compaction import compact_mask_indices as tc
    rs = np.random.RandomState(len(kind) + (max_out or 0))
    n = 3000
    mask = {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
            "at_capacity": rs.rand(n) < 0.3,
            "overflow": rs.rand(n) < 0.5,
            "sparse_blocks": np.repeat(rs.rand(n // 100) < 0.4, 100)}[kind]
    if max_out is None:
        max_out = int(mask.sum())
    ri, rc, rv = compact_mask_indices(jnp.asarray(mask), max_out)
    gi, gc, gv = tc(_t(mask), max_out)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    assert int(gc) == int(rc) == mask.sum()
    assert gc.shape == () and gc.dtype == torch.int32
    assert gi.dtype == torch.int32 and gi.shape == (max_out,)
    if kind == "overflow":
        assert int(gc) > max_out


def _field(shape, seed):
    """A smooth SDF-like field: a blob plus low-frequency noise."""
    rs = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                             indexing="ij"), -1)
    r = np.linalg.norm(g * [1.0, 1.2, 0.9], axis=-1)
    k = rs.standard_normal((3, 3))
    noise = sum(np.sin(3 * g @ k[i] + i) for i in range(3)) * 0.08
    return (0.6 - r + noise).astype(np.float32)


@pytest.mark.parametrize("caps", [(1 << 13, 1 << 12), (600, 200)],
                         ids=["fits", "overflows"])
def test_marching_tets(caps):
    from avatarcap_tpu.ops.marching_cubes import marching_tets
    from avatarcap_tpu_torch.ops.marching_cubes import marching_tets as tmt
    max_tris, max_active = caps
    vol = _field((22, 19, 17), seed=1)
    bmin = np.array([-0.4, -0.5, -0.3], np.float32)
    voxel = np.array([0.04, 0.05, 0.035], np.float32)
    ref = marching_tets(jnp.asarray(vol), 0.0, jnp.asarray(bmin),
                        jnp.asarray(voxel), max_tris=max_tris,
                        max_active=max_active, gradient_normals=True)
    got = tmt(_t(vol), 0.0, _t(bmin), _t(voxel), max_tris=max_tris,
              max_active=max_active, gradient_normals=True)
    assert int(got.num_tris) == int(ref.num_tris) > 100
    assert bool(got.overflow) == bool(ref.overflow)
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(ref.vertices), atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(ref.normals),
                               atol=1e-5)


@pytest.fixture(scope="module")
def body():
    from avatarcap_tpu.body.smpl import smpl_forward, canonical_pose
    params = make_toy_smpl_params()
    cano = smpl_forward(params, jnp.asarray(canonical_pose()), jnp.zeros(10))
    v = np.asarray(cano.vertices)
    bounds = np.stack([v.min(0) - 0.05, v.max(0) + 0.05]).astype(np.float32)
    rs = np.random.RandomState(5)
    # a posed skeleton: small random rotations + translations per joint
    J = params.num_joints
    mats = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    for j in range(J):
        a = rs.standard_normal(3) * 0.2
        c, s = np.cos(a[0]), np.sin(a[0])
        mats[j, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        mats[j, :3, 3] = rs.standard_normal(3) * 0.05
    return v, np.asarray(params.weights, np.float32), bounds, mats


def test_knn_lbs_and_skin_weight_volume(body):
    from avatarcap_tpu.body.skinning import build_skin_weight_volume
    from avatarcap_tpu.ops.knn import approx_lbs_weights, knn
    from avatarcap_tpu_torch.body import skinning as tsk
    from avatarcap_tpu_torch.ops import knn as tknn
    v, w, bounds, _ = body
    q = np.random.RandomState(2).uniform(bounds[0], bounds[1],
                                         (500, 3)).astype(np.float32)
    d_ref, i_ref = knn(jnp.asarray(q), jnp.asarray(v), k=1)
    d_got, i_got = tknn.knn(_t(q), _t(v), k=1, chunk=128)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-6)
    lbs_ref = approx_lbs_weights(jnp.asarray(q), jnp.asarray(v),
                                 jnp.asarray(w))
    lbs_got = tknn.approx_lbs_weights(_t(q), _t(v), _t(w))
    np.testing.assert_allclose(lbs_got.numpy(), np.asarray(lbs_ref),
                               atol=1e-5)
    vol_ref = build_skin_weight_volume(jnp.asarray(v), jnp.asarray(w),
                                       jnp.asarray(bounds), voxel=0.03)
    vol_got = tsk.build_skin_weight_volume(_t(v), _t(w), _t(bounds),
                                           voxel=0.03)
    assert vol_got.shape == vol_ref.shape
    np.testing.assert_allclose(vol_got.numpy(), np.asarray(vol_ref),
                               atol=1e-5)


@pytest.mark.parametrize("row_group", [1, 3])
def test_skin_points_by_volume(body, row_group):
    from avatarcap_tpu.body.skinning import (build_skin_weight_volume,
                                             mats16_rotate,
                                             skin_points_by_volume)
    from avatarcap_tpu_torch.body import skinning as tsk
    v, w, bounds, mats = body
    wvol = np.asarray(build_skin_weight_volume(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(bounds), voxel=0.03))
    rs = np.random.RandomState(row_group)
    # triangle-like triples: 3 points within ~1 cm of a center
    c = rs.uniform(bounds[0], bounds[1], (400, 1, 3))
    pts = (c + rs.uniform(-0.01, 0.01, (400, 3, 3))).reshape(-1, 3) \
        .astype(np.float32)
    nrm = rs.standard_normal(pts.shape).astype(np.float32)
    ref, ref_m = skin_points_by_volume(
        jnp.asarray(pts), jnp.asarray(wvol), jnp.asarray(bounds),
        jnp.asarray(mats), return_pt_mats=True, row_group=row_group)
    got, got_m = tsk.skin_points_by_volume(
        _t(pts), _t(wvol), _t(bounds), _t(mats), return_pt_mats=True,
        row_group=row_group)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), atol=1e-5)
    np.testing.assert_allclose(
        tsk.mats16_rotate(got_m, _t(nrm)).numpy(),
        np.asarray(mats16_rotate(ref_m, jnp.asarray(nrm))), atol=1e-5)


def _soup(n, seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-0.6, 0.6, (n, 1, 3)).astype(np.float32)
    tris = c + rs.uniform(-0.015, 0.015, (n, 3, 3)).astype(np.float32)
    tris[:3] = c[:3] + rs.uniform(-0.4, 0.4, (3, 3, 3))   # big-pass tris
    valid = rs.rand(n) > 0.1
    return tris.astype(np.float32), valid


@pytest.mark.parametrize("cc", [0, 1 << 12], ids=["dense", "covered"])
def test_cano_index_pair_and_interpolate(cc):
    from avatarcap_tpu.render.camera import cano_front_back_mvp
    from avatarcap_tpu.render.raster import interpolate
    from avatarcap_tpu.render.visualize import cano_index_passes
    from avatarcap_tpu_torch.render import camera as tcam
    from avatarcap_tpu_torch.render.raster import interpolate as tinterp
    from avatarcap_tpu_torch.render.visualize import (
        cano_index_passes as tpasses)
    tris, valid = _soup(3000, seed=4)
    center = np.array([0.05, -0.1, 0.02], np.float32)
    fmvp, _, bmvp, _ = cano_front_back_mvp(center)
    tf, _, tb, _ = tcam.cano_front_back_mvp(center)
    np.testing.assert_array_equal(tf, fmvp)
    np.testing.assert_array_equal(tb, bmvp)
    attr = np.random.RandomState(1).randn(*tris.shape).astype(np.float32)
    res, kw = 128, dict(window=3, big_tris=16, max_candidates=cc)
    rf, rb = cano_index_passes(jnp.asarray(tris), jnp.asarray(valid),
                               jnp.asarray(fmvp), jnp.asarray(bmvp), res=res,
                               **kw)
    gf, gb = tpasses(_t(tris), _t(valid), _t(fmvp), _t(bmvp), res=res, **kw)
    for r, g in ((rf, gf), (rb, gb)):
        rm, gm = np.asarray(r.mask), g.mask.numpy()
        assert rm.sum() > 500
        # eps-slack pixels only
        assert (rm != gm).sum() <= max(3, int(1e-3 * rm.sum()))
        both = rm & gm
        np.testing.assert_allclose(g.depth.numpy()[both],
                                   np.asarray(r.depth)[both], atol=1e-6)
        assert (g.tri.numpy()[both.reshape(-1)]
                == np.asarray(r.tri)[both.reshape(-1)]).mean() > 0.999
        assert bool(g.overflow) == bool(r.overflow)
        ri, rovf = interpolate(r, jnp.asarray(attr), covered_capacity=cc,
                               with_overflow=True)
        gi, govf = tinterp(g, _t(attr), covered_capacity=cc)
        assert bool(govf) == bool(rovf)
        err = np.abs(gi.numpy() - np.asarray(ri))[both]
        assert np.quantile(err, 0.999) < 1e-5
        assert int(g.n_big) == int(r.n_big) > 0
        assert int(g.n_candidates) == int(r.n_candidates)
