"""Normal fusion of the port against the JAX package: morphology, the
inverse skinning rotation, the single perspective rasterizer pass, the
lift of image normals and its standalone canonical render, and the
two-phase merge.

Inputs are drawn with numpy and given to both sides. Everything runs in
float32 on the CPU (conftest pins JAX matmuls to "highest"). Morphology is
exact. The rasterizer and the lift are compared outside the eps-slack
boundary band, where a 1e-7 difference in a barycentric can move a pixel
or a vertex across a triangle edge or the 5 cm visibility threshold.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import merge_cases
from conftest import make_toy_smpl_params


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("iterations", [1, 3])
def test_erode_matches_jax_with_border(iterations):
    from avatarcap_tpu.ops.morphology import erode_3x3
    from avatarcap_tpu_torch.ops.morphology import erode_3x3 as terode
    rs = np.random.RandomState(iterations)
    mask = rs.uniform(size=(37, 41)) > 0.15
    mask[0, :] = True                      # a set border row: cv2 keeps it
    ref = np.asarray(erode_3x3(jnp.asarray(mask), iterations=iterations))
    got = terode(_t(mask), iterations=iterations).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0].any() and not got.all()


@pytest.mark.parametrize("density", [0.7, 1.0])
def test_distance_transform_matches_jax(density):
    """Exact, the all-set mask (no zero pixel: every distance is `big`)
    included."""
    from avatarcap_tpu.ops.morphology import distance_transform_l1
    from avatarcap_tpu_torch.ops.morphology import (
        distance_transform_l1 as tdt)
    rs = np.random.RandomState(3)
    mask = (rs.uniform(size=(64, 48)) < density).astype(np.float32)
    ref = np.asarray(distance_transform_l1(jnp.asarray(mask)))
    got = tdt(_t(mask)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_mats16_inv_rotate():
    from avatarcap_tpu.body.skinning import mats16_inv_rotate
    from avatarcap_tpu_torch.body.skinning import mats16_inv_rotate as tinv
    rs = np.random.RandomState(4)
    m = np.tile(np.eye(4, dtype=np.float32).reshape(16), (500, 1))
    m += rs.uniform(-0.4, 0.4, m.shape).astype(np.float32)   # blended LBS
    m[0, :] = 0.0                                  # det 0: clamped, finite
    vec = rs.standard_normal((500, 3)).astype(np.float32)
    ref = np.asarray(mats16_inv_rotate(jnp.asarray(m), jnp.asarray(vec)))
    got = tinv(_t(m), _t(vec)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # it inverts the 3x3 part
    back = np.einsum("nij,nj->ni", m[1:].reshape(-1, 4, 4)[:, :3, :3],
                     got[1:])
    np.testing.assert_allclose(back, vec[1:], atol=1e-3)
    assert np.all(np.isfinite(got))


def test_perspective_projection_matches_jax():
    from avatarcap_tpu.render.camera import gl_perspective_projection_matrix
    from avatarcap_tpu_torch.render.camera import (
        gl_perspective_projection_matrix as tproj)
    for gl_space in (False, True):
        np.testing.assert_array_equal(
            tproj(137.5, 140.0, 64.0, 60.0, 128, 120, gl_space=gl_space),
            gl_perspective_projection_matrix(137.5, 140.0, 64.0, 60.0, 128,
                                             120, gl_space=gl_space))


@pytest.fixture(scope="module")
def live_body():
    """The dense toy body's triangle soup (13,680 triangles, ~1 px each)
    seen by the bench camera at 128^2, with per-vertex near-identity
    skinning mats."""
    from avatarcap_tpu.body.smpl import canonical_pose, smpl_forward
    from avatarcap_tpu_torch.tools.bench_workloads import bench_camera
    params = make_toy_smpl_params(n_lat=77, n_lon=90)
    cano = smpl_forward(params, jnp.asarray(canonical_pose()),
                        jnp.zeros(10))
    v = np.asarray(cano.vertices)
    tris = v[np.asarray(params.faces)].astype(np.float32)      # (T, 3, 3)
    rs = np.random.RandomState(9)
    tris = tris + rs.normal(0, 0.002, tris.shape).astype(np.float32)
    T = tris.shape[0]
    mats = np.tile(np.eye(4, dtype=np.float32).reshape(16), (3 * T, 1))
    mats[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]] += rs.uniform(
        -0.05, 0.05, (3 * T, 9)).astype(np.float32)
    valid = rs.uniform(size=T) < 0.97
    w2c, cam, normal = bench_camera(128)
    normal = normal + rs.normal(0, 0.1, normal.shape).astype(np.float32) \
        * (np.abs(normal).sum(-1, keepdims=True) > 0)
    return tris, valid, mats, w2c, cam, normal


def _clip(tris, w2c, cam, res):
    from avatarcap_tpu.render.camera import gl_perspective_projection_matrix
    proj = gl_perspective_projection_matrix(cam["fx"], cam["fy"], cam["cx"],
                                            cam["cy"], res, res)
    vh = np.concatenate([tris, np.ones_like(tris[..., :1])], -1)
    return np.einsum("ij,tvj->tvi", proj @ w2c, vh).astype(np.float32), proj


def _band_ok(ma, mb):
    agree = ma == mb
    pad = np.pad(agree, 1, constant_values=True)
    ok = np.ones_like(agree)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= pad[1 + dy:1 + dy + agree.shape[0],
                      1 + dx:1 + dx + agree.shape[1]]
    return ok


@pytest.mark.parametrize("kw", [dict(window=3, big_tri_capacity=128),
                                dict(window=4, max_candidates=4096),
                                dict(window=4)],
                         ids=["big_pass", "candidate_cap", "dense"])
def test_rasterize_perspective_matches_jax(live_body, kw):
    from avatarcap_tpu.render.raster import rasterize
    from avatarcap_tpu_torch.render.raster import rasterize as trast
    tris, valid, _, w2c, cam, _ = live_body
    clip, _ = _clip(tris, w2c, cam, 128)
    ref = rasterize(jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(valid),
                    128, 128, **kw)
    got = trast(_t(clip), _t(tris), _t(valid), 128, 128, **kw)
    rm, gm = np.asarray(ref.mask), got.mask.numpy()
    assert rm.sum() > 1000
    assert bool(got.overflow) == bool(np.asarray(ref.overflow))
    assert (rm != gm).sum() <= 3
    ok = _band_ok(rm, gm) & rm
    np.testing.assert_allclose(got.attrs.numpy()[ok],
                               np.asarray(ref.attrs)[ok], atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], atol=1e-6)
    assert np.all(got.attrs.numpy()[~gm] == 0)


def test_lift_image_normals_matches_jax(live_body):
    from avatarcap_tpu.fusion.normal_fusion import lift_image_normals
    from avatarcap_tpu_torch.fusion.normal_fusion import (
        lift_image_normals as tlift)
    tris, valid, mats, w2c, cam, normal = live_body
    _, proj = _clip(tris, w2c, cam, 128)
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], 128, 128)
    ref, r_ovf = lift_image_normals(
        jnp.asarray(tris), jnp.asarray(valid), jnp.asarray(normal),
        jnp.asarray(mats), jnp.asarray(w2c), jnp.asarray(proj), *args,
        window=3, big_tris=128, with_overflow=True)
    got, g_ovf = tlift(_t(tris), _t(valid), _t(normal), _t(mats), _t(w2c),
                       _t(proj), *args, window=3, big_tris=128)
    ref = np.asarray(ref).reshape(-1, 3)
    got = got.numpy().reshape(-1, 3)
    assert bool(g_ovf) == bool(np.asarray(r_ovf))
    rv, gv = np.abs(ref).sum(-1) > 0, np.abs(got).sum(-1) > 0
    assert rv.sum() > 200
    # a vertex on the 5 cm visibility threshold or a pixel edge may flip
    assert (rv != gv).mean() < 2e-3
    both = rv & gv
    np.testing.assert_allclose(got[both], ref[both], atol=1e-5)


def test_canonicalize_normal_map_matches_jax(live_body):
    """The standalone lift + canonical front/back render against JAX's
    canonicalize_normal_map on the live body (its canonical soup the live
    one moved back by a fixed offset), compared outside the raster's
    eps-slack boundary band. A lifted vertex on the visibility threshold
    may flip (test_lift_image_normals_matches_jax), which changes the
    pixels of its triangles: 99% of the pixels within 1e-5, all within
    the unit normals' range."""
    from avatarcap_tpu.fusion.normal_fusion import canonicalize_normal_map
    from avatarcap_tpu.render.camera import cano_front_back_mvp
    from avatarcap_tpu_torch.fusion.normal_fusion import (
        canonicalize_normal_map as tcanon)
    tris, valid, mats, w2c, cam, normal = live_body
    _, proj = _clip(tris, w2c, cam, 128)
    cano = (tris - np.array([0.02, -0.03, 0.01], np.float32)).astype(
        np.float32)
    center = cano.reshape(-1, 3).mean(0).astype(np.float32)
    fmvp, fmv, bmvp, bmv = cano_front_back_mvp(center)
    vert_mats = mats.reshape(-1, 3, 4, 4)
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], 128, 128)
    ref = canonicalize_normal_map(
        *(jnp.asarray(a) for a in (cano, tris, valid, normal, vert_mats, w2c,
                                   proj, fmvp, fmv, bmvp, bmv)),
        *args, res=128, window=4)
    got = tcanon(*(_t(a) for a in (cano, tris, valid, normal, vert_mats, w2c,
                                   proj, fmvp, fmv, bmvp, bmv)),
                 *args, res=128, window=4)
    covered = []
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape == (128, 128, 3)
        gm, rm = np.abs(g).sum(-1) > 0, np.abs(r).sum(-1) > 0
        covered.append(int(rm.sum()))
        assert (gm != rm).mean() < 5e-3
        ok = _band_ok(gm, rm) & rm
        d = np.abs(g[ok] - r[ok]).max(-1)
        assert (d <= 1e-5).mean() >= 0.99, (d <= 1e-5).mean()
        assert d.max() <= 2.0
    # the capture camera looks at the body's back: the back render holds
    # the lifted normals
    assert covered[1] > 500, covered


def test_axis_angle_gradient_at_zero_is_finite():
    """The merge starts its rotation grid at exactly zero: the small-angle
    branch must give a finite gradient there (the other branch's sqrt is
    kept away from 0 by the double where)."""
    from avatarcap_tpu_torch.ops.se3 import axis_angle_to_matrix
    aa = torch.zeros((4, 3), requires_grad=True)
    target = torch.randn((4, 3, 3), generator=torch.Generator().manual_seed(0))
    (axis_angle_to_matrix(aa) * target).sum().backward()
    assert torch.isfinite(aa.grad).all()
    # d R / d aa at 0 is the cross-product matrix: grad = the skew part
    skew = torch.stack([target[:, 2, 1] - target[:, 1, 2],
                        target[:, 0, 2] - target[:, 2, 0],
                        target[:, 1, 0] - target[:, 0, 1]], -1)
    torch.testing.assert_close(aa.grad, skew)


def test_resize_and_neighbor_shifts_match_jax():
    from avatarcap_tpu.fusion import normal_fusion as jnf
    from avatarcap_tpu_torch.fusion import normal_fusion as tnf
    rs = np.random.RandomState(2)
    img = rs.standard_normal((64, 64, 3)).astype(np.float32)
    wr = _t(tnf._resize_matrix(64, 128))
    wc = _t(tnf._resize_matrix(64, 96))
    np.testing.assert_allclose(
        tnf._resize_bilinear_ac(_t(img), wr, wc).numpy(),
        np.asarray(jnf._resize_bilinear_ac(jnp.asarray(img), 128, 96)),
        atol=1e-6)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            np.testing.assert_array_equal(
                tnf._neighbor_shift(_t(img), di, dj).numpy(),
                np.asarray(jnf._neighbor_shift(jnp.asarray(img), di, dj)))


_merge_inputs = merge_cases.merge_inputs


@pytest.mark.parametrize("iter_num,neck", [(4, (64, 120)), (20, (64, 120)),
                                           (4, (64, 50))],
                         ids=["4_iters", "20_iters", "face_box_noop"])
def test_merge_matches_jax(iter_num, neck):
    """The same Adam trajectory on both sides (optax's order of
    operations). Adam divides each step by the gradient's running RMS, so
    a pixel whose gradient is ~0 could step +-lr on one side and not the
    other; none does here. Measured max differences: 4e-6 after 4
    iterations, 7e-7 after 20 (2.7e-5 after 100). Held at 1e-3 for every
    pixel and 1e-4 for 99% of them."""
    from avatarcap_tpu.fusion.normal_fusion import merge_normal_images
    from avatarcap_tpu_torch.fusion.normal_fusion import (
        merge_normal_images as tmerge)
    src, tar = _merge_inputs()
    ref = np.asarray(merge_normal_images(jnp.asarray(src), jnp.asarray(tar),
                                         jnp.asarray(neck, jnp.int32),
                                         iter_num=iter_num))
    with torch.inference_mode():            # as the capture frame calls it
        got = tmerge(_t(src), _t(tar), neck, iter_num=iter_num)
    assert not got.requires_grad
    got = got.numpy()
    assert np.all(np.isfinite(got))
    assert np.abs(ref - src).max() > 1e-2          # the merge moved pixels
    d = np.abs(got - ref).max(-1)
    assert d.max() <= 1e-3, d.max()
    assert (d <= 1e-4).mean() >= 0.99, (d <= 1e-4).mean()
    x, y = neck
    box = np.s_[max(y - 90, 0):y, max(x - 35, 0):x + 35]
    if y >= 90:
        np.testing.assert_array_equal(got[box], src[box])
    else:
        assert np.abs(got[box] - src[box]).max() > 1e-2


@pytest.mark.parametrize("iter_num,neck", merge_cases.JAX_CASES,
                         ids=[merge_cases.case_name(*c)
                              for c in merge_cases.JAX_CASES])
def test_merge_jax_fixture_is_current(iter_num, neck):
    """tests/fixtures/merge_jax.npz, which the card's merge kernel is held
    to (tests/test_torch_cuda.py, where JAX is not installed), is the JAX
    package's merge on these inputs as it computes it now."""
    want = merge_cases.load_jax_fixture()[merge_cases.case_name(iter_num,
                                                                neck)]
    np.testing.assert_array_equal(merge_cases.jax_merge(iter_num, neck),
                                  want)


def test_merge_cover_matches_jax():
    from avatarcap_tpu.fusion.normal_fusion import merge_normal_images_cover
    from avatarcap_tpu_torch.fusion.normal_fusion import (
        merge_normal_images_cover as tcover)
    src, tar = _merge_inputs(64, seed=1)
    ref = np.asarray(merge_normal_images_cover(jnp.asarray(src),
                                               jnp.asarray(tar)))
    np.testing.assert_array_equal(tcover(_t(src), _t(tar)).numpy(), ref)


@pytest.mark.parametrize("H", [2, 3, 64, 97, 512])
@pytest.mark.parametrize("iter_num", [0, 1, 7, 100])
def test_merge_tables_match_resize_and_adam(H, iter_num):
    """The merge kernel's host-built tables, exactly: the taps rebuild
    _resize_matrix(64, H), the adjoint supports its transpose (fine rows
    ascending within each grid row), and the bias corrections equal
    ops/adam.Adam._correction at every step of either phase."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    from avatarcap_tpu_torch.ops.adam import Adam
    t = nf.merge_tables(H, iter_num)
    m = nf._resize_matrix(nf.MERGE_GRID, H)
    dense = np.zeros_like(m)
    for k in range(2):
        np.add.at(dense, (np.arange(H), t["taps_idx"][:, k]),
                  t["taps_w"][:, k])
    np.testing.assert_array_equal(dense, m)
    adj = np.zeros_like(m.T)
    off = t["adj_off"]
    assert off[0] == 0 and len(off) == nf.MERGE_GRID + 1
    for h in range(nf.MERGE_GRID):
        rows = t["adj_idx"][off[h]:off[h + 1]]
        assert np.all(np.diff(rows) > 0)
        adj[h, rows] = t["adj_w"][off[h]:off[h + 1]]
    np.testing.assert_array_equal(adj, m.T)
    n = iter_num - iter_num // 2
    opt = Adam([torch.zeros(1)])
    want1, want2 = [], []
    for step in range(1, n + 1):
        opt.count = step
        want1.append(float(opt._correction(0.9)))
        want2.append(float(opt._correction(0.999)))
    assert t["corr1"].dtype == t["corr2"].dtype == np.float32
    np.testing.assert_array_equal(t["corr1"], np.float32(want1))
    np.testing.assert_array_equal(t["corr2"], np.float32(want2))


def test_merge_source_constants_match():
    """csrc/normal_merge.cu's grid side and workspace against the Python
    side's."""
    from avatarcap_tpu_torch import kernels
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    c = kernels.source_constants("normal_merge.cu")
    assert c["kGrid"] == nf.MERGE_GRID
    assert nf.MERGE_WORK_FLOATS == 4 * c["kGridElems"]
    assert "normal_merge" in kernels.SOURCES


def test_merge_cpu_takes_plain_path():
    """A CPU call runs merge_normal_images_plain (the same bits), launches
    nothing and opens no merge_kernel span; another device raises."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    from avatarcap_tpu_torch.utils.timers import Tracer
    src, tar = _merge_inputs(48, seed=2)
    before = nf.merge_normal_images.launches
    tracer = Tracer("cpu")
    with tracer("merge"):
        got = nf.merge_normal_images(_t(src), _t(tar), (24, 40), iter_num=6)
    assert nf.merge_normal_images.launches == before
    assert [s.name for s in tracer.collect()] == ["merge"]
    ref = nf.merge_normal_images_plain(_t(src), _t(tar), (24, 40), iter_num=6)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="unsupported device"):
        nf.merge_normal_images(torch.zeros((4, 4, 3), device="meta"),
                               torch.zeros((4, 4, 3), device="meta"), (0, 0))


@pytest.mark.parametrize("case", ["not_square", "tar_shape", "side_1",
                                  "float64", "negative_iters"])
def test_merge_kernel_rejects_what_it_does_not_take(case):
    """The kernel path's checks, which run before anything touches a
    card."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    src = torch.zeros((8, 8, 3))
    tar = torch.zeros((8, 8, 3))
    iters = 10
    if case == "not_square":
        src = torch.zeros((8, 9, 3))
    elif case == "tar_shape":
        tar = torch.zeros((8, 8, 4))
    elif case == "side_1":
        src, tar = torch.zeros((1, 1, 3)), torch.zeros((1, 1, 3))
    elif case == "float64":
        src, tar = src.double(), tar.double()
    else:
        iters = -1
    with pytest.raises(ValueError):
        nf._merge_launch(src, tar, (0, 0), iters)
