"""The port's offline preprocessing (tools/preprocess.py, on the CPU)
against the JAX package's, on small inputs from seeded numpy draws.

- Host code copied from the JAX module gives the same values:
  ``sample_nodes_even`` and ``subdivide_mesh`` exactly, ``vertex_normals``
  within 1e-6, ``crop_square_by_smpl`` exactly.
- ``canonicalize_scan``: the kept sets agree on 99.5% of the points (the
  culling compares float32 dot products with 0, and the two sides sum
  them in their own orders), kept positions and normals within 1e-5.
- ``nonrigid_fit``, 10 steps, within 1e-4 (Adam in optax's order on
  both sides; the template is jittered so that no two nodes tie as a
  vertex's neighbours).
- ``canonicalize_and_reconstruct(poisson_res=32, fit_iterations=5)``:
  triangle counts within 1%; as point sets, 99% of either soup's
  vertices within 0.1 voxel of the other's and all within 0.5 (the fit's
  1e-4 differences can move a template vertex across the 1 cm inpainting
  threshold, and the Poisson solve then sees one point more or less);
  the original-surface shares within 1%.
- ``presample_points``: the same numpy draws, so the same points (within
  1e-6), and labels from the same BVH within 1e-5.
- ``infer_normal_map`` and ``preprocess_real_data`` with a small
  GlobalGenerator (ngf 4, 2 down, 1 block) carried across by the weight
  bridge: normal maps within 1e-4.
- ``preprocess_training_data`` on a tiny subject (Poisson lowered to
  32^3 on both sides by monkeypatch) writes every file the JAX pipeline
  writes, and the port's dataset reads them.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from conftest import make_toy_smpl_params, uv_sphere


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _port_params(params):
    from avatarcap_tpu_torch.body.smpl import SmplParams
    return SmplParams(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(SmplParams)})


def _pose(seed=0, spread=0.2):
    from avatarcap_tpu_torch.body.smpl import canonical_pose
    pose = canonical_pose().copy()
    rng = np.random.RandomState(seed)
    pose[6:] += rng.uniform(-spread, spread, pose.size - 6).astype(
        np.float32)
    return pose


def _posed_scan(params, pose, subdivisions=1):
    """The body posed at ``pose``, subdivided: (verts, faces, normals)."""
    from avatarcap_tpu_torch.body.smpl import smpl_forward
    from avatarcap_tpu_torch.tools.preprocess import (subdivide_mesh,
                                                      vertex_normals)
    with torch.no_grad():
        v = smpl_forward(_port_params(params), torch.as_tensor(pose),
                         torch.zeros(10)).vertices.numpy()
    v, f = subdivide_mesh(v, params.faces, iterations=subdivisions)
    return v, f, vertex_normals(v, f)


def _point_set_gap(a, b):
    return max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max())


def test_host_helpers_equal_jax():
    from avatarcap_tpu.tools import preprocess as jp
    from avatarcap_tpu_torch.tools import preprocess as tp
    verts, faces = uv_sphere(n_lat=9, n_lon=13)
    for it in (1, 2):
        for a, b in zip(tp.subdivide_mesh(verts, faces, iterations=it),
                        jp.subdivide_mesh(verts, faces, iterations=it)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    v2, f2 = tp.subdivide_mesh(verts, faces)
    rng = np.random.RandomState(0)
    v2 = v2 + rng.normal(0, 0.01, v2.shape).astype(np.float32)
    np.testing.assert_allclose(tp.vertex_normals(v2, f2),
                               jp.vertex_normals(v2, f2), atol=1e-6)
    for radius, seed in ((0.1, 0), (0.25, 3)):
        got = tp.sample_nodes_even(v2, radius, seed)
        assert 5 < len(got) < len(v2)
        np.testing.assert_array_equal(got,
                                      jp.sample_nodes_even(v2, radius, seed))


def test_crop_square_by_smpl_equals_jax():
    from avatarcap_tpu.tools.preprocess import crop_square_by_smpl as jc
    from avatarcap_tpu_torch.tools.preprocess import crop_square_by_smpl
    rng = np.random.RandomState(1)
    img = rng.uniform(0, 1, (180, 150, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (180, 150)) > 0.5).astype(np.uint8) * 255
    K = np.array([[200, 0, 75], [0, 200, 90], [0, 0, 1]], np.float32)
    # a body hanging off the image's top left corner: padded crop
    verts = (rng.uniform(-0.3, 0.3, (500, 3))
             + [-0.2, -0.3, 1.5]).astype(np.float32)
    for out_size in (64, 96):
        got = crop_square_by_smpl(img, mask, verts, K, out_size=out_size)
        ref = jc(img, mask, verts, K, out_size=out_size)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2] and got[2][0] < 0


def test_canonicalize_scan_matches_jax():
    from avatarcap_tpu.tools.preprocess import canonicalize_scan as jcs
    from avatarcap_tpu_torch.tools.preprocess import canonicalize_scan
    params = make_toy_smpl_params()
    pose = _pose(seed=1)
    scan_v, _, scan_n = _posed_scan(params, pose)
    # points whose normals face away from the body are culled
    flip = np.random.RandomState(1).uniform(size=len(scan_n)) < 0.1
    scan_n = np.where(flip[:, None], -scan_n, scan_n)
    shape = np.zeros(10, np.float32)
    ref_v, ref_n = jcs(scan_v, scan_n, pose, shape, params)
    got_v, got_n = canonicalize_scan(scan_v, scan_n, pose, shape,
                                     _port_params(params), device="cpu")
    assert 0.5 * len(scan_v) < len(ref_v) <= len(scan_v) - flip.sum()
    d, j = cKDTree(ref_v).query(got_v)
    both = d <= 1e-5
    assert both.sum() >= 0.995 * max(len(got_v), len(ref_v))
    np.testing.assert_allclose(got_n[both], ref_n[j[both]], atol=1e-5)


def test_nonrigid_fit_matches_jax():
    from avatarcap_tpu.tools.preprocess import nonrigid_fit as jfit
    from avatarcap_tpu_torch.tools.preprocess import (nonrigid_fit,
                                                      vertex_normals)
    verts, faces = uv_sphere(n_lat=10, n_lon=12, radius=0.3)
    rng = np.random.RandomState(2)
    verts = verts + rng.normal(0, 0.005, verts.shape).astype(np.float32)
    normals = vertex_normals(verts, faces)
    target = verts + np.array([0.03, 0.01, 0.0], np.float32)
    kw = dict(node_radius=0.08, iterations=10, lr=5e-3)
    ref = jfit(verts, normals, target, normals, **kw)
    got = nonrigid_fit(verts, normals, target, normals, device="cpu", **kw)
    moved = np.abs(got - verts).max()
    assert moved > 0.02
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.fixture(scope="module")
def small_scan():
    params = make_toy_smpl_params()
    pose = _pose(seed=2, spread=0.15)
    return (params, pose) + _posed_scan(params, pose)


def test_canonicalize_and_reconstruct_matches_jax(small_scan):
    from avatarcap_tpu.tools.preprocess import \
        canonicalize_and_reconstruct as jcr
    from avatarcap_tpu_torch.tools.preprocess import \
        canonicalize_and_reconstruct
    params, pose, scan_v, _, scan_n = small_scan
    shape = np.zeros(10, np.float32)
    kw = dict(poisson_res=32, fit_iterations=5)
    ref_v, ref_nt, ref_flag = jcr(scan_v, scan_n, pose, shape, params, **kw)
    rec = {}
    got_v, got_nt, got_flag = canonicalize_and_reconstruct(
        scan_v, scan_n, pose, shape, _port_params(params), device="cpu",
        record=rec, **kw)
    assert ref_nt > 200 and abs(got_nt - ref_nt) <= 0.01 * ref_nt
    assert got_v.shape == (3 * got_nt, 3) and got_flag.shape == (got_nt,)
    voxel = (got_v.max(0) - got_v.min(0) + 0.2).max() / 32
    for a, b in ((got_v, np.asarray(ref_v)), (np.asarray(ref_v), got_v)):
        d = cKDTree(b).query(a)[0]
        assert (d <= 0.1 * voxel).mean() >= 0.99 and d.max() <= 0.5 * voxel
    assert abs(got_flag.mean() - ref_flag.mean()) <= 0.01
    counts = rec["counts"]
    assert counts["triangles"] == got_nt and not counts["poisson_overflow"]
    assert (counts["template_scan_mean_distance_after"]
            < counts["template_scan_mean_distance_before"])
    assert rec["reconstruction"]["verts"] is got_v
    assert set(rec["seconds"]) == {"canonicalize", "template",
                                   "nonrigid_fit", "inpaint", "poisson",
                                   "surface_flag"}


def test_presample_points_matches_jax():
    from avatarcap_tpu.tools.preprocess import presample_points as jps
    from avatarcap_tpu_torch.tools.preprocess import presample_points
    verts, faces = uv_sphere(n_lat=14, n_lon=20, radius=0.4)
    soup = verts[faces].reshape(-1, 3)
    nt = len(faces)
    flag = np.ones(nt, bool)
    flag[:10] = False
    kw = dict(sur_count=5000, vol_count=500, seed=3)
    ref = jps(soup, nt, flag, **kw)
    got = presample_points(soup, nt, flag, device="cpu", **kw)
    for a, b in zip(got, ref):
        assert a.shape == np.asarray(b).shape
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(got[3], np.asarray(ref[3]), atol=1e-5)
    assert (got[3] > 0).any() and (got[3] < 0).any()


@pytest.fixture(scope="module")
def generators():
    """A small port GlobalGenerator and the JAX one on its weights."""
    from avatarcap_tpu.models.pix2pix import GlobalGenerator as JG
    from avatarcap_tpu.tools.convert_torch_ckpt import \
        convert_global_generator
    from avatarcap_tpu_torch.tools.bench_preprocess import random_generator
    model = random_generator(seed=5, ngf=4, n_downsampling=2, n_blocks=1)
    variables = convert_global_generator(
        {k: v.detach() for k, v in model.state_dict().items()},
        n_downsampling=2, n_blocks=1)
    jmodel = JG(output_nc=3, ngf=4, n_downsampling=2, n_blocks=1)

    class JaxGenerator:
        def apply(self, v, x):
            return jmodel.apply(v, x)

    return model, JaxGenerator(), variables


def test_infer_normal_map_matches_jax(generators):
    from avatarcap_tpu.tools.preprocess import infer_normal_map as jinf
    from avatarcap_tpu_torch.tools.preprocess import infer_normal_map
    model, jgen, variables = generators
    rng = np.random.RandomState(4)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (90, 120)) > 0.3).astype(np.uint8)
    bbox = (-10, 20, 80)
    ref = jinf(jgen, variables, img, mask, bbox, (90, 120))
    got = infer_normal_map(model, img, mask, bbox, (90, 120))
    assert got.shape == (90, 120, 3) and np.abs(ref).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert (got[mask == 0] == 0).all()


def test_preprocess_real_data_matches_jax(generators, tmp_path):
    import shutil
    from avatarcap_tpu.tools.preprocess import preprocess_real_data as jprd
    from avatarcap_tpu_torch.data.image_io import load_float_image
    from avatarcap_tpu_torch.tools.bench_preprocess import write_real_frames
    from avatarcap_tpu_torch.tools.preprocess import preprocess_real_data
    model, jgen, variables = generators
    params = make_toy_smpl_params()
    poses = []
    for seed in (6, 7):
        pose = _pose(seed, spread=0.15)
        pose[:3] = (0.0, 0.0, 2.2)
        poses.append(pose)
    got_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    write_real_frames(got_dir, _port_params(params), poses, img_size=160,
                      focal=240.0)
    shutil.copytree(got_dir, ref_dir)
    jprd(ref_dir, params, generator=jgen, generator_vars=variables,
         pos_map_res=32)
    frames = preprocess_real_data(got_dir, _port_params(params),
                                  generator=model, pos_map_res=32,
                                  device="cpu")
    assert [f["idx"] for f in frames] == [0, 1]
    for i in range(2):
        name = f"imgs/normal/normal_{i:04d}"
        got = load_float_image(os.path.join(got_dir, name))
        ref = load_float_image(os.path.join(ref_dir, name))
        assert got.shape == (160, 160, 3) and np.abs(ref).max() > 0.05
        np.testing.assert_allclose(got, ref, atol=1e-4)
        pm = f"smpl/smpl_pos_map_{i:04d}_cano"
        got_pm = load_float_image(os.path.join(got_dir, pm))
        ref_pm = load_float_image(os.path.join(ref_dir, pm))
        assert got_pm.shape == ref_pm.shape == (32, 64, 3)
        # the rasterizers may differ on the boundary band's pixels
        assert (np.abs(got_pm - ref_pm) < 1e-5).mean() > 0.98
    import yaml
    for d in (got_dir, ref_dir):
        with open(os.path.join(d, "dataConfig.yaml")) as f:
            cfg = yaml.safe_load(f)
        assert cfg["data_type"] == "real" and cfg["pos_map_res"] == 32
    with pytest.raises(ValueError, match="generator"):
        preprocess_real_data(got_dir, _port_params(params), generator=model,
                             device="meta")


def _lower_poisson(monkeypatch, module, res):
    real = module.poisson_reconstruct

    def lowered(points, normals, **kw):
        kw.pop("res", None)
        return real(points, normals, res=res, **kw)

    monkeypatch.setattr(module, "poisson_reconstruct", lowered)


def test_preprocess_training_data_writes_what_jax_writes(small_scan,
                                                         tmp_path,
                                                         monkeypatch):
    import avatarcap_tpu.ops.poisson as jpoisson
    from avatarcap_tpu.data.mesh_io import save_ply
    from avatarcap_tpu.tools.preprocess import \
        preprocess_training_data as jptd
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset
    from avatarcap_tpu_torch.tools import preprocess as tp
    params, pose, scan_v, faces, scan_n = small_scan
    lo, hi = scan_v.min(0), scan_v.max(0)
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        os.makedirs(d / "scan")
        os.makedirs(d / "smpl")
        np.savetxt(d / "smpl/shape.txt", np.zeros(10, np.float32))
        np.savetxt(d / "smpl/pose_0000.txt", pose)
        save_ply(str(d / "scan/000.ply"), scan_v, faces, normals=scan_n,
                 colors=((scan_v - lo) / (hi - lo)).astype(np.float32))
        dirs.append(str(d))
    _lower_poisson(monkeypatch, jpoisson, 32)
    _lower_poisson(monkeypatch, tp, 32)
    kw = dict(n_views=2, img_size=64, pos_map_res=64, sur_count=3000,
              vol_count=300, fit_iterations=5)
    jptd(dirs[0], params, **kw)
    run = tp.preprocess_training_data(dirs[1], _port_params(params),
                                      device="cpu", **kw)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert files(dirs[1]) == files(dirs[0])
    assert len(files(dirs[0])) > 10
    assert run["scans"][0]["counts"]["triangles"] > 200
    with np.load(os.path.join(dirs[1], "cano_pts_ov/000.npz")) as got, \
            np.load(os.path.join(dirs[0], "cano_pts_ov/000.npz")) as ref:
        assert got["sur_pts"].shape == ref["sur_pts"].shape == (3000, 3)
        assert got["vol_pts"].shape == ref["vol_pts"].shape == (300, 3)
        assert np.isfinite(got["sur_pts_ov"]).all()
    np.testing.assert_allclose(
        np.load(os.path.join(dirs[1], "cano_base_blend_weight_volume.npy")),
        np.load(os.path.join(dirs[0], "cano_base_blend_weight_volume.npy")),
        atol=1e-5)
    ds = AvatarCapDataset(dirs[1], training=True,
                          smpl_params=_port_params(params))
    assert len(ds) == 2
    item = ds[0]
    assert all(np.isfinite(v).all() for v in item.values()
               if isinstance(v, np.ndarray) and v.dtype.kind == "f")


def test_bench_phases_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's [preprocess] and [preprocess_real] phases
    (tools/bench_preprocess.py) at a rehearsal size on the CPU, their
    checks included: the fit lowers the distance, a bit-equal second
    Poisson solve, the BVH against the device path, the dataset, the
    normal maps and the generator on two devices (here both the CPU)."""
    from avatarcap_tpu_torch.tools import bench_preprocess as bp
    from avatarcap_tpu_torch.tools import preprocess as tp
    _lower_poisson(monkeypatch, tp, 40)
    rec = bp.run_scan("cpu", tmp_path, subdivisions=1, dense=False,
                      check_points=2000, n_views=2, img_size=64,
                      pos_map_res=64, sur_count=3000, vol_count=300,
                      fit_iterations=10)
    assert rec["poisson_bit_equal"] and rec["dataset_items"] == 2
    assert rec["sdf_check"]["points"] == 2000
    assert set(rec["stage_seconds"]) >= {"weight_volume", "nonrigid_fit",
                                         "poisson", "presample",
                                         "orbit_views"}
    real = bp.run_real("cpu", tmp_path, img_size=256, dense=False,
                       generator_kw=dict(ngf=4, n_downsampling=2,
                                         n_blocks=1))
    assert [f["idx"] for f in real["frames"]] == [0, 1]
    assert real["crop"] == [512, 512, 3]
