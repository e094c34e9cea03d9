"""The port's subject writer (tools/gen_synthetic.generate_subject, on the
CPU) against the JAX package's, with the same seed, on the toy body: 2
poses x 2 views, 64 px images, 64^2 position maps, 2,000 + 200 presampled
points.

The numpy RandomState draws are the same on both sides. What the SMPL
forward kinematics feeds (torch here, XLA there; the canonical vertices
differ at ~1e-7) is held at tolerances: the sampled points within 1e-6;
the SDF labels' squares within 1e-6 and the labels within 1e-5 where the
distance is at least 1 cm (nearer the surface, sqrt turns the float32
rounding of |q|^2 - 2 q.v + |v|^2, ~1e-7 at metre scale, into up to
~3e-4), their signs equal but for 1e-4 of the points; position maps and
the weight volume within 1e-5 and masks equal outside the raster's
boundary band; normal images within 1e-4 inside the mask.
"""

import dataclasses
import os

import cv2 as cv
import numpy as np
import pytest
import scipy.io as sio
import torch

from conftest import make_toy_smpl_params


@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    from avatarcap_tpu.body.smpl import canonical_pose
    from avatarcap_tpu.tools.gen_synthetic import generate_subject as jgen
    from avatarcap_tpu_torch.body.smpl import SmplParams
    from avatarcap_tpu_torch.tools.gen_synthetic import generate_subject

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    params = make_toy_smpl_params()
    rng = np.random.RandomState(0)
    poses = []
    for _ in range(2):
        p = canonical_pose().copy()
        p[6:] += rng.uniform(-0.2, 0.2, p.size - 6).astype(np.float32)
        poses.append(p)
    kw = dict(n_views=2, img_size=64, pos_map_res=64, sur_pts_count=2000,
              vol_pts_count=200, seed=5)
    ref = str(tmp_path_factory.mktemp("jax_subject"))
    got = str(tmp_path_factory.mktemp("port_subject"))
    jgen(ref, params, np.zeros(10, np.float32), np.stack(poses), **kw)
    generate_subject(got, SmplParams(**{
        f.name: getattr(params, f.name)
        for f in dataclasses.fields(SmplParams)}),
        np.zeros(10, np.float32), np.stack(poses), device="cpu", **kw)
    yield got, ref
    torch.set_num_threads(n)


def _same_files(got, ref):
    names = sorted(os.path.relpath(os.path.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    got_names = sorted(os.path.relpath(os.path.join(d, f), got)
                       for d, _, fs in os.walk(got) for f in fs)
    assert got_names == names
    return names


def _band_ok(ma, mb):
    agree = ma == mb
    pad = np.pad(agree, 1, constant_values=True)
    ok = np.ones_like(agree)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= pad[1 + dy:1 + dy + agree.shape[0],
                      1 + dx:1 + dx + agree.shape[1]]
    return ok


def test_layout_config_and_poses(subjects):
    got, ref = subjects
    names = _same_files(got, ref)
    assert any(n.startswith("imgs/001/normal_view_001") for n in names)
    for name in ("dataConfig.yaml", "smpl/shape.txt", "smpl/pose_0000.txt",
                 "smpl/pose_0001.txt"):
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("pose", [0, 1])
def test_presampled_points_and_sdf(subjects, pose):
    got, ref = subjects
    a = np.load(os.path.join(got, f"cano_pts_ov/{pose:03d}.npz"))
    b = np.load(os.path.join(ref, f"cano_pts_ov/{pose:03d}.npz"))
    assert set(a.files) == set(b.files)
    for k in ("sur_pts", "vol_pts"):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    for k in ("sur_pts_ov", "vol_pts_ov"):
        da, db = a[k], b[k]
        np.testing.assert_allclose(da * da, db * db, rtol=0, atol=1e-6,
                                   err_msg=k)
        far = np.abs(db) >= 0.01
        assert far.mean() > 0.5
        np.testing.assert_allclose(np.abs(da[far]), np.abs(db[far]), rtol=0,
                                   atol=1e-5, err_msg=k)
        assert (np.sign(da) != np.sign(db)).sum() <= 1e-4 * len(db), k


def _float_image(path_no_ext):
    from avatarcap_tpu_torch.data.image_io import load_float_image
    return load_float_image(path_no_ext + ".exr")


@pytest.mark.parametrize("pose", [0, 1])
def test_position_maps(subjects, pose):
    got, ref = subjects
    name = f"smpl/smpl_pos_map_{pose:04d}_cano"
    a = _float_image(os.path.join(got, name))
    b = _float_image(os.path.join(ref, name))
    assert a.shape == b.shape == (64, 128, 3)
    ma, mb = np.any(a != 0, -1), np.any(b != 0, -1)
    assert mb.sum() > 500
    ok = _band_ok(ma, mb)
    np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=1e-5)


def test_weight_volume(subjects):
    got, ref = subjects
    a = np.load(os.path.join(got, "cano_base_blend_weight_volume.npy"))
    b = np.load(os.path.join(ref, "cano_base_blend_weight_volume.npy"))
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (b.sum(-1) > 0.5).mean() > 0.05
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pose,view", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_orbit_views(subjects, pose, view):
    """Masks equal and depth within 1 mm outside the boundary band, the
    color JPEGs within 2 levels there, normal images within 1e-4 inside
    the mask, and the cameras within 1e-6."""
    got, ref = subjects
    d = f"imgs/{pose:03d}"
    ma = cv.imread(os.path.join(got, d, f"mask_view_{view:03d}.png"), -1)
    mb = cv.imread(os.path.join(ref, d, f"mask_view_{view:03d}.png"), -1)
    assert (mb > 0).sum() > 200
    ok = _band_ok(ma > 0, mb > 0)
    np.testing.assert_array_equal(ma[ok], mb[ok])
    for name, atol in (("depth", 1), ("color", 2)):
        ext = "png" if name == "depth" else "jpg"
        ia = cv.imread(os.path.join(got, d, f"{name}_view_{view:03d}.{ext}"),
                       -1).astype(np.int64)
        ib = cv.imread(os.path.join(ref, d, f"{name}_view_{view:03d}.{ext}"),
                       -1).astype(np.int64)
        np.testing.assert_allclose(ia[ok], ib[ok], rtol=0, atol=atol,
                                   err_msg=name)
    na = _float_image(os.path.join(got, d, f"normal_view_{view:03d}"))
    nb = _float_image(os.path.join(ref, d, f"normal_view_{view:03d}"))
    inside = ok & (mb > 0)
    np.testing.assert_allclose(na[inside], nb[inside], rtol=0, atol=1e-4)
    ca = sio.loadmat(os.path.join(got, d, "cams.mat"))
    cb = sio.loadmat(os.path.join(ref, d, "cams.mat"))
    for k in ("cam_rs", "cam_ts"):
        np.testing.assert_allclose(ca[k], cb[k], rtol=0, atol=1e-6)


def test_render_textured_orbit_views(tmp_path):
    """The textured-scan orbit writer (color from vertex colors, mask,
    depth, cams.mat) against the JAX package's, at the tolerances of the
    orbit views above."""
    from avatarcap_tpu.body.smpl import canonical_pose, smpl_forward
    from avatarcap_tpu.tools.gen_synthetic import (
        render_textured_orbit_views as jrender)
    from avatarcap_tpu_torch.tools.gen_synthetic import (
        render_textured_orbit_views)
    import jax.numpy as jnp
    params = make_toy_smpl_params(n_lat=16, n_lon=24)
    v = np.asarray(smpl_forward(params, jnp.asarray(canonical_pose()),
                                jnp.zeros(10)).vertices)
    colors = np.random.RandomState(6).randint(
        0, 256, (len(v), 3)).astype(np.uint8)
    cam = {"fx": 320.0, "fy": 320.0, "cx": 32.0, "cy": 32.0,
           "img_width": 64, "img_height": 64}
    jrender(v, params.faces, colors, str(tmp_path / "jax"), cam, n_views=2)
    render_textured_orbit_views(v, params.faces, colors,
                                str(tmp_path / "port"), cam, n_views=2,
                                device="cpu")
    got, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    for view in range(2):
        ma = cv.imread(os.path.join(got, f"mask_view_{view:03d}.png"), -1)
        mb = cv.imread(os.path.join(ref, f"mask_view_{view:03d}.png"), -1)
        assert (mb > 0).sum() > 200
        ok = _band_ok(ma > 0, mb > 0)
        np.testing.assert_array_equal(ma[ok], mb[ok])
        for name, ext, atol in (("depth", "png", 1), ("color", "jpg", 2)):
            ia = cv.imread(os.path.join(got, f"{name}_view_{view:03d}.{ext}"),
                           -1).astype(np.int64)
            ib = cv.imread(os.path.join(ref, f"{name}_view_{view:03d}.{ext}"),
                           -1).astype(np.int64)
            np.testing.assert_allclose(ia[ok], ib[ok], rtol=0, atol=atol,
                                       err_msg=name)
    ca = sio.loadmat(os.path.join(got, "cams.mat"))
    cb = sio.loadmat(os.path.join(ref, "cams.mat"))
    for k in ("cam_rs", "cam_ts"):
        np.testing.assert_allclose(ca[k], cb[k], rtol=0, atol=1e-6)
