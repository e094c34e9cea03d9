"""The command-line slice's modules against the JAX package on the CPU: the
config, the SMPL pkl reader, the inside test, the live-preview camera
helpers, the renderers (render_mesh_single, render_cano_mesh,
render_live_mesh, normal2color, AvatarCapture.render_live), StageTimer and
the Chamfer metrics. Meshes are the toy body (denser than the default
toy, so the renders cover a few thousand pixels); images are compared
outside the raster's boundary band, as tests/test_torch_capture.py does.
The dataset's test mode is held in tests/test_torch_data.py, the CLI in
tests/test_torch_cli.py.
"""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from conftest import make_toy_smpl_params

EVERY_KEY = {
    "training": {"training_data_dir": "/d/train", "net_ckpt_dir": "/c",
                 "net_ckpt": "/c/epoch_3", "start_epoch": 3,
                 "end_epoch": 7, "ckpt_interval": 2,
                 "training_data_ids": "/ids.txt", "batch_size": 2,
                 "num_workers": 5, "finetune_tex": False,
                 "finetune_tex_data_idx": 4},
    "testing": {"vol_res": [64, 48, 32], "recon_net_ckpt": "/r",
                "net_ckpt": "/n", "net_ckpt_finetuned": "/nf",
                "testing_data_dir": "/d/test", "output_dir": "/o",
                "max_tris": 1000, "max_active": 500, "render_res": 256},
    "model": {"cano_template": {"pos_encoding": 8},
              "warping_field": {"pos_encoding": 2},
              "cano_template_lr": 0.002, "warping_field_lr": 0.0003,
              "img_loss_weight": 2.0, "occ_loss_weight": 0.25,
              "geo_offset_reg_loss_weight": 0.5,
              "tex_offset_reg_loss_weight": 0.125},
    "smpl_gender": "F", "smpl_model_dir": "/smpl", "n_samples": 32,
    "perturb": 0, "if_type": "occupancy"}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Fewer torch threads beside XLA's in one process (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra", [None, {"recon_color_mode": "direct",
                                          "nerf_unique_capacity": 4096}],
                         ids=["example", "every_key"])
def test_load_config_matches_jax(tmp_path, extra):
    """configs/example.yaml, and a YAML that sets every key to a value
    other than its default, load to the JAX config's values; the port's
    one addition, testing.capture_options, is read too (JAX drops it).
    The CLI builds the config's avatar form (if_type, positional
    encodings: (8, 2) occupancy in the second)."""
    from avatarcap_tpu.config import load_config as jload
    from avatarcap_tpu_torch.cli import _new_avatar
    from avatarcap_tpu_torch.config import load_config
    if extra is None:
        path = "configs/example.yaml"
    else:
        raw = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in EVERY_KEY.items()}
        raw["testing"] = dict(raw["testing"], capture_options=extra)
        path = str(tmp_path / "every_key.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
    got = dataclasses.asdict(load_config(path))
    ref = dataclasses.asdict(jload(path))
    assert got["testing"].pop("capture_options") == (extra or {})
    assert got == ref
    cfg = load_config(path)
    avatar = _new_avatar(cfg, 0)
    assert avatar.if_type == cfg.if_type
    assert avatar.encodings == (cfg.model.cano_template_pos_encoding,
                                cfg.model.warping_field_pos_encoding)
    if extra is not None:
        defaults = dataclasses.asdict(type(load_config(path))())
        defaults["testing"].pop("capture_options")
        for section in ("model", "training", "testing"):
            for k, v in got[section].items():
                assert v != defaults[section][k], (section, k)


def test_smpl_load_matches_jax(tmp_path):
    """An official-layout pkl (written by utils.toy_body.write_smpl_pkl)
    reads to the same arrays as the JAX package's SmplParams.load."""
    from avatarcap_tpu.body.smpl import SmplParams as JParams
    from avatarcap_tpu_torch.body.smpl import SmplParams
    from avatarcap_tpu_torch.utils.toy_body import write_smpl_pkl
    params = _port_params(make_toy_smpl_params())
    path = str(tmp_path / "toy.pkl")
    write_smpl_pkl(params, path)
    got, ref = SmplParams.load(path), JParams.load(path)
    for f in dataclasses.fields(SmplParams):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        np.testing.assert_array_equal(a, getattr(params, f.name),
                                      err_msg=f.name)


def _port_params(params):
    from avatarcap_tpu_torch.body.smpl import SmplParams
    return SmplParams(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(SmplParams)})


def _toy_cano(n_lat=24, n_lon=32):
    from avatarcap_tpu.body.smpl import canonical_pose, smpl_forward
    params = make_toy_smpl_params(n_lat=n_lat, n_lon=n_lon)
    v = np.asarray(smpl_forward(params, jnp.asarray(canonical_pose()),
                                jnp.zeros(10)).vertices)
    return params, v


@pytest.mark.parametrize("kind", ["grid", "random"])
def test_points_inside_mesh_matches_jax(kind):
    """The inside flags equal JAX's, allowing 1e-4 of the points as ties
    on a shared edge (measured: none differ at these sizes)."""
    from avatarcap_tpu.ops.inside import points_inside_mesh as jinside
    from avatarcap_tpu_torch.ops.inside import points_inside_mesh
    params, v = _toy_cano()
    tris = v[params.faces]
    lo, hi = v.min(0) - 0.1, v.max(0) + 0.1
    if kind == "grid":
        lin = [np.linspace(0, 1, r, dtype=np.float32) for r in (48, 48, 24)]
        g = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
        pts = (g * (hi - lo) + lo).astype(np.float32)
    else:
        pts = np.random.RandomState(3).uniform(
            lo, hi, (20000, 3)).astype(np.float32)
    ref = np.asarray(jinside(jnp.asarray(pts), jnp.asarray(tris)))
    got = points_inside_mesh(torch.from_numpy(pts),
                             torch.from_numpy(tris)).numpy()
    assert 0.05 < ref.mean() < 0.95
    assert (got != ref).sum() <= 1e-4 * len(pts)
    # a tile of one column at a time gives the same flags
    small = points_inside_mesh(torch.from_numpy(pts[:4000]),
                               torch.from_numpy(tris),
                               tile_elems=len(tris), point_chunk=1000)
    np.testing.assert_array_equal(small.numpy(), got[:4000])


def test_camera_helpers_match_jax():
    from avatarcap_tpu.render import camera as jcam
    from avatarcap_tpu_torch.render import camera
    _, v = _toy_cano()
    for a in (0.0, -0.15, 0.7):
        np.testing.assert_allclose(camera._rot_x(a), jcam._rot_x(a),
                                   atol=1e-6)
        np.testing.assert_allclose(camera.calc_front_mv(v, a, 0.3),
                                   jcam.calc_front_mv(v, a, 0.3), atol=1e-6)
        np.testing.assert_allclose(camera.calc_back_mv(v, a),
                                   jcam.calc_back_mv(v, a), atol=1e-6)
    np.testing.assert_allclose(camera.real2gl_matrix(),
                               jcam.real2gl_matrix(), atol=1e-6)


def _band_ok(ma, mb):
    """Pixels where both masks agree and so do all 8 neighbours."""
    agree = ma == mb
    pad = np.pad(agree, 1, constant_values=True)
    ok = np.ones_like(agree)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= pad[1 + dy:1 + dy + agree.shape[0],
                      1 + dx:1 + dx + agree.shape[1]]
    return ok


def _compare(got, ref, got_mask, ref_mask, atol=1e-4):
    """Masks agree but for a thin band; images within atol outside it."""
    assert ref_mask.sum() > 300
    assert (got_mask != ref_mask).sum() <= max(3, int(5e-3 * ref_mask.sum()))
    ok = _band_ok(got_mask, ref_mask)
    np.testing.assert_allclose(got[ok], ref[ok], atol=atol)


@pytest.fixture(scope="module")
def scene():
    """The toy body posed slightly, with area-weighted vertex normals and
    random vertex colors, as (T, 3, 3) soups; an orbit camera."""
    from avatarcap_tpu.body.smpl import canonical_pose, smpl_forward
    from avatarcap_tpu.render.camera import gl_perspective_projection_matrix
    from avatarcap_tpu.tools.gen_synthetic import (_vertex_normal_tris,
                                                   orbit_extrinsics)
    params, _ = _toy_cano()
    pose = canonical_pose().copy()
    pose[6:] += np.random.RandomState(1).uniform(
        -0.2, 0.2, pose.size - 6).astype(np.float32)
    v = np.asarray(smpl_forward(params, jnp.asarray(pose),
                                jnp.zeros(10)).vertices)
    faces = params.faces
    res = 96
    extr = orbit_extrinsics(0.5 * (v.max(0) + v.min(0)), 1, 5)
    proj = gl_perspective_projection_matrix(5 * res, 5 * res, res / 2,
                                            res / 2, res, res)
    colors = np.random.RandomState(2).uniform(
        0, 1, (len(faces), 3, 3)).astype(np.float32)
    return dict(v=v, tris=v[faces].astype(np.float32),
                normals=_vertex_normal_tris(v, faces), colors=colors,
                valid=np.ones(len(faces), bool), res=res,
                mvp=(proj @ extr).astype(np.float32),
                mv=extr.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shading", ["attribute", "phong", "phong_colored"])
def test_render_mesh_single_matches_jax(scene, shading):
    from avatarcap_tpu.render.visualize import render_mesh_single as jrender
    from avatarcap_tpu_torch.render.visualize import render_mesh_single
    s = scene
    colors = s["colors"] if shading == "phong_colored" else None
    mode = "phong" if shading.startswith("phong") else "attribute"
    ref = jrender(jnp.asarray(s["tris"]), jnp.asarray(s["normals"]),
                  jnp.asarray(s["valid"]), jnp.asarray(s["mvp"]),
                  jnp.asarray(s["mv"]), s["res"], s["res"], window=8,
                  shading=mode,
                  color_tris=None if colors is None else jnp.asarray(colors))
    got = render_mesh_single(_t(s["tris"]), _t(s["normals"]),
                             _t(s["valid"]), _t(s["mvp"]), _t(s["mv"]),
                             s["res"], s["res"], window=8, shading=mode,
                             color_tris=None if colors is None
                             else _t(colors))
    gm, rm = got.mask.numpy(), np.asarray(ref.mask)
    _compare(got.attrs.numpy(), np.asarray(ref.attrs), gm, rm)
    ok = _band_ok(gm, rm) & rm
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], atol=1e-5)
    assert bool(got.overflow) == bool(ref.overflow)


@pytest.mark.parametrize("shading", ["attribute", "phong"])
def test_render_cano_mesh_matches_jax(scene, shading):
    from avatarcap_tpu.render.camera import cano_front_back_mvp
    from avatarcap_tpu.render.visualize import render_cano_mesh as jrender
    from avatarcap_tpu_torch.render.visualize import render_cano_mesh
    s = scene
    center = (0.5 * (s["v"].max(0) + s["v"].min(0))).astype(np.float32)
    mats = cano_front_back_mvp(center)
    ref = jrender(jnp.asarray(s["tris"]), jnp.asarray(s["normals"]),
                  jnp.asarray(s["valid"]), *map(jnp.asarray, mats),
                  res=s["res"], window=8, shading=shading)
    got = render_cano_mesh(_t(s["tris"]), _t(s["normals"]), _t(s["valid"]),
                           *map(_t, mats), res=s["res"], window=8,
                           shading=shading)
    bg = 1.0 if shading == "phong" else 0.0
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        _compare(g, r, np.any(g != bg, -1), np.any(r != bg, -1))


@pytest.mark.parametrize("colored", [False, True])
def test_cano_interpolate_and_phong_match_jax(scene, colored):
    """The canonical index passes (the mirror pair) with their attribute
    layers (cano_interpolate) and Phong images (cano_phong)."""
    from avatarcap_tpu.render.camera import cano_front_back_mvp
    from avatarcap_tpu.render import visualize as jvis
    from avatarcap_tpu_torch.render import visualize as tvis
    s = scene
    center = (0.5 * (s["v"].max(0) + s["v"].min(0))).astype(np.float32)
    fmvp, fmv, bmvp, bmv = cano_front_back_mvp(center)
    colors = s["colors"] if colored else None
    jf, jb = jvis.cano_index_passes(
        jnp.asarray(s["tris"]), jnp.asarray(s["valid"]), jnp.asarray(fmvp),
        jnp.asarray(bmvp), res=s["res"], window=8)
    tf, tb = tvis.cano_index_passes(_t(s["tris"]), _t(s["valid"]),
                                    _t(fmvp), _t(bmvp), res=s["res"],
                                    window=8)
    ref = jvis.cano_interpolate(jf, jb, jnp.asarray(s["normals"]))
    got = tvis.cano_interpolate(tf, tb, _t(s["normals"]))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        _compare(g, r, np.any(g != 0, -1), np.any(r != 0, -1))
    ref = jvis.cano_phong(jf, jb, jnp.asarray(s["tris"]),
                          jnp.asarray(s["normals"]), jnp.asarray(fmv),
                          jnp.asarray(bmv),
                          None if colors is None else jnp.asarray(colors))
    got = tvis.cano_phong(tf, tb, _t(s["tris"]), _t(s["normals"]), _t(fmv),
                          _t(bmv), None if colors is None else _t(colors))
    _compare_phong_pair(got, ref)


def _live_inputs(scene, pad=100):
    """A padded soup in the capture's CaptureMesh layout and the live
    preview's model-views (rot_x -0.15, as the CLI)."""
    from avatarcap_tpu_torch.render.camera import calc_back_mv, calc_front_mv
    s = scene
    T = len(s["tris"])
    verts = np.concatenate([s["tris"].reshape(-1, 3),
                            np.zeros((3 * pad, 3), np.float32)])
    normals = np.concatenate([s["normals"].reshape(-1, 3),
                              np.zeros((3 * pad, 3), np.float32)])
    valid = np.arange(T + pad) < T
    colors = np.concatenate([s["colors"].reshape(-1, 3),
                             np.zeros((3 * pad, 3), np.float32)])
    fmv = calc_front_mv(s["v"], rot_x_angle=-0.15)
    bmv = calc_back_mv(s["v"], rot_x_angle=-0.15)
    return verts, normals, valid, colors, fmv, bmv


def _compare_phong_pair(got, ref):
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        _compare(g, r, np.any(g != 1.0, -1), np.any(r != 1.0, -1))


def test_render_live_mesh_matches_jax(scene):
    from avatarcap_tpu.render.camera import (gl_perspective_projection_matrix,
                                             real2gl_matrix)
    from avatarcap_tpu.render.visualize import render_live_mesh as jrender
    from avatarcap_tpu_torch.render.visualize import render_live_mesh
    verts, normals, valid, colors, fmv, bmv = _live_inputs(scene)
    proj = gl_perspective_projection_matrix(5000, 5000, 256, 256, 512, 512,
                                            gl_space=True)
    args = (verts.reshape(-1, 3, 3), normals.reshape(-1, 3, 3), valid)
    ref = jrender(*map(jnp.asarray, args), fmv, bmv, proj, real2gl_matrix(),
                  res=scene["res"], window=4,
                  color_tris=jnp.asarray(colors.reshape(-1, 3, 3)))
    got = render_live_mesh(*map(_t, args), fmv, bmv, proj, real2gl_matrix(),
                           res=scene["res"], window=4,
                           color_tris=_t(colors.reshape(-1, 3, 3)))
    _compare_phong_pair(got, ref)


@pytest.mark.parametrize("colored", [False, True])
def test_capture_render_live_matches_jax(scene, colored):
    """AvatarCapture.render_live (it reads only the capture's options) on
    a padded soup, with and without vertex colors."""
    from avatarcap_tpu.pipeline import capture as jcap
    from avatarcap_tpu_torch.pipeline import capture as tcap
    verts, normals, valid, colors, fmv, bmv = _live_inputs(scene)
    n = int(valid.sum())
    jself = types.SimpleNamespace(opt=jcap.CaptureOptions(
        render_res=scene["res"], raster_window=4))
    tself = types.SimpleNamespace(opt=tcap.CaptureOptions(
        render_res=scene["res"], raster_window=4))
    jmesh = jcap.CaptureMesh(jnp.asarray(verts), jnp.asarray(normals),
                             jnp.asarray(n), jnp.asarray(valid))
    tmesh = tcap.CaptureMesh(_t(verts), _t(normals), torch.tensor(n),
                             _t(valid))
    ref = jcap.AvatarCapture.render_live(
        jself, jmesh, jnp.asarray(fmv), jnp.asarray(bmv),
        colors=jnp.asarray(colors) if colored else None)
    got = tcap.AvatarCapture.render_live(
        tself, tmesh, fmv, bmv, colors=_t(colors) if colored else None)
    _compare_phong_pair(got, ref)


def test_normal2color_matches_jax():
    from avatarcap_tpu.render.visualize import normal2color as jn2c
    from avatarcap_tpu_torch.render.visualize import normal2color
    rs = np.random.RandomState(4)
    img = rs.standard_normal((32, 32, 3)).astype(np.float32)
    img[rs.uniform(size=(32, 32)) < 0.3] = 0.0
    np.testing.assert_allclose(normal2color(_t(img)).numpy(),
                               np.asarray(jn2c(jnp.asarray(img))),
                               atol=1e-6)


def test_stage_timer():
    """Stages accumulate per name, the timer is the stage hooks' callable,
    ``maybe`` with None is a no-op, and the report lists every stage."""
    from avatarcap_tpu_torch.utils.timers import StageTimer
    timer = StageTimer("cpu")
    for name in ("a", "b", "a"):
        with timer(name):
            torch.ones(10).sum()
    with StageTimer.maybe(timer, "c"):
        pass
    with StageTimer.maybe(None, "d"):
        pass
    assert set(timer.times) == {"a", "b", "c"}
    assert all(v >= 0.0 for v in timer.times.values())
    assert timer.total() == pytest.approx(sum(timer.times.values()))
    report = timer.report()
    assert all(k in report for k in ("a", "b", "c", "TOTAL"))


def test_stage_timer_names_are_process_frames():
    """The stage names a StageTimer records through process_frame are the
    frame's stages (the avatar-only frame, on the CPU f32 path)."""
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.tools.bench_workloads import (
        build_capture_grid, random_avatar, toy_avatar_statics)
    from avatarcap_tpu_torch.utils.timers import StageTimer
    params, statics, v = toy_avatar_statics(dense=False)
    grid, _ = build_capture_grid(statics, (24, 24, 16))
    gen = torch.Generator().manual_seed(0)
    capture = AvatarCapture(
        random_avatar(gen), statics, grid,
        options=CaptureOptions(max_tris=1 << 13, max_active=1 << 12,
                               refine_capacity=1 << 14, render_res=64,
                               use_fused_query=False),
        device="cpu")
    item = {"live_smpl_v": v,
            "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                          (params.num_joints, 1, 1)),
            "smpl_pos_map": (0.1 * torch.randn((64, 64, 6), generator=gen)
                             ).numpy()}
    timer = StageTimer("cpu")
    capture.process_frame(item, w_recon=False, timer=timer)
    assert list(timer.times) == ["geometry", "skinning", "cano_layers"]


def test_chamfer_distance_matches_jax():
    from avatarcap_tpu.utils.metrics import chamfer_distance as jchamfer
    from avatarcap_tpu_torch.utils.metrics import chamfer_distance
    rs = np.random.RandomState(5)
    a = rs.uniform(-1, 1, (3000, 3)).astype(np.float32)
    b = rs.uniform(-1, 1, (2000, 3)).astype(np.float32)
    for squared in (False, True):
        ref = float(jchamfer(jnp.asarray(a), jnp.asarray(b), squared))
        got = float(chamfer_distance(_t(a), _t(b), squared))
        assert abs(got - ref) <= 1e-6, (squared, got, ref)


def test_mesh_chamfer(scene):
    """Two samplings of one padded soup are closer than the soup and its
    copy shifted by 5 cm along each axis; the padding is never sampled
    (it sits at the origin, inside the body)."""
    from avatarcap_tpu_torch.utils.metrics import mesh_chamfer
    verts, _, valid, _, _, _ = _live_inputs(scene)
    soup, n = _t(verts), int(valid.sum())
    same = float(mesh_chamfer(soup, n, soup, n, samples=5000))
    shifted = float(mesh_chamfer(soup, n, soup + 0.05, n, samples=5000))
    assert same < 0.5 * shifted, (same, shifted)
