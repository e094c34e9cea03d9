"""The capture frames' shared fixture and comparers, used by
tests/test_torch_capture.py (the geometry frames),
tests/test_torch_capture_recon.py (the production frame's ReconNet),
tests/test_torch_capture_color.py (the textured frames' color stages) and
tests/test_torch_streaming.py.

The fixture is tests/test_capture.py's (48 x 48 x 32 grid, 128^2
renders, max_tris 1<<15, max_active 1<<13, fusion_iters 4), rebuilt
here: the avatar-only frame's inputs, and the production frame's, with a
ReconNet from PRNGKey(1), the bench camera and inferred normal map at
128^2 and neck vertex 0. The geometry head's fc1_kernel gets numpy-drawn
O(0.1) values on both sides, and the ReconNet decoder head O(1) values,
so both iso-surfaces are real crossings and not init noise.

The comparers hold slot-wise vertices and normals (ascending compaction
makes slots comparable) and the canonical images outside the raster's
eps-slack boundary band.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_toy_smpl_params

OPTS = dict(max_tris=1 << 15, max_active=1 << 13, render_res=128,
            raster_window=6, fusion_iters=4, n_samples=4)


@pytest.fixture(scope="module")
def env():
    from avatarcap_tpu.body.smpl import smpl_forward, canonical_pose
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.ops.inside import points_inside_mesh
    from avatarcap_tpu.ops.knn import knn
    from avatarcap_tpu.pipeline.avatar import AvatarStatics
    from avatarcap_tpu.pipeline.capture import CaptureGrid

    params = make_toy_smpl_params()
    cano = smpl_forward(params, jnp.asarray(canonical_pose()),
                        jnp.asarray(np.zeros(10, np.float32)))
    v = np.asarray(cano.vertices)
    lo = v.min(0) - np.array([0.05, 0.05, 0.15], np.float32)
    hi = v.max(0) + np.array([0.05, 0.05, 0.15], np.float32)
    wv = np.zeros((16, 16, 16, params.num_joints), np.float32)
    wv[..., 0] = 1.0
    statics_np = dict(weight_volume=wv, cano_smpl_vertices=v,
                      smpl_skinning_weights=np.asarray(params.weights),
                      cano_bounds=np.stack([lo, hi]),
                      cano_smpl_center=(0.5 * (lo + hi)).astype(np.float32))

    vol_res = (48, 48, 32)
    lin = [np.linspace(0, 1, r, dtype=np.float32) for r in vol_res]
    g = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    pts = g * (hi - lo) + lo
    d2, _ = knn(jnp.asarray(pts), cano.vertices, k=1)
    valid_flag = np.asarray(d2[:, 0] < 0.1 ** 2)
    inside = np.asarray(points_inside_mesh(jnp.asarray(pts),
                                           jnp.asarray(v[params.faces])))
    prior = np.where(valid_flag, 0.0,
                     2.0 * inside.astype(np.float32) - 1.0).astype(np.float32)
    idx = np.where(valid_flag)[0].astype(np.int32)
    pad = (-len(idx)) % 4096
    grid_np = dict(valid_pts=np.concatenate([pts[idx],
                                             np.zeros((pad, 3), np.float32)]),
                   valid_idx=np.pad(idx, (0, pad), constant_values=len(pts)),
                   prior_volume=prior)

    module = GeoTexAvatar(if_type="sdf")
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
                             jnp.zeros((1, 128, 128, 6)),
                             jnp.asarray(statics_np["cano_smpl_center"])[None]))
    rs = np.random.RandomState(11)
    variables["params"]["cano_template"]["geo_mlp"]["fc1_kernel"] = \
        rs.uniform(-0.1, 0.1, (128, 2)).astype(np.float32)

    item = {
        "live_smpl_v": v.astype(np.float32),
        "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                      (params.num_joints, 1, 1)),
        "smpl_pos_map": (rs.standard_normal((128, 128, 6)) * 0.1
                         ).astype(np.float32),
    }
    # a non-identity pose so the live mesh differs from the canonical one
    item["cano2live_jnt_mats"][:, :3, 3] = rs.uniform(-0.05, 0.05,
                                                      (params.num_joints, 3))
    # the production frame's inputs: the bench camera at 128^2
    from avatarcap_tpu.models.recon import ReconNetwork
    from avatarcap_tpu_torch.tools.bench_workloads import bench_camera
    item["w2c_RT"], camera, inferred = bench_camera(128)
    recon = ReconNetwork()
    recon_vars = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(recon.init)(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 6)),
                            jnp.zeros((1, 8, 3)), jnp.zeros((1, 3))))
    recon_vars["params"]["image_decoder"]["fc3"]["kernel"] = \
        rs.uniform(-1.0, 1.0, (128, 1)).astype(np.float32)
    jstatics = AvatarStatics(**{k: jnp.asarray(a)
                                for k, a in statics_np.items()})
    jgrid = CaptureGrid(jnp.asarray(grid_np["valid_pts"]),
                        jnp.asarray(grid_np["valid_idx"]),
                        jnp.asarray(grid_np["prior_volume"]), vol_res)
    return dict(module=module, variables=variables, jstatics=jstatics,
                jgrid=jgrid, statics_np=statics_np, grid_np=grid_np,
                vol_res=vol_res, item=item, recon=recon,
                recon_vars=recon_vars,
                recon_kw=dict(inferred_normal=inferred, neck_vertex_idx=0,
                              camera=camera))


def _port_capture(env, fused, tex_variables=None, **extra):
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureGrid,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.weights import (avatar_state_dict_from_jax,
                                             recon_state_dict_from_jax)
    port = GeoTexAvatar()
    port.load_state_dict(avatar_state_dict_from_jax(env["variables"]))
    recon = ReconNetwork()
    recon.load_state_dict(recon_state_dict_from_jax(env["recon_vars"]))
    statics = AvatarStatics(**{k: torch.as_tensor(np.array(a))
                               for k, a in env["statics_np"].items()})
    g = env["grid_np"]
    grid = CaptureGrid(torch.as_tensor(g["valid_pts"]),
                       torch.as_tensor(g["valid_idx"]),
                       torch.as_tensor(g["prior_volume"]), env["vol_res"])
    tex = None
    if tex_variables is not None:
        tex = GeoTexAvatar()
        tex.load_state_dict(avatar_state_dict_from_jax(tex_variables))
    opts = CaptureOptions(use_fused_query=fused, **OPTS, **extra)
    return AvatarCapture(port, statics, grid, recon=recon, tex_avatar=tex,
                         options=opts, device="cpu")


def _np(x):
    return np.asarray(x)


def _image_band_mask(ma, mb):
    """Pixels where both masks agree and so do all 8 neighbours: the
    comparison region outside the eps-slack boundary band."""
    agree = (ma == mb)
    pad = np.pad(agree, 1, constant_values=True)
    ok = np.ones_like(agree)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= pad[1 + dy:1 + dy + agree.shape[0],
                      1 + dx:1 + dx + agree.shape[1]]
    return ok


def _close_mostly(a, b, tight, loose, frac=0.99):
    """Every element within `loose`, and `frac` of the rows within
    `tight`."""
    np.testing.assert_allclose(a, b, atol=loose)
    rows = np.all(np.abs(a - b) <= tight, axis=-1)
    assert rows.mean() >= frac, rows.mean()


def _compare_images(got, ref, atol, loose):
    gm = np.abs(got["front_avatar_normal"].numpy()).sum(-1) > 0
    rm = np.abs(_np(ref["front_avatar_normal"])).sum(-1) > 0
    assert rm.sum() > 200
    assert (gm != rm).sum() <= max(3, int(2e-3 * rm.sum()))
    for key in ("front_avatar_normal", "back_avatar_normal"):
        a, b = got[key].numpy(), _np(ref[key])
        ma, mb = np.abs(a).sum(-1) > 0, np.abs(b).sum(-1) > 0
        ok = _image_band_mask(ma, mb)
        _close_mostly(a[ok], b[ok], atol, loose)
    for side in (0, 1):
        a = got["cano_phong"][side].numpy()
        b = _np(ref["cano_phong"][side])
        ma, mb = np.any(a != 1.0, -1), np.any(b != 1.0, -1)
        ok = _image_band_mask(ma, mb)
        _close_mostly(a[ok], b[ok], atol, loose)


def _compare_mesh(gm, rm, tight_v=1e-5, loose_v=2e-4):
    """Equal counts and overflow, then slot-wise (see the avatar-only
    test for the bf16 corner values behind `loose`)."""
    n = int(rm.num_tris)
    assert int(gm.num_tris) == n > 100
    assert bool(gm.overflow) == bool(_np(rm.overflow))
    _close_mostly(gm.vertices.numpy(), _np(rm.vertices), tight_v, loose_v)
    _close_mostly(gm.normals.numpy(), _np(rm.normals), 1e-4, 2e-2)
