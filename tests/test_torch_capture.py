"""The slice as a whole: the port's capture frames against the JAX frame
on the fixture of tests/test_capture.py (48 x 48 x 32 grid, 128^2 renders,
max_tris 1<<15, max_active 1<<13, fusion_iters 4), rebuilt here: the
avatar-only frame, process_frame(item, w_recon=False, w_nerf=False), and
the production frame, process_frame(item, w_recon=True, w_nerf=False),
with a ReconNet from PRNGKey(1), the bench camera and inferred normal map
at 128^2 and neck vertex 0.

The geometry head's fc1_kernel gets numpy-drawn O(0.1) values on both
sides, and the ReconNet decoder head O(1) values, so both iso-surfaces
are real crossings and not init noise. With use_fused_query=False both
sides run the f32 module path and compare tightly: equal triangle counts
and overflow, slot-wise vertices and normals (ascending compaction makes
slots comparable), the live meshes, and the canonical images outside the
raster's eps-slack boundary band. With use_fused_query=True the port runs
the kernels' plain versions (bf16), held against JAX stages whose grid
queries run the Pallas kernels in interpret mode through the JAX
package's own stage functions, at kernel-level tolerances.

The textured frames (w_nerf=True) add NeRF vertex colors from a texture
avatar (the same weights with a denser geometry head, so the color rays
carry O(0.1) colors): the avatar-only frame with one ray per soup slot,
and the production frame with the soups deduped and the ReconNet colors
transferred by nearest neighbour or integrated directly.
"""

import dataclasses

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


@pytest.fixture(scope="module")
def jax_recon_frames(env):
    """The JAX production frame on the f32 path, per set of extra
    options, computed once for the module's tests."""
    from avatarcap_tpu.pipeline.capture import AvatarCapture, CaptureOptions
    frames = {}

    def get(**extra):
        key = tuple(sorted(extra.items()))
        if key not in frames:
            jcap = AvatarCapture(
                env["module"], env["variables"], env["jstatics"],
                env["jgrid"], recon=env["recon"],
                recon_vars=env["recon_vars"],
                options=CaptureOptions(use_fused_query=False, **OPTS,
                                       **extra))
            frames[key] = jcap.process_frame(env["item"], w_recon=True,
                                             w_nerf=False, **env["recon_kw"])
        return frames[key]
    return get


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


@pytest.mark.parametrize("extra", [
    {},                                                  # the main path
    dict(hierarchical_query=False, skinning_mode="knn"),
    dict(normal_mode="mc_edge"),
    dict(normal_mode="sobel_sample")],
    ids=["hierarchical-volume_skinning", "flat-knn_skinning",
         "mc_edge_normals", "sobel_sample_normals"])
def test_frame_f32_path_matches_jax(env, extra):
    from avatarcap_tpu.pipeline.capture import AvatarCapture, CaptureOptions
    jcap = AvatarCapture(env["module"], env["variables"], env["jstatics"],
                         env["jgrid"],
                         options=CaptureOptions(use_fused_query=False,
                                                **OPTS, **extra))
    ref = jcap.process_frame(env["item"], w_recon=False, w_nerf=False)
    got = _port_capture(env, fused=False, **extra).process_frame(
        env["item"], w_recon=False, w_nerf=False)

    rm, gm = ref["cano_mesh"], got["cano_mesh"]
    n = int(rm.num_tris)
    assert int(gm.num_tris) == n > 100
    assert bool(got["overflow"]) == bool(_np(ref["overflow"]))
    assert bool(gm.overflow) == bool(_np(rm.overflow))
    # slot-wise. The f32 fields agree to ~1e-6, but the extractor (JAX
    # and port alike) carries the cube corner values as bf16 for the
    # within-edge interpolation, so a 1e-6 difference can flip one
    # corner's bf16 rounding: that vertex moves along its edge by at most
    # 2^-8 of a voxel (~1e-4 m here) and its normal by ~2^-8. All other
    # slots agree to float32 rounding.
    for a, b, tight, loose in (
            (gm.vertices, rm.vertices, 1e-5, 2e-4),
            (gm.normals, rm.normals, 1e-4, 2e-2),
            (got["live_mesh"].vertices, ref["live_mesh"].vertices, 1e-5,
             2e-4),
            (got["live_mesh"].normals, ref["live_mesh"].normals, 1e-4,
             2e-2)):
        _close_mostly(a.numpy(), _np(b), tight, loose)
    _compare_images(got, ref, atol=1e-4, loose=2e-2)


def test_frame_fused_path_matches_jax_kernel(env):
    """Port K1 (plain version on the CPU) against a JAX frame whose grid
    query runs the interpret-mode Pallas K1 (the JAX capture disables the
    fused path off the TPU, so the test assembles that frame from the JAX
    package's own stage functions)."""
    from jax.experimental.pallas import tpu as pltpu
    from avatarcap_tpu.ops.pallas_query import warp_template_query_fused
    from avatarcap_tpu.pipeline.avatar import (compute_pose_features,
                                               grid_pose_features,
                                               pack_fused_query_weights)
    from avatarcap_tpu.pipeline.capture import (CaptureOptions, _extract_mesh,
                                                build_grid_hierarchy,
                                                hierarchical_volume)
    o = CaptureOptions(**OPTS)
    st = env["jstatics"]
    g = build_grid_hierarchy(env["jgrid"], st.cano_bounds)
    packed = pack_fused_query_weights(env["variables"])
    feat, _ = compute_pose_features(env["module"], env["variables"],
                                    jnp.asarray(env["item"]["smpl_pos_map"])[None])
    cols = grid_pose_features(feat, st, g.vol_res, dtype=jnp.bfloat16,
                              columns=True)
    Z = g.vol_res[2]

    def vf(pts, fidx):
        return warp_template_query_fused(packed["offset"], packed["template"],
                                         pts, cols[fidx // Z])["occ"][:, 0]

    with pltpu.force_tpu_interpret_mode():
        vol, q_ovf = hierarchical_volume(vf, g, st.cano_bounds, g.c_prior,
                                         g.prior_volume, o.iso_value,
                                         o.hier_alpha, o.refine_capacity)
    ref = _extract_mesh(vol, g, st.cano_bounds, o.iso_value, o.max_tris,
                        o.max_active, o.normal_mode)

    cap = _port_capture(env, fused=True)
    got = cap.process_frame(env["item"], w_recon=False, w_nerf=False)
    gm = got["cano_mesh"]
    n = int(ref.num_tris)
    # bf16 kernel noise may move an iso crossing across a grid node in a
    # handful of cells: counts agree to 0.5%, and the meshes' shared
    # prefix of slots stays within a bf16-level vertex tolerance
    assert abs(int(gm.num_tris) - n) <= max(2, n // 200)
    assert bool(gm.overflow) == bool(_np(ref.overflow) | _np(q_ovf))
    # compare the occupancy volumes the meshes come from
    from avatarcap_tpu_torch.pipeline.capture import hierarchical_volume as thv
    from avatarcap_tpu_torch.pipeline.avatar import (
        compute_pose_features as tpf, grid_pose_features as tgpf)
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    with torch.inference_mode():
        tfeat = tpf(cap.avatar, torch.as_tensor(env["item"]["smpl_pos_map"])[None])
        tcols = tgpf(tfeat, cap.statics, cap.grid.vol_res,
                     dtype=torch.bfloat16, columns=True)
        pk = cap.packed_query
        tvol, _ = thv(lambda p, f: warp_template_query(
            pk["offset"], pk["template"], p, tcols[f.long() // Z])["occ"][:, 0],
            cap.grid, cap.statics.cano_bounds, cap.grid.c_prior,
            cap.grid.prior_volume, o.iso_value, o.hier_alpha,
            o.refine_capacity)
    np.testing.assert_allclose(tvol.numpy(), _np(vol), atol=5e-3)
    k = min(n, int(gm.num_tris))
    same = np.all(np.abs(gm.vertices.numpy()[:3 * k] - _np(ref.vertices)[:3 * k])
                  < 2e-3, axis=-1)
    assert same.mean() > 0.95


def test_unported_paths_raise(env):
    """A w_recon frame without its inputs is refused with the reason, and
    so is a normal mode that neither package has."""
    cap = _port_capture(env, fused=False)
    with pytest.raises(ValueError, match="inferred_normal"):
        cap.process_frame(env["item"], w_recon=True)
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    with pytest.raises(ValueError, match="normal_mode"):
        AvatarCapture(cap.avatar, cap.statics, cap.grid,
                      options=dataclasses.replace(cap.opt,
                                                  normal_mode="sobel"),
                      device="cpu")


def test_entry_point_needs_a_card_unless_cpu_is_asked(env, monkeypatch):
    from avatarcap_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _compare_mesh(gm, rm, tight_v=1e-5, loose_v=2e-4):
    """Equal counts and overflow, then slot-wise (see the avatar-only
    test for the bf16 corner values behind `loose`)."""
    n = int(rm.num_tris)
    assert int(gm.num_tris) == n > 100
    assert bool(gm.overflow) == bool(_np(rm.overflow))
    _close_mostly(gm.vertices.numpy(), _np(rm.vertices), tight_v, loose_v)
    _close_mostly(gm.normals.numpy(), _np(rm.normals), 1e-4, 2e-2)


@pytest.mark.parametrize("extra", [
    {},                                                  # the main path
    dict(hierarchical_query=False, skinning_mode="knn",
         integrate_manner="cover")],
    ids=["hierarchical-volume_skinning-merge", "flat-knn_skinning-cover"])
def test_frame_w_recon_f32_path_matches_jax(env, jax_recon_frames, extra):
    """The production frame, f32 module path on both sides: lifted image
    normals, merged normals, the ReconNet mesh and its live copy, and the
    frame's overflow bit. On this fixture the lifted normals cover ~100
    canonical pixels in thin strips, which the merge's 3-step erosion
    removes, so the merge keeps the avatar normals on both sides;
    tests/test_torch_fusion.py holds the optimisation itself."""
    ref = jax_recon_frames(**extra)
    got = _port_capture(env, fused=False, **extra).process_frame(
        env["item"], w_recon=True, w_nerf=False, **env["recon_kw"])
    assert bool(got["overflow"]) == bool(_np(ref["overflow"]))
    _compare_mesh(got["cano_mesh"], ref["cano_mesh"])
    for key in ("front_image_normal", "front_merged_normal"):
        a, b = got[key].numpy(), _np(ref[key])
        ma, mb = np.abs(a).sum(-1) > 0, np.abs(b).sum(-1) > 0
        assert mb.sum() > 50, key
        assert (ma != mb).sum() <= max(3, int(5e-3 * mb.sum())), key
        ok = _image_band_mask(ma, mb)
        _close_mostly(a[ok], b[ok], 1e-4, 2e-2)
    rm, gm = ref["recon_mesh"], got["recon_mesh"]
    _compare_mesh(gm, rm)
    _close_mostly(got["live_recon_mesh"].vertices.numpy(),
                  _np(ref["live_recon_mesh"].vertices), 1e-5, 2e-4)
    _close_mostly(got["live_recon_mesh"].normals.numpy(),
                  _np(ref["live_recon_mesh"].normals), 1e-4, 2e-2)


@pytest.mark.parametrize("hierarchical", [True, False],
                         ids=["hierarchical", "flat"])
def test_recon_fused_path_matches_jax_kernel(env, jax_recon_frames,
                                             hierarchical):
    """The port's recon stage through K2 (plain version on the CPU)
    against a JAX recon stage whose grid query runs the interpret-mode
    Pallas K2, both fed the JAX frame's merged normals; the coarse-to-fine
    query and the flat one over every near-body node."""
    from jax.experimental.pallas import tpu as pltpu
    from avatarcap_tpu.models.recon import ReconNetwork
    from avatarcap_tpu.ops.pallas_query import (pack_recon_weights,
                                                recon_decode_fused)
    from avatarcap_tpu.pipeline.avatar import grid_pose_features
    from avatarcap_tpu.pipeline.capture import (CaptureOptions, _extract_mesh,
                                                build_grid_hierarchy,
                                                hierarchical_volume)
    from avatarcap_tpu_torch.ops.fused_query import recon_decode
    o = CaptureOptions(**OPTS)
    st = env["jstatics"]
    g = build_grid_hierarchy(env["jgrid"], st.cano_bounds)
    frame = jax_recon_frames()
    front = _np(frame["front_merged_normal"])
    back = _np(frame["back_avatar_normal"])
    img = np.concatenate([front, back], -1)[None]
    feat = env["recon"].apply(env["recon_vars"], jnp.asarray(img),
                              method=ReconNetwork.get_feat_maps)
    cols = grid_pose_features(feat, st, g.vol_res, columns=True)
    packed = pack_recon_weights(env["recon_vars"]["params"]["image_decoder"])
    Z = g.vol_res[2]

    def vfr(pts, fidx):
        z = pts[:, 2] - st.cano_smpl_center[2]
        return recon_decode_fused(
            packed, jnp.concatenate([cols[fidx // Z], z[:, None]], -1))

    prior01 = 0.5 * (g.prior_volume + 1.0)
    with pltpu.force_tpu_interpret_mode():
        if hierarchical:
            vol, q_ovf = hierarchical_volume(
                vfr, g, st.cano_bounds, 0.5 * (g.c_prior + 1.0), prior01,
                0.5, o.hier_alpha,
                o.recon_refine_capacity or o.refine_capacity)
        else:
            pf = grid_pose_features(feat, st, g.vol_res, g.valid_idx)
            z = g.valid_pts[:, 2] - st.cano_smpl_center[2]
            vol = prior01.at[g.valid_idx].set(
                recon_decode_fused(packed, jnp.concatenate(
                    [pf, z[:, None]], -1)), mode="drop")
            q_ovf = np.zeros((), bool)
    ref = _extract_mesh(vol, g, st.cano_bounds, 0.5, o.max_tris,
                        o.max_active, o.normal_mode)

    cap = _port_capture(env, fused=True, hierarchical_query=hierarchical)
    before = recon_decode.launches
    with torch.inference_mode():
        tfeat = cap.recon.get_feat_maps(torch.tensor(img))
        tvol, _ = cap.recon_volume(tfeat)
        gm = cap.recon_stage(torch.tensor(front), torch.tensor(back))
    assert recon_decode.launches == before            # CPU: plain version
    # K2's bf16 noise (see tests/test_torch_recon.py) on the occupancy
    np.testing.assert_allclose(tvol.numpy(), _np(vol), atol=5e-3)
    # ... may move an iso crossing across a grid node in a handful of
    # cells: counts agree to 0.5%, the shared prefix of slots mostly
    n = int(ref.num_tris)
    assert n > 100
    assert abs(int(gm.num_tris) - n) <= max(2, n // 200)
    assert bool(gm.overflow) == bool(_np(ref.overflow) | _np(q_ovf))
    k = min(n, int(gm.num_tris))
    same = np.all(np.abs(gm.vertices.numpy()[:3 * k]
                         - _np(ref.vertices)[:3 * k]) < 2e-3, axis=-1)
    assert same.mean() > 0.95


# unique-vertex capacities of the textured frames: the fixture's soups have
# ~16k avatar and ~5k ReconNet triangles, so ~8k and ~2.5k unique vertices
NERF_OPTS = dict(nerf_unique_capacity=1 << 14, recon_unique_capacity=1 << 13)


@pytest.fixture(scope="module")
def tex_variables(env):
    """The texture avatar: the geometry avatar's weights with the density
    row of the geometry head drawn from numpy (U(+-1) weights, bias 4)."""
    variables = jax.tree.map(np.copy, env["variables"])
    geo = variables["params"]["cano_template"]["geo_mlp"]
    rs = np.random.RandomState(12)
    geo["fc1_kernel"][:, 1] = rs.uniform(-1.0, 1.0, 128).astype(np.float32)
    geo["fc1_bias"] = np.array([0.0, 4.0], np.float32)
    return variables


@pytest.fixture(scope="module")
def jax_nerf_frames(env, tex_variables):
    """JAX textured frames on the f32 path (the JAX capture runs the NeRF
    colors through render_rays off the TPU), computed once per case."""
    from avatarcap_tpu.pipeline.capture import AvatarCapture, CaptureOptions
    frames = {}

    def get(w_recon, **extra):
        key = (w_recon,) + tuple(sorted(extra.items()))
        if key not in frames:
            jcap = AvatarCapture(
                env["module"], env["variables"], env["jstatics"],
                env["jgrid"], recon=env["recon"],
                recon_vars=env["recon_vars"], avatar_tex_vars=tex_variables,
                options=CaptureOptions(use_fused_query=False, **OPTS,
                                       **extra))
            kw = env["recon_kw"] if w_recon else {}
            frames[key] = jcap.process_frame(env["item"], w_recon=w_recon,
                                             w_nerf=True, **kw)
        return frames[key]
    return get


def _valid_slots(mesh):
    return np.repeat(_np(mesh.valid), 3)


def _compare_colors(got, ref, mesh):
    """Colors of the valid soup slots: within 1e-4 on 99% of them and 2e-2
    on all (the bf16 corner values of the extractor move a few vertices,
    and with them their rays, by up to 2^-8 of a voxel)."""
    valid = _valid_slots(mesh)
    assert valid.sum() > 300
    a, b = got.numpy()[valid], _np(ref)[valid]
    assert np.abs(b).max() > 0.05, "degenerate colors"
    _close_mostly(a, b, 1e-4, 2e-2)
    assert not got.numpy()[~valid].any()


def _shared_edges_share_colors(colors, mesh):
    ids = mesh.edge_ids.numpy()
    valid = _valid_slots(mesh) & (ids >= 0)
    ids, c = ids[valid], colors.numpy()[valid]
    order = np.argsort(ids, kind="stable")
    ids, c = ids[order], c[order]
    first = np.r_[True, ids[1:] != ids[:-1]]
    group_first = c[np.maximum.accumulate(np.where(first, np.arange(len(ids)),
                                                   0))]
    assert first.sum() < 0.5 * len(ids)             # vertices are shared
    np.testing.assert_array_equal(c, group_first)


@pytest.mark.parametrize("case", [
    dict(w_recon=False),                                     # per slot
    dict(w_recon=True, recon_color_mode="nn", **NERF_OPTS),
    dict(w_recon=True, recon_color_mode="direct", **NERF_OPTS)],
    ids=["avatar_only-per_slot", "deduped-nn", "deduped-direct"])
def test_frame_w_nerf_f32_path_matches_jax(env, tex_variables,
                                           jax_nerf_frames, case):
    """The textured frames on the f32 path: the same meshes and overflow
    bit as the JAX frame, and the vertex colors of every valid slot."""
    extra = dict(case)
    w_recon = extra.pop("w_recon")
    ref = jax_nerf_frames(w_recon, **extra)
    kw = env["recon_kw"] if w_recon else {}
    got = _port_capture(env, fused=False, tex_variables=tex_variables,
                        **extra).process_frame(env["item"], w_recon=w_recon,
                                               w_nerf=True, **kw)
    assert bool(got["overflow"]) == bool(_np(ref["overflow"]))
    _compare_mesh(got["cano_mesh"], ref["cano_mesh"])
    _compare_colors(got["avatar_colors"], ref["avatar_colors"],
                    ref["cano_mesh"])
    if not w_recon:
        assert got["cano_mesh"].edge_ids is None
        return
    _compare_mesh(got["recon_mesh"], ref["recon_mesh"])
    _compare_colors(got["recon_colors"], ref["recon_colors"],
                    ref["recon_mesh"])
    _shared_edges_share_colors(got["avatar_colors"], got["cano_mesh"])
    _shared_edges_share_colors(got["recon_colors"], got["recon_mesh"])


@pytest.fixture(scope="module")
def port_nerf_frame(env, tex_variables):
    """The port's textured production frame on the f32 path (direct
    ReconNet colors) and its pose feature map."""
    from avatarcap_tpu_torch.pipeline.avatar import compute_pose_features
    cap = _port_capture(env, fused=False, tex_variables=tex_variables,
                        recon_color_mode="direct", **NERF_OPTS)
    res = cap.process_frame(env["item"], w_recon=True, w_nerf=True,
                            **env["recon_kw"])
    with torch.inference_mode():
        feat = compute_pose_features(
            cap.avatar, torch.as_tensor(env["item"]["smpl_pos_map"])[None])
    return cap, res, feat


@pytest.mark.parametrize("flags", [
    {},                                                   # K3
    dict(near_flag_mode="knn"),
    dict(nerf_feat_mode="exact"),
    dict(near_flag_mode="volume", near_flag_voxel=0.01)],
    ids=["k3", "k1-lerp-knn", "k1-exact-ray", "k1-lerp-volume"])
def test_color_stages_fused_match_f32(env, tex_variables, port_nerf_frame,
                                      flags):
    """The fused color stages (plain K3, or the chunked body through plain
    K1) against the f32 stages on the f32 frame's meshes, at K1's rgb
    tolerance (5e-3; measured ~4e-4). The pose features lerped between the
    ray's ends and the anchored near flags (4 anchors on the 4 samples)
    match the per-sample fetch and KNN here; the distance volume
    discretises the flag, so colors agree on most slots only."""
    from avatarcap_tpu_torch.ops.fused_query import (ray_color_query,
                                                     warp_template_query)
    cap32, res, feat = port_nerf_frame
    cap = _port_capture(env, fused=True, tex_variables=tex_variables,
                        recon_color_mode="direct", **NERF_OPTS, **flags)
    before = (ray_color_query.launches, warp_template_query.launches)
    with torch.inference_mode():
        got, ovf, uniq = cap.nerf_color_stage(feat, res["cano_mesh"])
        ref, ref_ovf, _ = cap32.nerf_color_stage(feat, res["cano_mesh"])
        rgot, _ = cap.color_transfer_stage(feat, res["recon_mesh"], None,
                                           None, uniq)
    assert (ray_color_query.launches, warp_template_query.launches) == before
    assert bool(ovf) == bool(ref_ovf)
    pairs = ((got, ref, res["cano_mesh"]),
             (rgot, res["recon_colors"], res["recon_mesh"]))
    for a, b, mesh in pairs:
        valid = _valid_slots(mesh)
        d = np.abs(a.numpy()[valid] - b.numpy()[valid]).max(-1)
        if flags.get("near_flag_mode") == "volume":
            assert (d < 5e-3).mean() > 0.9
        else:
            assert d.max() < 5e-3, d.max()


def test_frame_w_nerf_fused_path(env, tex_variables, port_nerf_frame):
    """The whole fused textured frame on the CPU (plain K1, K2 and K3):
    meshes within kernel noise of the f32 frame, colors on every valid
    slot, shared vertices one color, and no kernel launch counted."""
    from avatarcap_tpu_torch.ops.fused_query import (ray_color_query,
                                                     recon_decode,
                                                     warp_template_query)
    _, ref, _ = port_nerf_frame
    cap = _port_capture(env, fused=True, tex_variables=tex_variables,
                        recon_color_mode="direct", **NERF_OPTS)
    counts = (ray_color_query.launches, recon_decode.launches,
              warp_template_query.launches)
    got = cap.process_frame(env["item"], w_recon=True, w_nerf=True,
                            **env["recon_kw"])
    assert (ray_color_query.launches, recon_decode.launches,
            warp_template_query.launches) == counts
    for key, ckey in (("cano_mesh", "avatar_colors"),
                      ("recon_mesh", "recon_colors")):
        gm, rm = got[key], ref[key]
        n = int(rm.num_tris)
        assert abs(int(gm.num_tris) - n) <= max(2, n // 200)
        colors = got[ckey]
        valid = _valid_slots(gm)
        assert colors.shape == (valid.shape[0], 3)
        assert bool(torch.isfinite(colors).all())
        assert not colors.numpy()[~valid].any()
        # the same color statistics as the f32 frame's
        np.testing.assert_allclose(colors.numpy()[valid].mean(0),
                                   ref[ckey].numpy()[_valid_slots(rm)]
                                   .mean(0), atol=5e-3)
        _shared_edges_share_colors(colors, gm)


def test_color_transfer_brute_nn_matches_jax_knn(port_nerf_frame):
    """Without a deduped soup (recon_unique_capacity=0), every ReconNet
    slot takes the color of its nearest avatar slot: the JAX package's KNN
    on the same soups picks the same slots, so the same colors (up to
    near-equidistant slots)."""
    from avatarcap_tpu.ops.knn import knn
    cap, res, feat = port_nerf_frame
    cap.opt = dataclasses.replace(cap.opt, recon_unique_capacity=0)
    # the valid prefixes of both soups (slots past num_tris are zeros)
    n = 3 * int(res["cano_mesh"].num_tris)
    av, colors = res["cano_mesh"].vertices[:n], res["avatar_colors"][:n]
    recon = res["recon_mesh"]
    recon = recon._replace(vertices=recon.vertices[:3 * int(recon.num_tris)])
    got, ovf = cap.color_transfer_stage(feat, recon, av, colors, None)
    cap.opt = dataclasses.replace(cap.opt,
                                  recon_unique_capacity=NERF_OPTS[
                                      "recon_unique_capacity"])
    _, idx = knn(jnp.asarray(recon.vertices.numpy()), jnp.asarray(av.numpy()),
                 k=1, chunk=2048)
    ref = colors.numpy()[np.asarray(idx)[:, 0]]
    assert not bool(ovf) and got.shape == ref.shape
    same = np.all(got.numpy() == ref, axis=-1)
    assert same.mean() > 0.999
    assert np.abs(ref).max() > 0.05
