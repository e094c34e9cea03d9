"""The slice as a whole: the port's geometry frames against the JAX frame
on tests/capture_cases.py's fixture: the avatar-only frame,
process_frame(item, w_recon=False, w_nerf=False), on the f32 module path
and through the kernels, and the entry points' refusals.

With use_fused_query=False both sides run the f32 module path and
compare tightly: equal triangle counts and overflow, slot-wise vertices
and normals, the live meshes, and the canonical images outside the
raster's eps-slack boundary band. With use_fused_query=True the port runs
the kernels' plain versions (bf16), held against JAX stages whose grid
queries run the Pallas kernels in interpret mode through the JAX
package's own stage functions, at kernel-level tolerances. The production
frame's ReconNet is held in tests/test_torch_capture_recon.py, the
textured frames in tests/test_torch_capture_color.py.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from capture_cases import (OPTS, _close_mostly, _compare_images, _np,
                           _port_capture, env)  # noqa: F401

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
