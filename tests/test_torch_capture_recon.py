"""The production frame, process_frame(item, w_recon=True,
w_nerf=False), against the JAX frame on tests/capture_cases.py's fixture:
the f32 module path on both sides, and the recon stage through K2's plain
version against the interpret-mode Pallas K2.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from avatarcap_tpu_torch import kernels
from capture_cases import (OPTS, _close_mostly, _compare_mesh,
                           _image_band_mask, _np, _port_capture,
                           env)  # noqa: F401


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
    before = kernels.launches["k2"]
    with torch.inference_mode():
        tfeat = cap.recon.get_feat_maps(torch.tensor(img))
        tvol, _ = cap.recon_volume(tfeat)
        gm = cap.recon_stage(torch.tensor(front), torch.tensor(back))
    assert kernels.launches["k2"] == before            # CPU: plain version
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
