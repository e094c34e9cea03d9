"""The textured frames (w_nerf=True) against the JAX frame on
tests/capture_cases.py's fixture: NeRF vertex colors from a texture
avatar (the same weights with a denser geometry head, so the color rays
carry O(0.1) colors), the avatar-only frame with one ray per soup slot,
and the production frame with the soups deduped and the ReconNet colors
transferred by nearest neighbour or integrated directly; the fused color
stages and the fused textured frame against the f32 ones.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from avatarcap_tpu_torch import kernels
from capture_cases import (OPTS, _close_mostly, _compare_mesh, _np,
                           _port_capture, env)  # noqa: F401


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
    cap32, res, feat = port_nerf_frame
    cap = _port_capture(env, fused=True, tex_variables=tex_variables,
                        recon_color_mode="direct", **NERF_OPTS, **flags)
    before = (kernels.launches["k3"], kernels.launches["k1"])
    with torch.inference_mode():
        got, ovf, uniq = cap.nerf_color_stage(feat, res["cano_mesh"])
        ref, ref_ovf, _ = cap32.nerf_color_stage(feat, res["cano_mesh"])
        rgot, _ = cap.color_transfer_stage(feat, res["recon_mesh"], None,
                                           None, uniq)
    assert (kernels.launches["k3"], kernels.launches["k1"]) == before
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
    _, ref, _ = port_nerf_frame
    cap = _port_capture(env, fused=True, tex_variables=tex_variables,
                        recon_color_mode="direct", **NERF_OPTS)
    counts = (kernels.launches["k3"], kernels.launches["k2"],
              kernels.launches["k1"])
    got = cap.process_frame(env["item"], w_recon=True, w_nerf=True,
                            **env["recon_kw"])
    assert (kernels.launches["k3"], kernels.launches["k2"],
            kernels.launches["k1"]) == counts
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
