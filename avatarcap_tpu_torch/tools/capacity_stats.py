"""Measured capacity workloads of a capture setup (counterpart of
avatarcap_tpu/tools/capacity_stats.py).

Every static capacity of the capture frame (CaptureOptions) is walked
even when it is not full, and work past it is dropped and reported
through ``results["overflow"]``. The counts that size those capacities
(surface-crossing cubes, refined nodes, covered raster candidates,
triangles, unique soup vertices) are properties of the subject and the
options. This tool measures each one for one frame, through the frame's
own stage functions and value functions (the kernels on the card), and
reports it beside its capacity. It reads the counts back to the host: it
is a tool, not the frame.

Usage (the fitted full-size subject on the card; ``--small`` for the
48 x 48 x 32 one, ``--device cpu`` for the CPU)::

    python -m avatarcap_tpu_torch.tools.capacity_stats [--small] [--device D]

prints one JSON dict per row: {"row": name, "count", "capacity",
"headroom"}, then {"frame_overflow": ...}.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from avatarcap_tpu_torch.device import device_constant
from avatarcap_tpu_torch.ops.marching_cubes import _NTRIS256
from avatarcap_tpu_torch.pipeline.avatar import compute_pose_features
from avatarcap_tpu_torch.pipeline.capture import (_extract_mesh,
                                                  hierarchical_volume)
from avatarcap_tpu_torch.render.raster import rasterize_index

# The counts the JAX package recorded for its fitted, wrinkled bench body
# (avatarcap_tpu/tools/bench_workloads.py:355-365 and :381-384, measured
# there with its capacity_stats): the reference the port's fitted subject
# is held to.
JAX_BENCH_COUNTS = {
    "avatar_tris": 553_800, "avatar_active_cubes": 276_900,
    "avatar_refine_nodes": 1_800_000, "recon_tris": 246_000,
    "recon_active_cubes": 123_000, "recon_refine_nodes": 225_000,
    "cano_pair_candidates": 41_000, "live_pos_candidates": 24_000,
    "avatar_unique_vertices": 276_900, "recon_unique_vertices": 122_800}


def surface_counts(vol_flat: torch.Tensor, vol_res, iso: float):
    """(active cubes, triangles) of marching_tets on the volume, before
    any capacity: a cube is active when its corners straddle ``iso``
    (marching_tets' own test), and it emits its case's triangle count.
    Returns two 0-d int64 device tensors."""
    X, Y, Z = vol_res
    vol = vol_flat.reshape(X, Y, Z)
    case = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.int32,
                       device=vol.device)
    for bit, (dx, dy, dz) in enumerate(
            ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
             (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))):
        corner = vol[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz] > iso
        case |= corner.to(torch.int32) << bit
    active = ((case != 0) & (case != 255)).sum()
    ntris = device_constant(_NTRIS256, vol.device, torch.int64)
    return active, ntris[case.long()].sum()


def unique_vertices(mesh) -> torch.Tensor:
    """Distinct volume-edge keys among the valid slots of a soup extracted
    with edge ids: the unique vertices the color stages integrate."""
    ids = mesh.edge_ids[mesh.valid.repeat_interleave(3)]
    return torch.unique(ids).numel()


def capacity_stats(capture, item: dict, inferred_normal=None,
                   camera: Optional[dict] = None,
                   neck_vertex_idx: int = 0) -> Dict[str, dict]:
    """Every data-dependent count of one frame of ``capture`` on ``item``
    beside its capacity. The ReconNet rows (and the live position pass)
    need ``inferred_normal`` and ``camera`` and a capture with ReconNet.

    Returns {row: {count, capacity, headroom}} and "frame_overflow" (the
    production frame's, or the avatar-only frame's without ReconNet). A
    triangle count is the extraction's total before the capacity cut."""
    o, g, st = capture.opt, capture.grid, capture.statics
    stats: Dict[str, dict] = {}

    def row(name, count, capacity):
        count, capacity = int(count), int(capacity)
        stats[name] = {"count": count, "capacity": capacity,
                       "headroom": round(1.0 - count / max(capacity, 1), 3)}

    def level_counts(prefix, value_fn, volume_fn, c_prior, prior, iso,
                     refine_capacity, max_tris, max_active, unique_capacity):
        if o.hierarchical_query:
            vol, _, n_r = hierarchical_volume(
                value_fn, g, st.cano_bounds, c_prior, prior, iso,
                o.hier_alpha, refine_capacity, with_stats=True)
            row(f"{prefix}_refine_nodes", n_r, refine_capacity)
        else:
            vol, _ = volume_fn()
        active, tris = surface_counts(vol, g.vol_res, iso)
        row(f"{prefix}_active_cubes", active, max_active)
        row(f"{prefix}_tris", tris, max_tris)
        mesh = _extract_mesh(vol, g, st.cano_bounds, iso, max_tris,
                             max_active, o.normal_mode, with_edge_ids=True)
        if unique_capacity:
            row(f"{prefix}_unique_vertices", unique_vertices(mesh),
                unique_capacity)
        return mesh

    w_recon = inferred_normal is not None and capture.recon is not None
    with torch.inference_mode():
        frame, jnt, normal, w2c = capture.upload(
            item, inferred_normal if w_recon else None)
        feat = compute_pose_features(capture.avatar, frame.smpl_pos_map)
        mesh = level_counts(
            "avatar", capture.avatar_value_fn(feat),
            lambda: capture.avatar_volume(feat), g.c_prior, g.prior_volume,
            o.iso_value, o.refine_capacity, o.max_tris, o.max_active,
            o.nerf_unique_capacity)
        fri, bri = capture.cano_layers_stage(mesh)[:2]
        # one shared candidate buffer for both mirror passes (the capacity
        # default of render/raster.py's pair pass)
        row("cano_pair_candidates", fri.n_candidates,
            o.raster_max_candidates or max(2 * o.max_tris, 1 << 17))
        row("cano_big_tris", torch.maximum(fri.n_big, bri.n_big),
            o.cano_big_tris)
        if not w_recon:
            res = capture.process_frame(item, w_recon=False)
            stats["frame_overflow"] = bool(res["overflow"])
            return stats

        # the live position pass of the normal lift
        live, _ = capture.skinning_stage(mesh, jnt)
        img_h, img_w = normal.shape[:2]
        mvp = capture._projection(camera, img_h, img_w) @ w2c
        tris = live.vertices.reshape(-1, 3, 3)
        clip = torch.einsum("ij,tvj->tvi", mvp, torch.cat(
            [tris, torch.ones_like(tris[..., :1])], -1))
        pos = rasterize_index(clip, mesh.valid, img_h, img_w,
                              window=o.cano_window,
                              big_tri_capacity=o.live_big_tris,
                              max_candidates=o.raster_max_candidates)
        row("live_pos_candidates", pos.n_candidates,
            o.raster_max_candidates or max(o.max_tris, 1 << 16))
        row("live_big_tris", pos.n_big, o.live_big_tris)

        res = capture.process_frame(item, w_recon=True, w_nerf=False,
                                    inferred_normal=inferred_normal,
                                    neck_vertex_idx=neck_vertex_idx,
                                    camera=camera)
        feat_map = capture.recon.get_feat_maps(torch.cat(
            [res["front_merged_normal"], res["back_avatar_normal"]], -1)[None])
        level_counts(
            "recon", capture.recon_value_fn(feat_map),
            lambda: capture.recon_volume(feat_map), 0.5 * (g.c_prior + 1.0)
            if o.hierarchical_query else None, 0.5 * (g.prior_volume + 1.0),
            0.5, o.recon_refine_capacity or o.refine_capacity,
            o.recon_max_tris or o.max_tris,
            o.recon_max_active or o.max_active, o.recon_unique_capacity)
        stats["frame_overflow"] = bool(res["overflow"])
    return stats


def main(argv=None) -> int:
    from avatarcap_tpu_torch.tools.bench_workloads import (add_subject_args,
                                                           subject_from_args)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_subject_args(parser)
    args = parser.parse_args(argv)
    capture, item, recon_kw, _ = subject_from_args(args)
    stats = capacity_stats(capture, item,
                           inferred_normal=recon_kw["inferred_normal"],
                           camera=recon_kw["camera"],
                           neck_vertex_idx=recon_kw["neck_vertex_idx"])
    for name, rec in stats.items():
        if isinstance(rec, dict):
            print(json.dumps({"row": name, **rec}), flush=True)
    print(json.dumps({"frame_overflow": stats["frame_overflow"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
