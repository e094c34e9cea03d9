"""Marching tetrahedra's sub-passes on the card (counterpart of
avatarcap_tpu/tools/bench_mc.py).

A body-scale ellipsoid in a 384 x 384 x 128 volume (a surface area like
the capture's) through ops/marching_cubes.marching_tets without normals,
with the trilinear-gradient normals, with the Sobel edge normals of
normal_mode="mc_edge" (the Sobel volume timed alone too) and with
"sobel_sample"'s resample at every soup vertex; and the active-cube mask
with its compaction alone. Times are CUDA-event means over --iters calls
after a warm-up (host-clock means with --device cpu, labelled "host").

Usage: python -m avatarcap_tpu_torch.tools.bench_mc [--res X Y Z]
       [--max-tris N] [--max-active N] [--iters N] [--device D]
prints one JSON line per pass, then the triangle and active-cube counts.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.ops.marching_cubes import (marching_tets,
                                                    mesh_grid_coords)
from avatarcap_tpu_torch.ops.sobel import (extract_normal_volume,
                                           sample_volume_normals)
from avatarcap_tpu_torch.utils.timers import mean_ms


def ellipsoid_volume(res, device) -> torch.Tensor:
    """0.7 - |x / (0.8, 0.95, 0.7)| on [-1, 1]^3 sampled at ``res``: an
    ellipsoid filling most of the volume."""
    lin = [torch.linspace(-1.0, 1.0, n, device=device) for n in res]
    g = torch.stack(torch.meshgrid(*lin, indexing="ij"), -1)
    axes = torch.tensor([0.8, 0.95, 0.7], device=device)
    return 0.7 - (g / axes).norm(dim=-1)


def run(res=(384, 384, 128), max_tris=1 << 20, max_active=1 << 18,
        iters=5, device=None) -> dict:
    """Each pass's mean ms (and the clock), the triangles and active
    cubes of the volume, and the overflow bit."""
    device = resolve_device(device)
    vol = ellipsoid_volume(res, device)
    bmin = torch.zeros(3, device=device)
    voxel = torch.tensor([2.0 / n for n in res], device=device)
    bounds = torch.stack([bmin, bmin + voxel * torch.tensor(
        res, dtype=torch.float32, device=device)])
    kw = dict(max_tris=max_tris, max_active=max_active)
    nvol = extract_normal_volume(vol, voxel)
    plain = marching_tets(vol, 0.0, bmin, voxel, **kw)

    def active_part():
        v5 = vol[None, None]
        mx = F.max_pool3d(v5, 2, stride=1)[0, 0]
        mn = -F.max_pool3d(-v5, 2, stride=1)[0, 0]
        act = ((mx > 0.0) & ~(mn > 0.0)).reshape(-1)
        return compact_mask_indices(act, max_active)

    passes = {
        "marching_tets (no normals)": lambda: marching_tets(
            vol, 0.0, bmin, voxel, **kw),
        "marching_tets (+trilinear normals)": lambda: marching_tets(
            vol, 0.0, bmin, voxel, gradient_normals=True, **kw),
        "extract_normal_volume (sobel)": lambda: extract_normal_volume(
            vol, voxel),
        "marching_tets (+sobel edge normals)": lambda: marching_tets(
            vol, 0.0, bmin, voxel, normal_volume=nvol, **kw),
        "sobel_sample at every soup vertex": lambda: sample_volume_normals(
            vol, voxel, mesh_grid_coords(plain.vertices, bounds)),
        "active mask + compaction": active_part,
    }
    out = {"res": list(res), "max_tris": max_tris, "max_active": max_active,
           "device": str(device), "passes": {}}
    with torch.inference_mode():
        for name, fn in passes.items():
            ms, clock = mean_ms(fn, iters, device)
            out["passes"][name] = {"ms": ms, "clock": clock}
        out["triangles"] = int(plain.num_tris)
        out["active_cubes"] = int(active_part()[1])
        out["overflow"] = bool(plain.overflow)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, nargs=3, default=(384, 384, 128))
    ap.add_argument("--max-tris", type=int, default=1 << 20)
    ap.add_argument("--max-active", type=int, default=1 << 18)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    rec = run(tuple(args.res), args.max_tris, args.max_active, args.iters,
              args.device)
    for name, p in rec["passes"].items():
        print(json.dumps({"pass": name, **p}), flush=True)
    print(json.dumps({k: rec[k] for k in ("triangles", "active_cubes",
                                          "overflow", "device")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
