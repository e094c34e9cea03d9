"""The rasterizer's sub-passes on the card (counterpart of
avatarcap_tpu/tools/bench_raster.py).

A marching-cubes-like soup (T triangles of ~1.5 px spread over the
central image, random depths) through render/raster.rasterize_index, and
its passes alone as that function runs them: the coverage mask (screen
set-up and the dense K x K candidate window), the compaction of the
covered candidates, and the z-resolve (two scatter-mins over the
compacted candidates). Times are CUDA-event means over --iters calls
after a warm-up (host-clock means with --device cpu, labelled "host").

Usage: python -m avatarcap_tpu_torch.tools.bench_raster [--tris N]
       [--res R] [--window K] [--iters N] [--device D]
prints one JSON line per pass, then the covered pixels and candidates.
"""

from __future__ import annotations

import argparse
import json

import torch

from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.render.raster import (_candidates, _resolve,
                                               _screen_setup, rasterize_index)
from avatarcap_tpu_torch.utils.timers import mean_ms


def soup(n_tris: int, res: int, device, seed: int = 0) -> torch.Tensor:
    """(T, 3, 4) clip-space triangles of ~1.5 px at uniform positions in
    the central 70% of the image and uniform depths, from a seeded
    generator."""
    gen = torch.Generator().manual_seed(seed)
    center = torch.rand((n_tris, 1, 2), generator=gen) * 1.4 - 0.7
    offs = torch.rand((n_tris, 3, 2), generator=gen) * (2.0 * 1.5 / res)
    z = torch.rand((n_tris, 1, 1), generator=gen) - 0.5
    clip = torch.cat([center + offs, z.expand(-1, 3, 1),
                      torch.ones((n_tris, 3, 1))], -1)
    return clip.to(device)


def run(n_tris=1 << 20, res=512, window=4, iters=10, device=None) -> dict:
    """Each pass's mean ms (and the clock), the covered pixels and the
    covered candidates."""
    device = resolve_device(device)
    clip = soup(n_tris, res, device)
    valid = torch.ones(n_tris, dtype=torch.bool, device=device)
    max_c = max(n_tris, 1 << 16)

    def mask():
        Tp, w_safe, px, py, pz, area2, w_ok = _screen_setup(clip, valid, res,
                                                            res)
        return _candidates(px, py, pz, area2, w_ok & (area2 < -1e-12),
                           window, 256, res, res)

    with torch.inference_mode():
        _, cx, cy, _, _, z, ok = mask()
        pix, flat_ok, flat_z = ((cy * res + cx).reshape(-1), ok.reshape(-1),
                                z.reshape(-1))
        passes = {
            "rasterize_index (full)": lambda: rasterize_index(
                clip, valid, res, res, window=window, big_tri_capacity=256),
            "coverage mask": mask,
            "compact_mask_indices": lambda: compact_mask_indices(flat_ok,
                                                                 max_c),
            "z-resolve (compaction + 2 scatter-min)": lambda: _resolve(
                pix, flat_ok, flat_z, res * res, max_c),
        }
        out = {"tris": n_tris, "res": res, "window": window,
               "device": str(device), "passes": {}}
        for name, fn in passes.items():
            ms, clock = mean_ms(fn, iters, device)
            out["passes"][name] = {"ms": ms, "clock": clock}
        ri = rasterize_index(clip, valid, res, res, window=window,
                             big_tri_capacity=256)
        out["covered_pixels"] = int(ri.mask.sum())
        out["covered_candidates"] = int(ri.n_candidates)
        out["candidate_slots"] = int(flat_ok.numel())
        out["overflow"] = bool(ri.overflow)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tris", type=int, default=1 << 20)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    rec = run(args.tris, args.res, args.window, args.iters, args.device)
    for name, p in rec["passes"].items():
        print(json.dumps({"pass": name, **p}), flush=True)
    print(json.dumps({k: rec[k] for k in (
        "covered_pixels", "covered_candidates", "candidate_slots",
        "overflow", "device")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
