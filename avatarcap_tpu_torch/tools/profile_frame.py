"""Per-stage breakdown of the capture frame on the fitted subject
(counterpart of avatarcap_tpu/tools/profile_frame.py).

Runs the capture workload (384 x 384 x 128 grid, 512^2 renders with the
normal merge, full ReconNet) and prints where the seconds go: a warm-up
frame, then ``--frames`` frames under the program's tracer
(utils/timers.Tracer, which synchronises nothing; on the card each stage
is timed by two CUDA events, the stage times the benchmark reads), their
mean stage seconds, and the same frames without the tracer.

Usage: python -m avatarcap_tpu_torch.tools.profile_frame [--frames N]
       [--nerf] [--no-recon] [--vol-res X Y Z] [--fusion-iters N]
       [--no-fused-query] [--trace DIR] [--small] [--device D]
``--trace DIR`` also writes a torch.profiler Chrome trace of the timed
frames into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch


def profile_frames(capture, item: dict, recon_kw: dict, frames: int = 3,
                   w_recon: bool = True, w_nerf: bool = False,
                   trace_dir=None) -> dict:
    """Stage seconds (means over ``frames`` traced frames after a warm-up
    one, from the tracer's stage spans) and seconds a frame, with and
    without the tracer; host clock, each timed run ending in a synchronise
    of the card."""
    from avatarcap_tpu_torch.utils.timers import Tracer, stage_seconds
    dev = capture.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kw = dict(w_recon=w_recon, w_nerf=w_nerf,
              **(recon_kw if w_recon else {}))
    tracer = Tracer(dev)
    t0 = time.perf_counter()
    res = capture.process_frame(item, timer=tracer, **kw)
    sync()
    tracer.collect()
    out = {"first_frame_s": time.perf_counter() - t0,
           "num_tris": int(res["cano_mesh"].num_tris),
           "overflow": bool(res["overflow"]), "frames": frames,
           "device": str(dev)}
    if "recon_mesh" in res:
        out["recon_num_tris"] = int(res["recon_mesh"].num_tris)
    trace_cm = contextlib.nullcontext()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        trace_cm = profile(activities=acts)
    t0 = time.perf_counter()
    with trace_cm as prof:
        for _ in range(frames):
            capture.process_frame(item, timer=tracer, **kw)
        sync()
    out["timed_frame_s"] = (time.perf_counter() - t0) / frames
    out["stages"] = {k: v / frames
                     for k, v in stage_seconds(tracer.collect()).items()}
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "profile_frame.json"))
    t0 = time.perf_counter()
    for _ in range(frames):
        capture.process_frame(item, **kw)
    sync()
    out["frame_s"] = (time.perf_counter() - t0) / frames
    return out


def report(stages: dict) -> str:
    """One line per stage of {name: seconds}, the longest first, each
    with its share, and a TOTAL line."""
    tot = sum(stages.values())
    lines = [f"  {k:<24s} {v * 1e3:9.1f} ms  ({v / max(tot, 1e-12):5.1%})"
             for k, v in sorted(stages.items(), key=lambda kv: -kv[1])]
    lines.append(f"  {'TOTAL':<24s} {tot * 1e3:9.1f} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    from avatarcap_tpu_torch.tools.bench_workloads import (add_subject_args,
                                                           subject_from_args)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--nerf", action="store_true")
    ap.add_argument("--no-recon", action="store_true")
    ap.add_argument("--vol-res", type=int, nargs=3, default=None)
    ap.add_argument("--fusion-iters", type=int, default=None)
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="also write a torch.profiler Chrome trace of the "
                         "timed frames into DIR")
    add_subject_args(ap)
    args = ap.parse_args(argv)
    options = {}
    if args.fusion_iters is not None:
        options["fusion_iters"] = args.fusion_iters
    t0 = time.perf_counter()
    capture, item, recon_kw, info = subject_from_args(
        args, vol_res=tuple(args.vol_res) if args.vol_res else None,
        **options)
    print(f"device: {capture.device}; setup: {time.perf_counter() - t0:.1f} "
          f"s, n_valid={info['n_valid']:,} grid points; fit {info['fit']}",
          flush=True)
    rec = profile_frames(capture, item, recon_kw, frames=args.frames,
                         w_recon=not args.no_recon, w_nerf=args.nerf,
                         trace_dir=args.trace)
    print(f"first frame: {rec['first_frame_s']:.2f} s, avatar tris="
          f"{rec['num_tris']:,}" + (f", recon tris={rec['recon_num_tris']:,}"
                                    if "recon_num_tris" in rec else "")
          + f", overflow={rec['overflow']}")
    print(f"\nframe under the tracer: {rec['timed_frame_s'] * 1e3:.1f} "
          f"ms over {args.frames} frames")
    print(report(rec["stages"]))
    print(f"\nframe without the timer: {rec['frame_s'] * 1e3:.1f} ms "
          f"({1.0 / rec['frame_s']:.2f} frames/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
