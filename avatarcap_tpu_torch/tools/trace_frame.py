"""Op-level breakdown of the capture frame from a torch.profiler trace
(counterpart of avatarcap_tpu/tools/trace_frame.py).

tools/profile_frame.py attributes seconds to the frame's stages; this
tool attributes the card's time to the kernels it ran: for each kernel
name, its device milliseconds per frame, its launches per frame and its
share of the frame's device time, the top ``--top`` of them, and the
totals. It also counts each stage's launches and device time (one
profiled run per stage, through the frame's stage hook), which says
where a frame's launches come from.

Usage (the fitted full-size production frame on the card; ``--nerf`` for
the textured one, ``--small`` for the 48 x 48 x 32 subject, ``--device
cpu`` for the CPU, where the breakdown is of CPU operators' self time on
the host clock)::

    python -m avatarcap_tpu_torch.tools.trace_frame [--frames N] [--top K]
        [--nerf] [--keep DIR] [--small] [--device D]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from avatarcap_tpu_torch.tools.bench_stream import device_events


def op_breakdown(events, frames: int = 1) -> dict:
    """Per kernel name over ``events`` (name, start ns, duration ns): ms
    and launches per frame and the share of the device time, sorted by
    time; and the totals per frame."""
    agg = defaultdict(lambda: [0, 0])
    for name, _, dur in events:
        agg[name][0] += dur
        agg[name][1] += 1
    total_ns = sum(v[0] for v in agg.values())
    ops = [{"name": k, "ms": v[0] * 1e-6 / frames, "launches": v[1] / frames,
            "share": v[0] / max(total_ns, 1)} for k, v in agg.items()]
    ops.sort(key=lambda o: -o["ms"])
    return {"ops": ops, "total_ms": total_ns * 1e-6 / frames,
            "launches": len(events) / frames}


def host_op_breakdown(prof, frames: int = 1) -> dict:
    """The CPU run's counterpart of op_breakdown: per operator, its self
    time on the host clock and its calls, per frame."""
    rows = [(e.key, e.self_cpu_time_total * 1e3, e.count)
            for e in prof.key_averages()]
    total_ns = sum(r[1] for r in rows)
    ops = [{"name": k, "ms": ns * 1e-6 / frames, "launches": n / frames,
            "share": ns / max(total_ns, 1)} for k, ns, n in rows]
    ops.sort(key=lambda o: -o["ms"])
    return {"ops": ops, "total_ms": total_ns * 1e-6 / frames,
            "launches": sum(r[2] for r in rows) / frames}


def _profiled(device):
    activities = ([ProfilerActivity.CUDA] if device.type == "cuda"
                  else [ProfilerActivity.CPU])
    return profile(activities=activities)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StageProfiler:
    """A frame's stage hook that profiles each stage on its own and keeps
    its kernel launches and device ms (on the CPU: operator calls and
    self ms on the host clock)."""

    def __init__(self, device):
        self.device = device
        self.stages = defaultdict(lambda: {"launches": 0, "ms": 0.0})

    @contextlib.contextmanager
    def __call__(self, name):
        _sync(self.device)
        with _profiled(self.device) as prof:
            yield
            _sync(self.device)
        b = (op_breakdown(device_events(prof))
             if self.device.type == "cuda" else host_op_breakdown(prof))
        self.stages[name]["launches"] += b["launches"]
        self.stages[name]["ms"] += b["total_ms"]


def trace(capture, item: dict, recon_kw: dict, frames: int = 2,
          w_nerf: bool = False, top: int = 30, keep=None) -> dict:
    """Profile ``frames`` production frames (textured with ``w_nerf``)
    after a warm-up one: the op breakdown (op_breakdown on a card,
    host_op_breakdown on the CPU) cut to its ``top`` ops, the host-clock
    seconds a profiled frame, and each stage's launches and ms from one
    more frame run stage by stage. ``keep``: a directory for the Chrome
    trace."""
    dev = capture.device
    kw = dict(w_recon=True, w_nerf=w_nerf, **recon_kw)
    capture.process_frame(item, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    with _profiled(dev) as prof:
        for _ in range(frames):
            capture.process_frame(item, **kw)
        _sync(dev)
    wall = (time.perf_counter() - t0) / frames
    if keep:
        os.makedirs(keep, exist_ok=True)
        prof.export_chrome_trace(os.path.join(keep, "trace_frame.json"))
    out = (op_breakdown(device_events(prof), frames) if dev.type == "cuda"
           else host_op_breakdown(prof, frames))
    out.update(frames=frames, w_nerf=w_nerf, device=str(dev),
               clock="cuda" if dev.type == "cuda" else "host",
               profiled_s_per_frame=wall, distinct_ops=len(out["ops"]))
    out["ops"] = out["ops"][:top]
    stages = _StageProfiler(dev)
    capture.process_frame(item, timer=stages, **kw)
    out["stages"] = dict(stages.stages)
    out["launches_outside_stages"] = out["launches"] - sum(
        s["launches"] for s in out["stages"].values())
    return out


def main(argv=None) -> int:
    from avatarcap_tpu_torch.tools.bench_workloads import (add_subject_args,
                                                           subject_from_args)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--nerf", action="store_true")
    ap.add_argument("--keep", default=None,
                    help="write the Chrome trace into this directory")
    add_subject_args(ap)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    capture, item, recon_kw, _ = subject_from_args(args)
    print(f"setup: {time.perf_counter() - t0:.1f} s", flush=True)
    rec = trace(capture, item, recon_kw, frames=args.frames,
                w_nerf=args.nerf, top=args.top, keep=args.keep)
    unit = "device" if rec["clock"] == "cuda" else "host (CPU self time)"
    print(f"{unit} total: {rec['total_ms']:.2f} ms/frame, "
          f"{rec['launches']:.0f} launches/frame over {rec['distinct_ops']} "
          f"distinct ops; profiled frame {rec['profiled_s_per_frame']:.3f} s")
    print(f"{'ms/frame':>9}  {'launches':>8}  {'share':>6}  op")
    for o in rec["ops"]:
        print(f"{o['ms']:9.3f}  {o['launches']:8.0f}  {o['share']:6.1%}  "
              f"{o['name'][:100]}")
    print(json.dumps({"stages": rec["stages"], "launches_outside_stages":
                      rec["launches_outside_stages"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
