"""The traced run's reductions, frozen in the benchmark.

A traced run reads three stretches of the same loop, one after another:
the host time of each stage on the host clock (``HostStages``, no
profiler, no synchronise); a device-only profile (kernels, copies and
fills, no host activity: the profiler's host-side cost would stretch a
host-bound frame), bracketed by a synchronise at each end, for the busy
share and each kernel's device time (``reduce_device_trace``); and a
profile of host and device with the stage ranges, for the device time
and the launches of each stage and the host range under each idle gap
(``reduce_trace``).


``union_ns`` is copied from avatarcap_tpu_torch/tools/bench_stream.py at
commit 2621afd and ``op_breakdown`` from avatarcap_tpu_torch/tools/
trace_frame.py at the same commit; here the busy time is the union of the
device operations' intervals (kernels, copies, fills) clipped to the
traced window (not from the first kernel to the last), and each kernel
is attributed to the stage range
(``stage:<name>``, marked by the harness's stage hook) in which the host
launched it.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "benchmark:window"
STAGE = "stage:"
# the runtime calls that launch work on the card
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def union_ns(spans) -> int:
    """The length of the union of (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def clip(spans, lo: int, hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in spans if e > lo and s < hi]


def idle_gaps(spans, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi) that no span covers."""
    gaps, cur = [], lo
    for s, e in sorted(clip(spans, lo, hi)):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def op_breakdown(kernels, top: int = 10) -> List[list]:
    """[name, seconds] of the device operations (by name) that took most
    device time."""
    agg = defaultdict(int)
    for k in kernels:
        agg[k["name"]] += k["dur"]
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns * 1e-9] for name, ns in rows]


class HostStages:
    """The stage hook of the host-timed stretch: ``timer(name)`` adds the
    host seconds spent inside the stage to ``seconds[name]`` and does not
    synchronise."""

    def __init__(self):
        self.seconds = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0


class StageMarks:
    """The stage hook of the traced run: ``timer(name)`` opens a profiler
    range ``stage:<name>`` and does not synchronise."""

    def __call__(self, name: str):
        return torch.profiler.record_function(STAGE + name)


@contextlib.contextmanager
def window_range():
    with torch.profiler.record_function(WINDOW):
        yield


def device_events(prof) -> List[dict]:
    """Every device operation of a finished torch.profiler run (kernels,
    copies, fills; not the device-side copies of the host's annotations):
    name, start, duration, correlation id."""
    cuda_t = torch.autograd.DeviceType.CUDA
    return [{"name": e.name(), "start": e.start_ns(), "dur": e.duration_ns(),
             "corr": e.correlation_id()}
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda_t and not e.is_user_annotation()]


def reduce_device_trace(prof, window_ns: int) -> dict:
    """A device-only profile of a stretch that began and ended with a
    synchronise, ``window_ns`` long on the host clock: every device
    operation of it lies inside the stretch, so the busy time is the
    union of them all."""
    kern = device_events(prof)
    busy = union_ns([(k["start"], k["start"] + k["dur"]) for k in kern])
    return {"window_ns": int(window_ns), "busy_ns": min(busy, window_ns),
            "kernels": kern}


def reduce_trace(prof) -> Optional[dict]:
    """The traced window from a finished torch.profiler run on the card:
    the window's host range, each device operation in it (kernels,
    copies, fills: name, start, duration, the stage whose range holds its
    launch call) and the idle gaps with the host range under them. None
    when the trace holds no window."""
    cuda_t = torch.autograd.DeviceType.CUDA
    window = None
    stages = []           # (start, end, stage name)
    host = []             # (start, end, name) of every other host range
    launches = {}         # correlation id -> host start of the launch call
    kernels = device_events(prof)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda_t:
            continue
        if name == WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith(STAGE):
            stages.append((e.start_ns(), e.end_ns(), name[len(STAGE):]))
        elif name.startswith(_LAUNCH_CALLS):
            launches[e.correlation_id()] = e.start_ns()
        elif e.duration_ns() > 0:
            host.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return None
    lo, hi = window
    stages = sorted(r for r in stages if r[1] > lo and r[0] < hi)
    starts = [r[0] for r in stages]

    def stage_of(t):
        # stage ranges do not nest: the last one to start before t
        i = bisect.bisect_right(starts, t) - 1
        return stages[i][2] if i >= 0 and t < stages[i][1] else None

    kern = [k for k in kernels if k["start"] + k["dur"] > lo
            and k["start"] < hi]
    for k in kern:
        t = launches.get(k["corr"])
        k["stage"] = None if t is None else stage_of(t)
    spans = [(k["start"], k["start"] + k["dur"]) for k in kern]
    host = sorted([r for r in host if r[1] > lo and r[0] < hi] + stages)
    gaps = sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {"window_ns": hi - lo, "busy_ns": union_ns(clip(spans, lo, hi)),
            "kernels": kern,
            "idle_gaps": [[_host_under(host, g), (g[1] - g[0]) * 1e-9]
                          for g in gaps]}


def _host_under(host, gap) -> str:
    """The innermost host range that covers the gap's middle: the stage
    and the operator the host was in while the card idled."""
    mid = (gap[0] + gap[1]) // 2
    best = None
    for s, e, n in host:
        if s > mid:
            break
        if e >= mid and (best is None or s >= best[0]):
            best = (s, e, n)
    return best[2] if best else "(no host range)"


def stage_device_ns(summary: dict) -> Dict[str, int]:
    """Device nanoseconds of the kernels launched in each stage range."""
    out = defaultdict(int)
    for k in summary["kernels"]:
        if k["stage"] is not None:
            out[k["stage"]] += k["dur"]
    return dict(out)


def stage_launches(summary: dict) -> Dict[str, int]:
    out = defaultdict(int)
    for k in summary["kernels"]:
        if k["stage"] is not None:
            out[k["stage"]] += 1
    return dict(out)
