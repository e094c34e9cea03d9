"""The program's own spans against a profile of the same stretch.

A traced capture run reads a fourth stretch (span_stretch.py, run once
when a reader first asks): the cell's frames under torch.profiler (host
and device), with the program's tracer
(avatarcap_tpu_torch/utils/timers.Tracer) as the stage hook, a
synchronise at each end inside the window's range. The tracer stamps each
span (a frame, a stage, and the layers below: ``knn``, ``marching_tets``,
the kernels' ``k1`` / ``k2`` / ``k3`` with their ``rows`` and ``live``
counts) on the profiler's clock.

Here every device operation of the window is put under the innermost
program span open at its launch (the runtime call with its correlation
id, as trace.reduce_trace finds it), and every idle gap of the window
under the innermost span open at the gap's middle. A span name's device
time, launches and idle time include those of the spans inside it.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from benchmark import trace


class Innermost:
    """The innermost span open at a time. Spans nest (one thread), so the
    last span to start at or before t holds t, or else its nearest
    ancestor that still does."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, s.id))
        self.starts = [s.start_ns for s in self.spans]
        self.by_id = {s.id: s for s in self.spans}

    def chain(self, t: int) -> List[str]:
        """The names of the spans holding t, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and not t < s.end_ns:
            s = self.by_id.get(s.parent)
        names = []
        while s is not None:
            names.append(s.name)
            s = self.by_id.get(s.parent)
        return names


def attribute(kernels: List[dict], launches: Dict[int, int], window,
              spans, iterations: int) -> dict:
    """The window's device operations (trace.device_events' dicts) and
    idle gaps put under the spans (``launches``: correlation id -> host
    start of the launch call; ``window``: (start, end) on the profiler's
    clock)."""
    lo, hi = window
    kern = [k for k in kernels if k["start"] + k["dur"] > lo
            and k["start"] < hi]
    where = Innermost(spans)
    device_ns, launched, kernel_ns = (defaultdict(int), defaultdict(int),
                                      defaultdict(int))
    for k in kern:
        kernel_ns[k["name"]] += k["dur"]
        t = launches.get(k["corr"])
        for name in set(where.chain(t) if t is not None else ()):
            device_ns[name] += k["dur"]
            launched[name] += 1
    intervals = [(k["start"], k["start"] + k["dur"]) for k in kern]
    idle_under, outside, gaps = defaultdict(int), 0, []
    for s, e in trace.idle_gaps(intervals, lo, hi):
        names = where.chain((s + e) // 2)
        for name in set(names):
            idle_under[name] += e - s
        if not names:
            outside += e - s
        gaps.append((names[0] if names else "(no span)", e - s))
    gaps.sort(key=lambda g: -g[1])
    busy = trace.union_ns(trace.clip(intervals, lo, hi))
    return {"window_ns": hi - lo, "busy_ns": busy, "idle_ns": hi - lo - busy,
            "iterations": iterations, "device_ns": dict(device_ns),
            "launches": dict(launched), "idle_under_ns": dict(idle_under),
            "idle_outside_ns": outside, "kernel_ns": dict(kernel_ns),
            "idle_gaps": [[n, ns * 1e-9] for n, ns in gaps[:10]],
            "ops": [dict(s.counts, name=s.name) for s in spans
                    if s.kind == "op" and s.counts]}


def reduce_spans(prof, spans, iterations: int) -> Optional[dict]:
    """``attribute`` on a finished torch.profiler run whose window is
    trace.window_range's; None when the trace holds no window."""
    cuda_t = torch.autograd.DeviceType.CUDA
    window, launches = None, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda_t:
            continue
        name = e.name()
        if name == trace.WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith(trace._LAUNCH_CALLS):
            launches[e.correlation_id()] = e.start_ns()
    if window is None:
        return None
    return attribute(trace.device_events(prof), launches, window, spans,
                     iterations)


def idle_note(summary: dict) -> dict:
    """What a run's notes keep of the stretch's idle time: the share no
    program span holds, each span name's idle ms a frame, the longest
    gaps by innermost span."""
    n, idle = summary["iterations"], summary["idle_ns"]
    return {"outside_share": (100.0 * summary["idle_outside_ns"] / idle
                              if idle else None),
            "idle_ms": {k: v * 1e-6 / n
                        for k, v in summary["idle_under_ns"].items()},
            "idle_gaps": summary["idle_gaps"]}


def summary(run) -> Optional[dict]:
    """The fourth stretch's summary, where it ran a frame: run on the
    first call and kept on the run as ``span_summary`` (None where the run
    has no such stretch, as with a program without the tracer)."""
    if "span_summary" not in vars(run):
        from benchmark.span_stretch import run_stretch
        run.span_summary = run_stretch(run)
    s = run.span_summary
    return s if s is not None and s.get("iterations") else None


def device_ms(run, *names: str) -> Optional[float]:
    """Device ms a frame of the operations launched under any of the span
    names; None where no such span launched one."""
    s = summary(run)
    if s is None or not any(n in s["device_ns"] for n in names):
        return None
    return sum(s["device_ns"].get(n, 0) for n in names) * 1e-6 / \
        s["iterations"]


def kernel_ns(s: dict, name: str) -> Optional[int]:
    """Device ns of the kernels of the function ``name`` in the stretch
    (metrics.kernel_ns's match)."""
    ns = sum(v for k, v in s["kernel_ns"].items()
             if re.search(rf"(^|::|\s){re.escape(name)}\(", k))
    return ns or None
