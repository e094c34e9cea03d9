"""The fourth stretch of a traced capture run: frames with the program's
own tracer (avatarcap_tpu_torch/utils/timers.Tracer) as the stage hook.

It runs once per run, when a reader of the program's spans first asks for
it (benchmark/spans.summary), after the loop (loops/capture.py) has
finished its window and its checks, so nothing the loop measures moves.
On the run's cell it builds the capture afresh on the same seeded body,
grid, fitted weights (the fit cache's) and video, warms it up with
``mix["warm_frames"]`` frames, then runs the frames that follow the
window's (up to ``mix["trace_frames"]`` within a third of the run's
seconds) under torch.profiler, host and device, with a synchronise at
each end inside the window's range; benchmark/spans.py reduces the
profile with the tracer's spans. The stretch's last frame, traced, is
then checked against the reference as the loop checks its frames, and
its numbers join the run's (the larger of the two is kept), so
``correct`` also says that the tracer changes no output.

A run that is not traced, another loop's run, and a program without the
tracer get None, and the readers leave their metrics out.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Optional

import numpy as np
import torch

from benchmark import generate, spans, subject


def run_stretch(r) -> Optional[dict]:
    """The stretch's summary (spans.reduce_spans), or None."""
    if not getattr(r, "trace", False) or r.mix.get("loop") != "capture":
        return None
    try:
        from avatarcap_tpu_torch.utils.timers import Tracer
    except ImportError:         # a program without its tracer
        return None
    from torch.profiler import ProfilerActivity, profile

    from benchmark.loops.capture import HostOutputs, build_capture, to_numpy
    from benchmark.trace import window_range
    cfg, mix, dev = r.cfg, r.mix, r.device
    cuda = dev.type == "cuda"
    params, statics, cano_v = subject.toy_avatar_statics(cfg["body"], dev)
    grid = subject.build_capture_grid(statics, cfg["vol_res"])
    weights = subject.capture_weights(cfg, r.seed, params, statics, grid,
                                      dev)[0]
    video = generate.capture_video(mix, cfg, cano_v, params.num_joints,
                                   r.seed)
    capture = build_capture(cfg, mix, weights, statics, grid, dev)
    kw = dict(w_recon=mix["w_recon"], w_nerf=mix["w_nerf"])
    host_outputs = HostOutputs(**kw)

    def frame_call(i, timer=None):
        f = video[i % len(video)]
        out = capture.process_frame(
            f, inferred_normal=f.get("inferred_normal"),
            neck_vertex_idx=f["neck_vertex_idx"] if mix["w_recon"] else None,
            camera=f["camera"] if mix["w_recon"] else None, timer=timer,
            **kw)
        return host_outputs(out)

    for i in range(mix["warm_frames"]):
        frame_call(i)
    tracer = Tracer(dev)
    first = mix["warm_frames"] + r.iterations
    n, last = 0, None
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        if cuda:
            torch.cuda.synchronize(dev)
        with window_range():
            t_start = time.perf_counter()
            while (n < mix["trace_frames"]
                   and time.perf_counter() - t_start < r.seconds / 3):
                last = frame_call(first + n, tracer)
                n += 1
            if cuda:
                torch.cuda.synchronize(dev)
    summary = spans.reduce_spans(prof, tracer.collect(), n)
    del prof
    kept = (first + n - 1, to_numpy(last))
    del capture, frame_call, host_outputs, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check_traced(r, cfg, mix, weights, statics, grid, video, kept)
    if summary is not None:
        r.notes["span_idle"] = spans.idle_note(summary)
    return summary


def check_traced(r, cfg, mix, weights, statics, grid, video, kept) -> None:
    """The traced frame against the reference (loops/capture.check's
    comparison, on a generator of its own); each number joins the run's,
    the larger kept and a number that is not finite kept as it is."""
    from benchmark.reference import precision
    from benchmark.reference.capture_check import (CaptureReference,
                                                   check_frame)
    i, h = kept
    ref = CaptureReference(cfg, weights, statics, grid, r.device)
    rng = np.random.default_rng(subject.seed_parts(r.seed, 5)[4])
    control = (None if r.control is None
               else precision.CONTROLS[r.control])
    with precision.f32():
        got = check_frame(ref, video[i % len(video)], h, mix["w_recon"],
                          mix["w_nerf"], mix["color_rays"], rng, control)
    for k, v in got.items():
        old = r.checks.get(k)
        if old is None or not math.isfinite(v) or v > old:
            r.checks[k] = v
    r.notes["traced_checked_frame"] = i
