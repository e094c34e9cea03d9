"""The streaming loop: one client hands the program a video in chunks, and
``StreamingCapture.run_pipelined`` runs each chunk's frames in order on
one card with the next frames' inputs uploaded ahead (``mix["lookahead"]``)
and nothing read back between frames; the client waits once at the end of
each chunk, reads every frame's overflow and finiteness in one stacked
copy, and hands over the next chunk (a closed loop over chunks).

Set-up is loops/capture.py's (the benchmark's body, grid and fitted
weights, their seconds left out of ``setup_s``; the program's capture on
them; the video), then the streaming capture built on it and
``mix["warm_frames"]`` frames run through it. The window then runs whole
chunks of ``mix["chunk"]`` frames of the cycled video for the run's
seconds and counts their frames. A traced run reads instead three chunks
of ``mix["trace_frames"]`` frames: one unprofiled (the host-timed
iteration), one under a device-only profile with loops/capture.LiveWork's
counts, and one under a host and device profile with the program's own
tracer (avatarcap_tpu_torch/utils/timers.Tracer) as the stage hook, which
benchmark/spans.py reduces by program span (the run's ``span_summary``;
the same profile gives ``stage_summary``, whose stages are the tracer's
and not marked as ranges). After the window: the peak memory, the program
freed, and the seeded frame and the last frame (in a traced run, the
tracer's) checked against the reference as loops/capture.check does.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import generate, networks, spans, subject
from benchmark.harness import Run
from benchmark.loops.capture import (HostOutputs, LiveWork, build_capture,
                                     check, to_numpy)
from benchmark.trace import reduce_device_trace, reduce_trace, window_range


def run(r: Run) -> None:
    cfg, mix, dev = r.cfg, r.mix, r.device
    networks.check(cfg)
    cuda = dev.type == "cuda"
    # the configuration's float32 work runs in float32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, statics, cano_v = subject.toy_avatar_statics(cfg["body"], dev)
    grid = subject.build_capture_grid(statics, cfg["vol_res"])
    weights, fit = subject.capture_weights(cfg, r.seed, params, statics,
                                           grid, dev)
    r.notes["fit"] = fit
    if cuda:
        # the program's peak, not the benchmark's fit
        torch.cuda.reset_peak_memory_stats(dev)
    video = generate.capture_video(mix, cfg, cano_v, params.num_joints,
                                   r.seed)
    from avatarcap_tpu_torch.pipeline import capture as capture_module
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    capture = build_capture(cfg, mix, weights, statics, grid, dev)
    img = cfg["capture"]["img_res"]
    stream = StreamingCapture(
        capture, [dev], camera=video[0]["camera"], image_size=(img, img),
        w_recon=mix["w_recon"], w_nerf=mix["w_nerf"],
        neck_vertex_idx=cfg["capture"]["neck_vertex_idx"])
    host_outputs = HostOutputs(mix["w_recon"], mix["w_nerf"])

    def chunk(first, n, timer=None):
        """Frames first .. first + n - 1 of the cycled video through
        run_pipelined; waits for them once, then counts the failed ones
        (overflow or an output that is not finite). Returns the frames'
        device outputs."""
        frames = [video[(first + i) % len(video)] for i in range(n)]
        outs = stream.run_pipelined(
            frames, [f.get("inferred_normal") for f in frames],
            lookahead=mix["lookahead"], timer=timer)
        bad = torch.stack([
            out["overflow"].reshape(()) | ~torch.stack([
                torch.isfinite(t).all()
                for t, _ in host_outputs._fields(out).values()]).all()
            for out in outs]).cpu()
        r.failed += int(bad.sum())
        return outs

    chunk(0, mix["warm_frames"])
    if cuda:
        torch.cuda.synchronize(dev)
    rng = np.random.default_rng(subject.seed_parts(r.seed, 4)[3])
    sampled = int(rng.integers(0, mix["check_span"]))
    kept = {}
    r.setup_s = time.perf_counter() - r.t0 - fit["seconds"]

    def window_chunk(n, timer=None):
        """The window's next n frames; the seeded frame, and the chunk's
        last frame, copied to host memory."""
        first = mix["warm_frames"] + r.iterations
        outs = chunk(first, n, timer)
        if r.iterations <= sampled < r.iterations + n:
            kept["sampled"] = (first + sampled - r.iterations, to_numpy(
                host_outputs(outs[sampled - r.iterations])))
        r.iterations += n
        return outs

    last = None
    if r.trace:
        from avatarcap_tpu_torch.utils.timers import Tracer
        from torch.profiler import ProfilerActivity, profile
        n = mix["trace_frames"]
        t_start = time.perf_counter()
        window_chunk(n)
        r.host_stages = {"iterations": n,
                         "window_s": time.perf_counter() - t_start,
                         "seconds": {}}
        live = LiveWork(capture_module)
        with profile(activities=[ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            if cuda:
                torch.cuda.synchronize(dev)
            t_start = time.perf_counter_ns()
            window_chunk(n)
            if cuda:
                torch.cuda.synchronize(dev)
            window_ns = time.perf_counter_ns() - t_start
        r.counters.update(live.close())
        r.summary = dict(reduce_device_trace(prof, window_ns), iterations=n)
        del prof
        tracer = Tracer(dev)
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            if cuda:
                torch.cuda.synchronize(dev)
            with window_range():
                outs = window_chunk(n, tracer)
                if cuda:
                    torch.cuda.synchronize(dev)
        traced = tracer.collect()
        r.span_summary = spans.reduce_spans(prof, traced, n)
        staged = reduce_trace(prof)
        r.stage_summary = None if staged is None else dict(staged,
                                                           iterations=n)
        del prof
        if r.span_summary is not None:
            r.notes["span_idle"] = spans.idle_note(r.span_summary)
        r.notes["spans"] = {name: sum(s.name == name for s in traced)
                            for name in sorted({s.name for s in traced
                                                if s.kind == "op"})}
        last = outs[-1]
        del outs
        r.window_s = r.summary["window_ns"] * 1e-9
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < r.seconds:
            last = window_chunk(mix["chunk"])[-1]
        r.window_s = time.perf_counter() - t_start
    r.attempted = r.iterations
    # and the window's last frame
    kept["last"] = (mix["warm_frames"] + r.iterations - 1,
                    to_numpy(host_outputs(last)))
    if cuda:
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del capture, stream, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check(r, cfg, mix, weights, statics, grid, video, kept, rng)
