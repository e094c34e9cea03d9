"""The capture loop: one client calls ``AvatarCapture.process_frame`` on
the next frame of a video once the previous frame's meshes and colors are
in host memory (a closed loop), as the capture CLI runs a video.

Set-up: the benchmark's body, grid and fitted weights (benchmark/
subject.py; the seconds the fits or their loads take are the benchmark's
and are left out of ``setup_s``), the program's capture built on them,
the video (benchmark/generate.py), then ``mix["warm_frames"]`` frames.
The window then runs frames for the run's seconds. A traced run reads
instead three stretches of ``mix["trace_frames"]`` frames each
(benchmark/trace.py): the stages' host time, a device-only profile and a
profile with the stage ranges. After the window: the peak memory, the
program freed, and the sampled frames checked against the reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import generate, networks, subject
from benchmark.harness import Run
from benchmark.reference import precision
from benchmark.reference.capture_check import CaptureReference, check_frame
from benchmark.trace import (HostStages, StageMarks, reduce_device_trace,
                             reduce_trace, window_range)


class LiveWork:
    """Harness-side wrappers, while counting, of three of the capture
    module's calls, which count the live work of the frame's kernels on
    the device without a synchronise (each count is one small reduction,
    read after the stretch): K1's entry (``warp_template_query`` as
    pipeline/capture.py calls it) counts the points it is handed that are
    not the padding (the compacted coarse band and refine slots pad with
    the origin); ``hierarchical_volume`` the fine nodes it refines (the
    avatar's, then with w_recon ReconNet's, whose coarse and refined
    nodes are K2's points), up to its capacity; and ``_dedupe_soup`` each
    deduped soup's live unique vertices, the rays of the K3 launch that
    follows it."""

    NAMES = ("warp_template_query", "hierarchical_volume", "_dedupe_soup")

    def __init__(self, module):
        self.module = module
        self.saved = {n: getattr(module, n) for n in self.NAMES}
        self.k1, self.refined, self.k3 = [], [], []
        k1_fn, hier_fn, dedupe_fn = (self.saved[n] for n in self.NAMES)

        def k1(packed_offset, packed_template, pts, *a, **kw):
            self.k1.append((pts != 0).any(-1).sum())
            return k1_fn(packed_offset, packed_template, pts, *a, **kw)

        def hier(*a, **kw):
            vol, ovf, n_r = hier_fn(*a, **dict(kw, with_stats=True))
            cap = a[7] if len(a) > 7 else kw["refine_capacity"]
            self.refined.append(torch.clamp(n_r, max=cap))
            return vol, ovf

        def dedupe(*a, **kw):
            out = dedupe_fn(*a, **kw)
            self.k3.append(out[3].sum())
            return out
        for n, fn in zip(self.NAMES, (k1, hier, dedupe)):
            setattr(module, n, fn)

    def close(self) -> dict:
        """Unwrap; each call's count over the stretch."""
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)
        return {k: torch.stack(v).tolist() if v else []
                for k, v in (("k1_points", self.k1),
                             ("refined", self.refined), ("k3_rays", self.k3))}


def build_capture(cfg: dict, mix: dict, weights: dict, statics, grid: dict,
                  device):
    """The program's AvatarCapture, its networks in the configuration's
    form (benchmark/networks.py), on the benchmark's weights, statics and
    grid (copies: the program keeps nothing of the benchmark's)."""
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureGrid,
                                                      CaptureOptions)

    def load(role, state):
        module = networks.build(cfg, role, "program")
        module.load_state_dict(state)
        return module.eval()
    avatar = load("avatar", weights["avatar"])
    tex = load("avatar", weights["tex"]) if mix["w_nerf"] else None
    recon = load("recon", weights["recon"]) if mix["w_recon"] else None
    st = AvatarStatics(*(t.detach().clone() for t in statics))
    g = CaptureGrid(grid["valid_pts"].clone(), grid["valid_idx"].clone(),
                    grid["prior_volume"].clone(), tuple(grid["vol_res"]))
    return AvatarCapture(avatar, st, g, recon=recon, tex_avatar=tex,
                         options=CaptureOptions(**cfg["capture"]["options"]),
                         device=device)


class HostOutputs:
    """The frame's outputs copied to host memory: the valid triangles of
    each soup (vertices, normals, the live vertices, colors) and, with
    ``w_recon``, the normal images, into page-locked buffers allocated
    once at their capacity, as a capture writing a video's meshes would
    reuse them. One read waits for the frame (its triangle counts, its
    overflow bit and whether every output is finite); the copies then run
    and are waited for."""

    def __init__(self, w_recon: bool, w_nerf: bool):
        self.w_recon, self.w_nerf = w_recon, w_nerf
        self.buffers = {}

    def _fields(self, out):
        f = {"cano_v": (out["cano_mesh"].vertices, 0),
             "cano_n": (out["cano_mesh"].normals, 0),
             "live_v": (out["live_mesh"].vertices, 0)}
        if self.w_nerf:
            f["avatar_colors"] = (out["avatar_colors"], 0)
        if self.w_recon:
            f.update(recon_v=(out["recon_mesh"].vertices, 1),
                     recon_n=(out["recon_mesh"].normals, 1),
                     live_recon_v=(out["live_recon_mesh"].vertices, 1))
            if self.w_nerf:
                f["recon_colors"] = (out["recon_colors"], 1)
            for k in ("front_avatar_normal", "back_avatar_normal",
                      "front_image_normal", "front_merged_normal"):
                f[k] = (out[k], None)
        return f

    def __call__(self, out: dict) -> dict:
        fields = self._fields(out)
        finite = torch.stack([torch.isfinite(t).all()
                              for t, _ in fields.values()]).all()
        counts = [out["cano_mesh"].num_tris]
        if self.w_recon:
            counts.append(out["recon_mesh"].num_tris)
        head = torch.stack([c.to(torch.int64) for c in counts]
                           + [out["overflow"].to(torch.int64),
                              finite.to(torch.int64)]).cpu().tolist()
        n = [3 * c for c in head[:len(counts)]]
        h = {"overflow": bool(head[-2]), "finite": bool(head[-1]),
             "tris": head[:len(counts)]}
        for k, (t, which) in fields.items():
            buf = self.buffers.get(k)
            if buf is None:
                buf = self.buffers[k] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            part = t if which is None else t[:n[which]]
            dst = buf if which is None else buf[:n[which]]
            dst.copy_(part, non_blocking=True)
            h[k] = dst
        if any(t.is_cuda for t, _ in fields.values()):
            torch.cuda.synchronize()
        return h


def to_numpy(h: dict) -> dict:
    """A kept frame's host outputs as arrays of its own."""
    return {k: (v.numpy().copy() if torch.is_tensor(v) else v)
            for k, v in h.items()}


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
    if cuda:
        torch.cuda.synchronize(dev)
    rng = np.random.default_rng(subject.seed_parts(r.seed, 4)[3])
    sampled = int(rng.integers(0, mix["check_span"]))
    kept = {}
    r.setup_s = time.perf_counter() - r.t0 - fit["seconds"]

    last = [None]

    def frame(i, timer=None):
        t0 = time.perf_counter()
        h = frame_call(mix["warm_frames"] + i, timer)
        r.latencies.append(time.perf_counter() - t0)
        r.failed += bool(h["overflow"] or not h["finite"])
        r.notes["max_tris"] = [max(a, b) for a, b in zip(
            r.notes.get("max_tris", h["tris"]), h["tris"])]
        # the seeded frame, copied out of the reused buffers
        if i == sampled:
            kept["sampled"] = (mix["warm_frames"] + i, to_numpy(h))
        last[0] = h

    def stretch(timer=None):
        """Up to trace_frames frames within a third of the run's seconds;
        their count and seconds (each frame ends in host memory)."""
        n, t_start = 0, time.perf_counter()
        while (n < mix["trace_frames"]
               and time.perf_counter() - t_start < r.seconds / 3):
            frame(r.iterations, timer)
            r.iterations += 1
            n += 1
        return n, time.perf_counter() - t_start

    if r.trace:
        from torch.profiler import ProfilerActivity, profile
        host = HostStages()
        n, secs = stretch(host)
        r.host_stages = {"iterations": n, "window_s": secs,
                         "seconds": dict(host.seconds)}
        live = LiveWork(capture_module)
        with profile(activities=[ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            if cuda:
                torch.cuda.synchronize(dev)
            t_start = time.perf_counter_ns()
            n = stretch()[0]
            if cuda:
                torch.cuda.synchronize(dev)
            window_ns = time.perf_counter_ns() - t_start
        r.counters.update(live.close())
        # each call's largest live count over the stretch's frames, beside
        # the capacities
        r.notes["live"] = {k: [max(v[i::len(v) // n]) for i in
                               range(len(v) // n)] if n and v else []
                           for k, v in r.counters.items()}
        r.summary = dict(reduce_device_trace(prof, window_ns), iterations=n)
        del prof
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            with window_range():
                n = stretch(StageMarks())[0]
        staged = reduce_trace(prof)
        r.stage_summary = None if staged is None else dict(staged,
                                                           iterations=n)
        del prof
        r.window_s = r.summary["window_ns"] * 1e-9
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < r.seconds:
            frame(r.iterations)
            r.iterations += 1
        r.window_s = time.perf_counter() - t_start
    r.attempted = r.iterations
    # and the window's last frame, still in the buffers
    kept["last"] = (mix["warm_frames"] + r.iterations - 1, to_numpy(last[0]))
    if cuda:
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del capture, frame_call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check(r, cfg, mix, weights, statics, grid, video, kept, rng)


def check(r: Run, cfg, mix, weights, statics, grid, video, kept, rng):
    """The kept frames against the reference (or, for a control run, the
    reference in the control's precision put in the program's place)."""
    ref = CaptureReference(cfg, weights, statics, grid, r.device)
    frames = {i: h for i, h in kept.values()}
    nums = {}
    control = (None if r.control is None
               else precision.CONTROLS[r.control])
    for i, h in sorted(frames.items()):
        with precision.f32():
            got = check_frame(ref, video[i % len(video)], h, mix["w_recon"],
                              mix["w_nerf"], mix["color_rays"], rng, control)
        for k, v in got.items():
            nums[k] = max(nums.get(k, 0.0), v)
    r.checks.update(nums)
    r.notes["checked_frames"] = sorted(frames)
