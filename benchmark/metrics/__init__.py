"""One reader per metric: ``read(run) -> float | None`` on a finished
``harness.Run``; None where the run holds nothing to read, and the
harness then leaves the metric out of the line. Shared arithmetic below."""

from __future__ import annotations

import re
from typing import Optional

from benchmark import networks, trace, work


def traced(run) -> Optional[dict]:
    """The device-only stretch of a traced run (trace.reduce_device_trace),
    where it ran an iteration."""
    s = run.summary
    return s if s is not None and s.get("iterations") else None


def iteration_s(run) -> Optional[float]:
    """Seconds an iteration (a frame or a step) takes unprofiled: the
    traced run's host-timed stretch, which ends each iteration on the
    host. The profiler's per-launch cost stretches a host-bound frame
    (~1.4x the textured frame's 22,000 launches even with device activity
    alone), so a profiled stretch's own length is not the frame's."""
    h = run.host_stages
    if not h or not h.get("iterations"):
        return None
    return h["window_s"] / h["iterations"]


def idle_share(run) -> Optional[float]:
    """The share of an unprofiled iteration in which no device operation
    runs: 1 - the device-only stretch's busy time an iteration (kernel,
    copy and fill durations, which the profiler does not stretch) over
    iteration_s."""
    s, it = traced(run), iteration_s(run)
    if s is None or not it:
        return None
    return 100.0 * (1.0 - s["busy_ns"] * 1e-9 / s["iterations"] / it)


def stage_ms(run, stage: str) -> Optional[float]:
    """Device ms per iteration of the kernels launched in a stage (the
    stretch with the stage ranges)."""
    s = run.stage_summary
    if s is None or not s.get("iterations"):
        return None
    ns = trace.stage_device_ns(s).get(stage)
    return None if ns is None else ns * 1e-6 / s["iterations"]


def kernel_ns(run, name: str) -> Optional[int]:
    """Device ns of the kernels of the function ``name`` (as the trace
    names it: its signature, in whatever namespace) in the device-only
    stretch."""
    s = traced(run)
    if s is None:
        return None
    ns = sum(k["dur"] for k in s["kernels"]
             if re.search(rf"(^|::|\s){re.escape(name)}\(", k["name"]))
    return ns or None


def frame_flops(run) -> Optional[float]:
    """The work of one capture frame of the device-only stretch, from the
    configuration's widths and the frame's live counts (the harness's
    counts, loops/capture.py LiveWork): K1's live points; K3's live rays
    x samples; K2's points, the coarse band's live nodes (K1's coarse
    launch's) and the fine nodes ReconNet's query refines; the U-Net's
    and the HGFilter's convolutions."""
    s = traced(run)
    if s is None:
        return None
    cfg, mix = run.cfg, run.mix
    w, opt = cfg["widths"], cfg["capture"]["options"]
    c = run.counters
    points = sum(c["k1_points"]) + opt["n_samples"] * sum(c["k3_rays"])
    macs = points * work.k1_macs_per_point(w)
    if mix["w_recon"]:
        # per frame: K1 coarse then refine; the avatar's refine then
        # ReconNet's
        k2 = sum(c["k1_points"][0::2]) + sum(c["refined"][1::2])
        macs += k2 * work.k2_macs_per_point(w)
    macs /= s["iterations"]
    macs += unet_macs(cfg) + (hgfilter_macs(cfg) if mix["w_recon"] else 0)
    return 2.0 * macs


def unet_macs(cfg: dict) -> int:
    """The pose U-Net's convolutions on one position map, counted on the
    configuration's reference avatar on the meta device."""
    import torch
    unet = networks.meta(cfg, "avatar").warping_field.unet
    with torch.device("meta"):
        x = torch.empty(1, 6, cfg["pos_map_res"], cfg["pos_map_res"])
    return work.conv_macs(unet, lambda: unet(x))


def hgfilter_macs(cfg: dict) -> int:
    """ReconNet's image encoder on one img_res^2 pair of normal images,
    the same way."""
    import torch
    res = cfg["capture"]["img_res"]
    enc = networks.meta(cfg, "recon").image_encoder
    with torch.device("meta"):
        x = torch.empty(1, 6, res, res)
    return work.conv_macs(enc, lambda: enc(x))
