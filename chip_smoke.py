#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (avatarcap_tpu_torch) on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the root of a checkout; one card)

Phases, each fatal on failure:
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print the ptxas resource report;
  2. build the full-size capture subject: the toy body (6,752 vertices),
     a 384 x 384 x 128 canonical grid, GeoTexAvatar at its published
     widths with weights from a fixed torch.Generator, the capture
     options of the repo's capture workload;
  3. hold kernel K1 (warp_template_query) against its plain PyTorch
     version on the inputs of the frame's coarse and refine launches, and
     time kernel, plain version and bound;
  4. one warm-up and one timed avatar-only capture frame,
     process_frame(item, w_recon=False, w_nerf=False), with the kernel
     launch counts read just around the timed frame; outputs must be
     finite with triangles;
  5. the same frame on a small subject on the card and on the CPU, which
     must agree.
Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Writes the detailed
record to chiprun_out/chip_smoke.json. Exits non-zero without a CUDA
device, without the package next to it, or on any failed phase.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# K1 tolerances against the plain version: both sum bf16 products in f32,
# in different orders, so a bf16 rounding of an activation can flip; the
# PE's 2^9 frequency amplifies a flipped offset. 2e-2 is the bf16-level
# tolerance at which the JAX package holds its own kernel
# (tests/test_pallas_query.py).
K1_TOL = {"occ": 2e-2, "alpha": 2e-2, "rgb": 2e-2, "offset": 2e-3}

CAPTURE_OPTIONS = dict(
    max_tris=(1 << 19) + (1 << 16),            # 589,824
    max_active=(1 << 18) + (1 << 15),          # 294,912
    refine_capacity=(1 << 20) + (1 << 19) + (1 << 18) + (1 << 17),
    raster_max_candidates=1 << 16,
    skin_row_group=3, render_res=512, hierarchical_query=True,
    normal_mode="trilinear", use_fused_query=True)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps):
    """Mean milliseconds of fn() over reps calls after one warm-up."""
    import torch
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def build_kernels():
    from avatarcap_tpu_torch import kernels
    t0 = time.perf_counter()
    report = kernels.build_all()
    secs = time.perf_counter() - t0
    for name, r in report.items():
        lines = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {r['seconds']:.1f} s; " + " | ".join(lines))
    print(f"[build] all kernels: {secs:.1f} s")
    return {"seconds": secs,
            "kernels": {k: {"seconds": v["seconds"], "ptxas": v["log"]}
                        for k, v in report.items()}}


def build_subject(device, vol_res=(384, 384, 128), dense=True, seed=0,
                  options=None):
    """(AvatarCapture, item, n_valid) for the capture workload."""
    import numpy as np
    import torch
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.tools.bench_workloads import (
        build_capture_grid, random_avatar, toy_avatar_statics)
    params, statics, v = toy_avatar_statics(dense=dense, device=device)
    grid, n_valid = build_capture_grid(statics, vol_res)
    gen = torch.Generator().manual_seed(seed)
    avatar = random_avatar(gen)
    opts = CaptureOptions(**(options or CAPTURE_OPTIONS))
    capture = AvatarCapture(avatar, statics, grid, options=opts,
                            device=device)
    pos_res = 256
    pos_map = torch.randn((pos_res, pos_res, 6), generator=gen) * 0.1
    item = {"live_smpl_v": v.astype(np.float32),
            "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                          (params.num_joints, 1, 1)),
            "smpl_pos_map": pos_map.numpy()}
    return capture, item, n_valid


def k1_launch_inputs(capture, item):
    """The (pts, pose features) of the frame's two K1 launches (coarse,
    refine), recorded through the same hierarchical query the frame runs
    (this pass launches the kernel; it is not the counted frame)."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    from avatarcap_tpu_torch.pipeline.avatar import (compute_pose_features,
                                                     grid_pose_features)
    from avatarcap_tpu_torch.pipeline.capture import hierarchical_volume
    dev = capture.device
    g, st, o = capture.grid, capture.statics, capture.opt
    pk = capture.packed_query
    recorded = []
    with torch.inference_mode():
        pos_map = torch.as_tensor(item["smpl_pos_map"], device=dev)[None]
        feat = compute_pose_features(capture.avatar, pos_map)
        cols = grid_pose_features(feat, st, g.vol_res, dtype=torch.bfloat16,
                                  columns=True)

        def vf(pts, fidx):
            pf = cols[fidx.long() // g.vol_res[2]]
            recorded.append((pts, pf))
            return warp_template_query(pk["offset"], pk["template"], pts,
                                       pf)["occ"][:, 0]

        _, _, n_refined = hierarchical_volume(
            vf, g, st.cano_bounds, g.c_prior, g.prior_volume, o.iso_value,
            o.hier_alpha, o.refine_capacity, with_stats=True)
    return recorded, int(n_refined)


def check_k1(capture, recorded, device):
    """K1 against its plain version on the refine launch's inputs (and
    the coarse one's for the error); times kernel, plain and bound."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import (
        MACS_PER_POINT, warp_template_query, warp_template_query_plain)
    pk = capture.packed_query
    errs = {}
    for pts, pf in recorded:
        with torch.inference_mode():
            got = warp_template_query(pk["offset"], pk["template"], pts, pf)
            ref = warp_template_query_plain(pk["offset"], pk["template"],
                                            pts, pf)
        _sync(device)
        for k in ref:
            if not bool(torch.isfinite(got[k]).all()):
                raise AssertionError(f"K1 output {k} is not finite")
            e = float((got[k] - ref[k]).abs().max())
            errs[k] = max(errs.get(k, 0.0), e)
        del got, ref
    bad = {k: e for k, e in errs.items() if e > K1_TOL[k]}
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad} "
                             f"(tolerance {K1_TOL})")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in pk["offset"] + pk["template"])

    def measure(pts, pf):
        n = pts.shape[0]

        def kernel():
            with torch.inference_mode():
                warp_template_query(pk["offset"], pk["template"], pts, pf)

        def plain():
            with torch.inference_mode():
                warp_template_query_plain(pk["offset"], pk["template"], pts,
                                          pf)

        ms = _timed(kernel, device, reps=10)
        plain_ms = _timed(plain, device, reps=3)
        io_bytes = n * (3 * 4 + 64 * 2 + 8 * 4) + weight_bytes
        flops = 2.0 * MACS_PER_POINT * n
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = io_bytes / PEAK_BYTES_PER_S * 1e3
        return {"points": n, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "tflops": flops / (ms * 1e-3) / 1e12}

    coarse = measure(*recorded[0])
    refine = measure(*recorded[-1])
    # the kernel table reports the refine launch, the larger of the two
    return {"name": "warp_template_query", "route": "cuda",
            "source": "avatarcap_tpu_torch/csrc/warp_template_query.cu",
            "replaces": "avatarcap_tpu/ops/pallas_query.py:341",
            "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
            "tolerance": K1_TOL, **refine, "library_ms": None,
            "coarse_launch": coarse}


def run_frame(capture, item, device):
    """Warm-up frame, then the counted and timed frame."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    capture.process_frame(item, w_recon=False, w_nerf=False)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warp_template_query.launches = 0
    t0 = time.perf_counter()
    res = capture.process_frame(item, w_recon=False, w_nerf=False)
    _sync(device)
    secs = time.perf_counter() - t0
    launches = warp_template_query.launches
    mesh = res["cano_mesh"]
    n_tris = int(mesh.num_tris)
    checks = [mesh.vertices, mesh.normals, res["live_mesh"].vertices,
              res["front_avatar_normal"], res["back_avatar_normal"],
              *res["cano_phong"]]
    if not all(bool(torch.isfinite(t).all()) for t in checks):
        raise AssertionError("frame outputs are not finite")
    if n_tris <= 0:
        raise AssertionError("frame produced no triangles")
    out = {"seconds": secs, "k1_launches": launches, "num_tris": n_tris,
           "overflow": bool(res["overflow"])}
    if device.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return res, out


def stage_times(capture, item, device):
    """Seconds of each frame stage, synchronised around each."""
    import torch
    from avatarcap_tpu_torch.pipeline.avatar import FrameInputs
    dev = capture.device
    out = {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        result = fn()
        _sync(device)
        out[name] = time.perf_counter() - t0
        return result

    with torch.inference_mode():
        frame = FrameInputs(
            torch.as_tensor(item["live_smpl_v"], device=dev)[None],
            torch.as_tensor(item["cano2live_jnt_mats"], device=dev)[None],
            torch.as_tensor(item["smpl_pos_map"], device=dev)[None])
        mesh, _ = timed("geometry",
                        lambda: capture.avatar_geometry_stage(frame))
        timed("cano_layers", lambda: capture.cano_layers_stage(mesh))
        timed("skinning", lambda: capture.skinning_stage(
            mesh, frame.cano2live_jnt_mats[0]))
    return out


def check_small_frame(device):
    """The avatar-only frame on a small subject, on the card and on the
    CPU, through the f32 module path (use_fused_query=False) and through
    K1 (its plain version on the CPU)."""
    import torch
    small = dict(CAPTURE_OPTIONS, max_tris=1 << 15, max_active=1 << 13,
                 refine_capacity=1 << 16, raster_max_candidates=0,
                 render_res=128, skin_row_group=1)
    report = {}
    for fused in (False, True):
        opts = dict(small, use_fused_query=fused)
        outs = {}
        for dev in (device, torch.device("cpu")):
            cap, item, _ = build_subject(dev, vol_res=(48, 48, 32),
                                         dense=False, seed=1, options=opts)
            res = cap.process_frame(item, w_recon=False, w_nerf=False)
            outs[dev.type] = res
        a, b = outs[device.type], outs["cpu"]
        ta, tb = int(a["cano_mesh"].num_tris), int(b["cano_mesh"].num_tris)
        na = a["front_avatar_normal"].cpu()
        nb = b["front_avatar_normal"]
        agree = float(((na - nb).abs().max(-1).values < 1e-2).float().mean())
        key = "fused" if fused else "f32"
        report[key] = {"num_tris_card": ta, "num_tris_cpu": tb,
                       "normal_pixels_agreeing": agree}
        if ta <= 0 or abs(ta - tb) > 0.01 * tb or agree < 0.99:
            raise AssertionError(f"small frame ({key}) differs between the "
                                 f"card and the CPU: {report[key]}")
    return report


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import avatarcap_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: avatarcap_tpu_torch not found next to this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    record = {}
    t_all = time.perf_counter()

    record["build"] = build_kernels()

    t0 = time.perf_counter()
    capture, item, n_valid = build_subject(device)
    record["subject"] = {"seconds": time.perf_counter() - t0,
                         "grid_valid_points": n_valid,
                         "vol_res": list(capture.grid.vol_res)}
    print(f"[subject] {record['subject']}")

    recorded, n_refined = k1_launch_inputs(capture, item)
    k1 = check_k1(capture, recorded, device)
    k1["refined_nodes"] = n_refined
    del recorded
    print(f"[k1] {json.dumps(k1)}")

    _, frame = run_frame(capture, item, device)
    k1["launches"] = frame["k1_launches"]
    if frame["k1_launches"] != 2:
        raise AssertionError(f"K1 launched {frame['k1_launches']} times in "
                             "the frame, expected 2 (coarse + refine)")
    frame["stages"] = stage_times(capture, item, device)
    record["frame"] = frame
    print(f"[frame] {json.dumps(frame)}")

    record["small_frame"] = check_small_frame(device)
    print(f"[small] {json.dumps(record['small_frame'])}")

    kernels_line = {"kernels": [{k: k1[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "tolerance", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    record["k1"] = k1
    record["gpu"] = smi
    record["seconds"] = time.perf_counter() - t_all
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
