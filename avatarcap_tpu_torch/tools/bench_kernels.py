"""Kernel-only times of the port's CUDA kernels on one NVIDIA GPU
(counterpart of avatarcap_tpu/tools/bench_kernels.py).

K1 (warp_template_query), K2 (recon_decode), K2w (recon_decode on PIFu's
decoder, csrc/recon_decode_wide.cu; ``k2w``), K3 (ray_color_query), K4
(template_query) and K5 (offset_query) on seeded random inputs at the
launch shapes of the full-size capture frame (K2w at K2's), with random
weights at the published widths; the nearest-vertex distance (``knn``,
csrc/nearest_vertex.cu) at the textured frame's two anchor launches and a
train item's, against the toy body, beside knn_plain on the card at the
caller's chunk and the float32 issue bound; and the normal-fusion merge (``merge``,
csrc/normal_merge.cu) at the frame's 512^2 and 100 steps on a seeded
synthetic pair (``merge_inputs``), its row timing the whole call (masks,
distance transform, kernel, blend) beside the plain path's on the card,
with its launches. Per launch: the CUDA-event mean over ``--reps`` launches
after a warm-up, the achieved TFLOP/s (2 x multiply-adds of the packed
shapes), the bound (the larger of operations over the bf16 peak and bytes
over the memory rate) and the bound's share of the measured time; and the
largest difference from the plain PyTorch version on the first
``--check`` points (rays) of the launch; and a SHA-1 of the launch's
outputs, which two trees' runs in one call compare for bit equality. K2's
and K2w's rows also give the weight image's bytes and build time, the
bytes the tiles pull from L2 per launch (tiles x the chunks a tile takes,
K2w's layer 0 twice) and that pull's rate.
Prints the card's name and power limit and, last, one JSON line. Raises
without a CUDA device.

With ``--waves``, also K2 alone at 33, 66, 132 and 264 tiles of 128
points, launched from a CUDA graph (the wrapper's host time, ~60 us a
call, would otherwise set the time of so short a launch): on the card's
132 SMs, equal times up to 132 tiles (one wave) mean that a tile's time
is set inside its SM, not by the L2 that all SMs share.

Usage: python -m avatarcap_tpu_torch.tools.bench_kernels [--only k1,knn,merge]
       [--waves]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# launch shapes of the textured production frame at the capture size
K1_POINTS = {"refine": 1966080, "coarse": 1155072}
K2_POINTS = {"coarse": 1155072, "refine": 262144}
K3_RAYS = {"avatar": 294912, "recon": 131072}
K3_SAMPLES, K3_ANCHORS = 64, 4
K45_POINTS = 1155072
MERGE_SIDE, MERGE_ITERS = 512, 100
# nearest_vertex's queries: the textured frame's anchors (4 a unique ray of
# the avatar soup, 294,912, and of ReconNet's, 360,448) and a train item's
# posed samples; each launch at its caller's knn_plain chunk
KNN_QUERIES = {"frame_avatar": (1179648, 65536),
               "frame_recon": (1441792, 65536),
               "train_item": (65536, 16384)}
# H100 SXM float32 lanes: 132 SMs x 128 at the 1,980 MHz boost clock
# (67 TFLOP/s counts an FMA as two); a pair takes 6 at the least: q.v's
# multiply and two FMAs, the FMA with |q|^2, the add of |v|^2, a minimum
PEAK_F32_LANE_OPS = 132 * 128 * 1.98e9
KNN_OPS_PER_PAIR = 6
# the merge kernel against its plain version (merge_agreement)
MERGE_TOL, MERGE_SHARE = 1e-3, 0.99


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches after one warm-up, by
    CUDA events on the current stream (utils/timers.mean_ms on the
    current card)."""
    from avatarcap_tpu_torch.utils.timers import mean_ms
    return mean_ms(fn, reps, torch.device("cuda",
                                          torch.cuda.current_device()))[0]


def launch_bound(n: int, macs_per_point: int, bytes_per_point: float,
                 weight_bytes: int) -> dict:
    """The least time the card could take for n points: the larger of the
    bf16 operations over the peak rate and the bytes (each input read once,
    each output written once, the packed weights once) over the memory
    rate."""
    flops = 2.0 * macs_per_point * n
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (n * bytes_per_point + weight_bytes) / PEAK_BYTES_PER_S * 1e3
    return {"flops": flops, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _weight_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _row(name, launch, n, ms, bound, err):
    return {"name": name, "launch": launch, "points": n, "ms": ms,
            "tflops": bound["flops"] / (ms * 1e-3) / 1e12,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "share_of_bound": bound["bound_ms"] / ms, "max_abs_err": err}


def _max_err(got, ref) -> float:
    return max(float((g - r).abs().max()) for g, r in zip(got, ref))


def outputs_sha1(outputs) -> str:
    """SHA-1 of the outputs' bytes, in order (equal hashes: equal bits)."""
    h = hashlib.sha1()
    for t in outputs:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def recon_image_record(fq, packed, tiles_by_launch, kind="recon"):
    """K2's weight image (``kind="recon_wide"``: K2w's): its bytes and
    build time (CUDA events around one build after a warm-up), and per
    launch the bytes its tiles pull from L2 (each 128-point tile streams
    the whole image; K2w's tiles stream layer 0's 512 KB twice). None
    where the package has no such image."""
    build = getattr(fq, f"{kind}_weight_image", None)
    if build is None:
        return None
    image, bias = build(packed)
    ms = event_ms(lambda: build(packed), 1)
    nbytes = image.numel() * image.element_size()
    pulled = nbytes + (packed[0].numel() * 2 if kind == "recon_wide" else 0)
    return {"bytes": nbytes, "bias_bytes": bias.numel() * 4, "build_ms": ms,
            "l2_bytes": {k: t * pulled for k, t in tiles_by_launch.items()}}


def _ray_inputs(n, n_anchors, device, gen):
    base = torch.rand((n, 3), generator=gen) * 1.2 - 0.6
    nrm = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                        dim=-1)
    pf = torch.randn((2, n, 64), generator=gen).to(torch.bfloat16)
    danch = torch.rand((n, n_anchors), generator=gen) * 0.16
    bounds = torch.tensor([[-0.7, -0.7, -0.7], [0.7, 0.7, 0.7]])
    return [t.to(device) for t in (base + nrm, -nrm, pf[0], pf[1], danch,
                                   bounds)]


def merge_inputs(side: int, seed: int = 0, cover: float = 0.25):
    """A seeded (src, tar) pair shaped like the capture's merge inputs,
    (side, side, 3) float32 numpy: the normals of a wrinkled ellipsoid
    covering the image's middle as the avatar's, and a normal facing the
    camera, tilted by U(+-0.15) in x and y plus N(0, 0.05) per pixel,
    normalised, on a central square of ``cover`` x side as the image's
    (the benchmark's inferred normal map). At 512 and the default cover
    they overlap on ~16,000 pixels, as the benchmark's frames do (~17,600
    valid pixels)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    dx = (xx - side / 2) / (0.42 * side)
    dy = (yy - side / 2) / (0.55 * side)
    inside = dx ** 2 + dy ** 2 < 1
    n = np.stack([dx + 0.05 * np.sin(yy * (80.0 / side)), dy,
                  np.sqrt(np.clip(1 - dx ** 2 - dy ** 2, 0, 1))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    src = np.where(inside[..., None], n, 0).astype(np.float32)
    w = int(round(cover * side))
    lo = (side - w) // 2
    t = np.zeros((w, w, 3), np.float32)
    t[..., 2] = 1.0
    t[..., :2] += rng.uniform(-0.15, 0.15, 2).astype(np.float32)
    t += 0.05 * rng.standard_normal(t.shape).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    tar = np.zeros((side, side, 3), np.float32)
    tar[lo:lo + w, lo:lo + w] = t
    return src, tar


def kernel_device_ms(fn, name: str, reps: int):
    """Mean device ms a call of the kernels whose name holds ``name``,
    from a torch.profiler trace of ``reps`` calls; None where the trace
    holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if name in e.key)
    return us * 1e-3 / reps if us else None


def merge_agreement(src, tar, neck, iters: int) -> dict:
    """The merge's kernel path against merge_normal_images_plain on the
    same card: per pixel the largest channel difference, its max and the
    share of pixels within 1e-4, whether the two are equal to the bit (at
    512^2 on an H100 they are: csrc/normal_merge.cu follows the plain
    path's rounding), and ``ok``: every pixel within MERGE_TOL and
    MERGE_SHARE of them within 1e-4."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    got = nf.merge_normal_images(src, tar, neck, iters)
    ref = nf.merge_normal_images_plain(src, tar, neck, iters)
    d = (got - ref).abs().amax(-1)
    rec = {"max_abs_err": float(d.max()),
           "share_within_1e-4": float((d <= 1e-4).float().mean()),
           "bitwise": bool(torch.equal(got, ref))}
    rec["ok"] = bool(torch.isfinite(got).all()) and (
        rec["share_within_1e-4"] >= MERGE_SHARE
        and rec["max_abs_err"] <= MERGE_TOL)
    return rec


def merge_row(dev, seed: int, reps: int, side: int = MERGE_SIDE,
              iters: int = MERGE_ITERS) -> dict:
    """The merge at the frame's shapes: ms of a call (kernel path: masks,
    distance transform, the launch, blend) and of the kernel alone, the
    plain path's ms on the card, the kernel's bound (its inputs and
    output over the memory rate), launches a call, merge_agreement, a
    SHA-1 of the output."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    src, tar = (torch.as_tensor(a).to(dev) for a in merge_inputs(side, seed))
    neck = (side // 2, side // 2 - 40)

    def call():
        return nf.merge_normal_images(src, tar, neck, iters)

    def plain():
        return nf.merge_normal_images_plain(src, tar, neck, iters)
    before = nf.merge_normal_images.launches
    got = call()
    launches = nf.merge_normal_images.launches - before
    # src, tar and the output (f32, 3 channels) and the mask (1 byte)
    nbytes = side ** 2 * (3 * 4 * 3 + 1)
    return {"name": "normal_merge", "launch": "merge", "points": side ** 2,
            "steps": iters, "ms": event_ms(call, reps),
            "kernel_ms": kernel_device_ms(call, "normal_merge_kernel", reps),
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "plain_ms": event_ms(plain, 1), "launches": launches,
            **merge_agreement(src, tar, neck, iters),
            "sha1": outputs_sha1([got])}


def knn_agreement(d, i, d_ref, i_ref) -> dict:
    """nearest_vertex's outputs (d, i) against knn_plain's on the same
    queries: the d2 rows whose bits differ, the indices that differ (0
    and 0: the kernel repeats the plain path's rounding and keeps the
    first index of a minimum, as its min does) and the largest |d - d_ref|."""
    return {"max_abs_err": float((d - d_ref).abs().max()) if d.numel()
            else 0.0,
            "d2_bits_differ": int((d.view(torch.int32)
                                   != d_ref.view(torch.int32)).sum()),
            "idx_differ": int((i != i_ref).sum())}


def knn_rows(dev, seed: int, reps: int) -> list:
    """nearest_vertex at KNN_QUERIES' launches against the toy body: ms
    (CUDA events), knn_plain's ms on the card at the caller's chunk, the
    bound (pairs x KNN_OPS_PER_PAIR over the float32 lanes' rate),
    knn_agreement over every row of the launch, and a SHA-1 of its
    outputs. Queries lie within a few cm of the body's vertices, as the
    anchors do."""
    from avatarcap_tpu_torch.ops import knn as K
    from avatarcap_tpu_torch.tools.bench_workloads import toy_avatar_statics
    v = toy_avatar_statics(dense=True, device=dev)[1].cano_smpl_vertices
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for launch, (n, chunk) in KNN_QUERIES.items():
        pick = torch.randint(0, v.shape[0], (n,), generator=gen)
        q = (v[pick.to(dev)]
             + (torch.randn((n, 3), generator=gen) * 0.03).to(dev))
        d, i = K.nearest_vertex(q, v)
        agree = knn_agreement(d, i, *K.knn_plain(q, v, 1, chunk))
        pairs = n * v.shape[0]
        ms = event_ms(lambda: K.nearest_vertex(q, v), reps)
        bound = pairs * KNN_OPS_PER_PAIR / PEAK_F32_LANE_OPS * 1e3
        rows.append({
            "name": "nearest_vertex", "launch": launch, "points": n,
            "vertices": v.shape[0], "ms": ms, "bound_ms": bound,
            "bound_by": "float32 issue", "share_of_bound": bound / ms,
            "plain_ms": event_ms(lambda: K.knn_plain(q, v, 1, chunk), 1),
            **agree, "sha1": outputs_sha1([d, i])})
        del q, d, i
    return rows


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches captured in one CUDA
    graph and replayed (no host time between launches), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k2_waves(fq, packed, device, gen, reps: int) -> dict:
    """ms of one K2 launch at 33, 66, 132 and 264 tiles of 128 points."""
    out = {}
    for tiles in (33, 66, 132, 264):
        feats = torch.randn((tiles * 128, fq.RECON_IN_DIM),
                            generator=gen).to(device)
        out[tiles] = graph_ms(lambda: fq.recon_decode(packed, feats), reps)
    return out


def k2w_rows(fq, dev, gen, seed: int, reps: int, check: int) -> list:
    """K2w (recon_decode on PIFu's decoder, random weights from seed + 2)
    at K2's launch shapes: its rows, as K2's."""
    from avatarcap_tpu_torch.models.recon import PIFU_SHAPE_NETWORK
    from avatarcap_tpu_torch.tools.bench_workloads import random_recon
    with torch.no_grad():
        pk = fq.pack_recon_weights(random_recon(
            torch.Generator().manual_seed(seed + 2), **PIFU_SHAPE_NETWORK)
            .to(dev).image_decoder)
    image = recon_image_record(
        fq, pk, {k: -(-n // 128) for k, n in K2_POINTS.items()},
        kind="recon_wide")
    rows = []
    for launch, n in K2_POINTS.items():
        feats = torch.randn((n, fq.RECON_WIDE_IN_DIM), generator=gen).to(dev)
        err = _max_err([fq.recon_decode(pk, feats[:check])],
                       [fq.recon_decode_wide_plain(pk, feats[:check])])
        ms = event_ms(lambda: fq.recon_decode(pk, feats), reps)
        # 257 f32 in, 1 f32 out per point
        rows.append(_row("recon_decode_wide", launch, n, ms,
                         launch_bound(n, fq.RECON_WIDE_MACS_PER_POINT,
                                      fq.RECON_WIDE_IN_DIM * 4 + 4,
                                      _weight_bytes(pk)), err))
        rows[-1]["sha1"] = outputs_sha1([fq.recon_decode(pk, feats)])
        l2 = image["l2_bytes"][launch]
        rows[-1].update(image_bytes=image["bytes"],
                        image_build_ms=image["build_ms"], l2_bytes=l2,
                        l2_tb_per_s=l2 / (ms * 1e-3) / 1e12)
        del feats
    return rows


def bench(only, reps: int, check: int, seed: int, waves: bool = False):
    from avatarcap_tpu_torch.ops import fused_query as fq
    from avatarcap_tpu_torch.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.tools.bench_workloads import (random_avatar,
                                                           random_recon)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        pk = pack_fused_query_weights(random_avatar(gen).to(dev))
        pk_recon = fq.pack_recon_weights(
            random_recon(torch.Generator().manual_seed(seed + 1))
            .to(dev).image_decoder)
    off, tpl = pk["offset"], pk["template"]
    rows = []
    with torch.inference_mode():
        n_max = max(K1_POINTS.values())
        pts = (torch.rand((n_max, 3), generator=gen) * 1.6 - 0.8).to(dev)
        pf = torch.randn((n_max, 64), generator=gen).to(dev)
        if "k1" in only:
            for launch, n in K1_POINTS.items():
                p, f = pts[:n], pf[:n]
                got = fq.warp_template_query(off, tpl, p[:check], f[:check])
                ref = fq.warp_template_query_plain(off, tpl, p[:check],
                                                   f[:check])
                err = _max_err(got.values(), (ref[k] for k in got))
                ms = event_ms(lambda: fq.warp_template_query(off, tpl, p, f),
                              reps)
                rows.append(_row("warp_template_query", launch, n, ms,
                                 launch_bound(n, fq.MACS_PER_POINT,
                                              3 * 4 + 64 * 2 + 8 * 4,
                                              _weight_bytes(off + tpl)), err))
                rows[-1]["sha1"] = outputs_sha1(
                    fq.warp_template_query(off, tpl, p, f).values())
        if "k4" in only:
            p = pts[:K45_POINTS]
            err = _max_err(fq.template_query(tpl, p[:check]),
                           fq.template_query_plain(tpl, p[:check]))
            ms = event_ms(lambda: fq.template_query(tpl, p), reps)
            rows.append(_row("template_query", "coarse", K45_POINTS, ms,
                             launch_bound(K45_POINTS,
                                          fq.TEMPLATE_MACS_PER_POINT,
                                          3 * 4 + 5 * 4, _weight_bytes(tpl)),
                             err))
            rows[-1]["sha1"] = outputs_sha1(fq.template_query(tpl, p))
        if "k5" in only:
            feats = torch.cat([pts[:K45_POINTS], pf[:K45_POINTS]], -1)
            err = _max_err([fq.offset_query(off, feats[:check])],
                           [fq.offset_query_plain(off, feats[:check])])
            ms = event_ms(lambda: fq.offset_query(off, feats), reps)
            rows.append(_row("offset_query", "coarse", K45_POINTS, ms,
                             launch_bound(K45_POINTS,
                                          fq.OFFSET_MACS_PER_POINT,
                                          fq.OFFSET_IN_DIM * 4 + 3 * 4,
                                          _weight_bytes(off)), err))
            rows[-1]["sha1"] = outputs_sha1([fq.offset_query(off, feats)])
        del pts, pf
        if "k2" in only:
            image = recon_image_record(
                fq, pk_recon, {k: -(-n // 128) for k, n in K2_POINTS.items()})
            for launch, n in K2_POINTS.items():
                feats = torch.randn((n, fq.RECON_IN_DIM), generator=gen).to(dev)
                err = _max_err([fq.recon_decode(pk_recon, feats[:check])],
                               [fq.recon_decode_plain(pk_recon,
                                                      feats[:check])])
                ms = event_ms(lambda: fq.recon_decode(pk_recon, feats), reps)
                rows.append(_row("recon_decode", launch, n, ms,
                                 launch_bound(n, fq.RECON_MACS_PER_POINT,
                                              fq.RECON_IN_DIM * 4 + 4,
                                              _weight_bytes(pk_recon)), err))
                rows[-1]["sha1"] = outputs_sha1([fq.recon_decode(pk_recon,
                                                                 feats)])
                if image is not None:
                    l2 = image["l2_bytes"][launch]
                    rows[-1].update(image_bytes=image["bytes"],
                                    image_build_ms=image["build_ms"],
                                    l2_bytes=l2,
                                    l2_tb_per_s=l2 / (ms * 1e-3) / 1e12)
            if waves:
                rows[-1]["waves_ms"] = k2_waves(fq, pk_recon, dev, gen, reps)
        if "k2w" in only:
            rows += k2w_rows(fq, dev, gen, seed, reps, check)
        if "k3" in only:
            kw = dict(n_samples=K3_SAMPLES, near=0.98, far=1.05,
                      threshold=0.08)
            per_ray = ((3 + 3 + K3_ANCHORS + 3) * 4
                       + 2 * fq.POSE_FEAT_DIM * 2)
            for launch, n in K3_RAYS.items():
                rays = _ray_inputs(n, K3_ANCHORS, dev, gen)
                head = [t[:check // 16] for t in rays[:5]] + rays[5:]
                err = _max_err(
                    [fq.ray_color_query(off, tpl, *head, **kw)],
                    [fq.ray_color_query_plain(off, tpl, *head, **kw)])
                ms = event_ms(
                    lambda: fq.ray_color_query(off, tpl, *rays, **kw),
                    max(1, reps // 3))
                rows.append(_row("ray_color_query", launch, n * K3_SAMPLES,
                                 ms, launch_bound(n * K3_SAMPLES,
                                                  fq.MACS_PER_POINT,
                                                  per_ray / K3_SAMPLES,
                                                  _weight_bytes(off + tpl)),
                                 err))
                rows[-1]["sha1"] = outputs_sha1(
                    [fq.ray_color_query(off, tpl, *rays, **kw)])
        if "knn" in only:
            rows += knn_rows(dev, seed, reps)
        if "merge" in only:
            rows.append(merge_row(dev, seed, reps))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="k1,k2,k2w,k3,k4,k5,knn,merge",
                    help="comma-separated kernels to run")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--check", type=int, default=65536,
                    help="points held against the plain version (K3: a "
                         "sixteenth as many rays)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--waves", action="store_true",
                    help="also time K2 at 33, 66, 132 and 264 tiles")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_kernels times the CUDA kernels: it needs "
                           "an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    rows = bench(set(args.only.split(",")), args.reps, args.check, args.seed,
                 args.waves)
    smi = gpu_name_and_power_limit()
    for r in rows:
        if r["name"] == "normal_merge":
            kern = ("not measured" if r["kernel_ms"] is None
                    else f"{r['kernel_ms']:.3f} ms")
            print(f"{r['name']:>20} {r['launch']:>7} {r['points']:>10} px   "
                  f"{r['ms']:9.3f} ms (kernel {kern}, bound "
                  f"{r['bound_ms']:.4f} ms)  plain {r['plain_ms']:9.3f} ms  "
                  f"{r['launches']} launch  err {r['max_abs_err']:.3e} "
                  f"({100 * r['share_within_1e-4']:.3f}% within 1e-4; "
                  f"{'equal bits' if r['bitwise'] else 'not bitwise'})  "
                  f"sha1 {r['sha1'][:12]}")
            continue
        if r["name"] == "nearest_vertex":
            print(f"{r['name']:>20} {r['launch']:>12} {r['points']:>8} x "
                  f"{r['vertices']}  {r['ms']:8.3f} ms  bound "
                  f"{r['bound_ms']:.3f} ms ({100 * r['share_of_bound']:4.1f}%"
                  f" of the float32 issue rate)  plain {r['plain_ms']:9.3f} "
                  f"ms  d2 bits differ {r['d2_bits_differ']}, idx differ "
                  f"{r['idx_differ']}  sha1 {r['sha1'][:12]}")
            continue
        l2 = (f"  L2 {r['l2_tb_per_s']:.2f} TB/s" if "l2_tb_per_s" in r
              else "")
        print(f"{r['name']:>20} {r['launch']:>7} {r['points']:>10} pts  "
              f"{r['ms']:9.3f} ms  {r['tflops']:6.1f} TFLOP/s  bound "
              f"{r['bound_ms']:7.3f} ms ({100 * r['share_of_bound']:4.1f}%)  "
              f"err {r['max_abs_err']:.3e}  sha1 {r['sha1'][:12]}{l2}")
        if "waves_ms" in r:
            print("    K2 ms at " + ", ".join(
                f"{t} tiles {ms:.4f}" for t, ms in r["waves_ms"].items()))
    print(smi)
    print(json.dumps({"gpu": smi, "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
                      "seconds": time.perf_counter() - t0, "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
