"""Kernel-only times of the port's five CUDA kernels on one NVIDIA GPU
(counterpart of avatarcap_tpu/tools/bench_kernels.py).

K1 (warp_template_query), K2 (recon_decode), K3 (ray_color_query), K4
(template_query) and K5 (offset_query) on seeded random inputs at the
launch shapes of the full-size capture frame, with random weights at the
published widths. Per launch: the CUDA-event mean over ``--reps`` launches
after a warm-up, the achieved TFLOP/s (2 x multiply-adds of the packed
shapes), the bound (the larger of operations over the bf16 peak and bytes
over the memory rate) and the bound's share of the measured time; and the
largest difference from the plain PyTorch version on the first
``--check`` points (rays) of the launch; and a SHA-1 of the launch's
outputs, which two trees' runs in one call compare for bit equality. K2's
row also gives its weight image's bytes and build time, the bytes its
tiles pull from L2 per launch (tiles x image bytes) and that pull's rate.
Prints the card's name and power limit and, last, one JSON line. Raises
without a CUDA device.

With ``--waves``, also K2 alone at 33, 66, 132 and 264 tiles of 128
points, launched from a CUDA graph (the wrapper's host time, ~60 us a
call, would otherwise set the time of so short a launch): on the card's
132 SMs, equal times up to 132 tiles (one wave) mean that a tile's time
is set inside its SM, not by the L2 that all SMs share.

Usage: python -m avatarcap_tpu_torch.tools.bench_kernels [--only k1,k3]
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


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches after one warm-up, by
    CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def recon_image_record(fq, packed, tiles_by_launch):
    """K2's weight image: its bytes and build time (CUDA events around one
    build after a warm-up), and per launch the bytes its tiles pull from
    L2 (each 128-point tile streams the whole image). None where the
    package has no K2 image."""
    build = getattr(fq, "recon_weight_image", None)
    if build is None:
        return None
    image, bias = build(packed)
    ms = event_ms(lambda: build(packed), 1)
    nbytes = image.numel() * image.element_size()
    return {"bytes": nbytes, "bias_bytes": bias.numel() * 4, "build_ms": ms,
            "l2_bytes": {k: t * nbytes for k, t in tiles_by_launch.items()}}


def _ray_inputs(n, n_anchors, device, gen):
    base = torch.rand((n, 3), generator=gen) * 1.2 - 0.6
    nrm = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                        dim=-1)
    pf = torch.randn((2, n, 64), generator=gen).to(torch.bfloat16)
    danch = torch.rand((n, n_anchors), generator=gen) * 0.16
    bounds = torch.tensor([[-0.7, -0.7, -0.7], [0.7, 0.7, 0.7]])
    return [t.to(device) for t in (base + nrm, -nrm, pf[0], pf[1], danch,
                                   bounds)]


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
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="k1,k2,k3,k4,k5",
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
