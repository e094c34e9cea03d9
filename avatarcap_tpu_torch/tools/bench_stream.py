"""Measurements of the streaming and sharding slice on the card, run by
chip_smoke.py's [sync], [stream] and [shard] phases on its full-size
capture subject:

- ``sync_counts``: the synchronising calls that
  ``torch.cuda.set_sync_debug_mode("warn")`` reports inside
  ``AvatarCapture.frame_body``, per frame form, with their places;
- ``stream_phase``: a sequence of distinct poses through a
  ``process_frame`` loop and through ``StreamingCapture.run_pipelined``:
  frames per second, per-frame output hashes, kernel launches, and the
  card's busy share over the pipelined run from a ``torch.profiler`` trace
  (a separate run, so the profiler stays out of the timed numbers);
- ``shard_phase``: the production frame point-sharded over every visible
  card and over two slabs on the first, against the unsharded frame, and
  ``ShardedGridQuery`` against the unsharded query;
- ``mesh_run_phase``: ``StreamingCapture.run`` with frames sharded over
  every visible card, against a ``process_frame`` loop on the first.

Every function takes a constructed AvatarCapture on a card. Run alone,
on the capture workload over every visible card::

    python -m avatarcap_tpu_torch.tools.bench_stream [--only shard,run]

prints one JSON line per phase (sync, stream, shard, run) between two
lines with the card's name and power limit.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from avatarcap_tpu_torch.fusion.normal_fusion import merge_normal_images
from avatarcap_tpu_torch.ops import fused_query as fq
from avatarcap_tpu_torch.ops import knn as knn_ops
from avatarcap_tpu_torch.tools.bench_kernels import outputs_sha1

FORMS = {"avatar_only": dict(w_recon=False, w_nerf=False),
         "w_recon": dict(w_recon=True, w_nerf=False),
         "w_recon_w_nerf": dict(w_recon=True, w_nerf=True)}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _wrappers() -> Dict[str, object]:
    """The kernels' wrappers, K1 to K5, the normal-fusion merge and the
    nearest-vertex distance, each counting its launches."""
    return {"k1": fq.warp_template_query, "k2": fq.recon_decode,
            "k3": fq.ray_color_query, "k4": fq.template_query,
            "k5": fq.offset_query, "merge": merge_normal_images,
            "knn": knn_ops.nearest_vertex}


def _zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    fq.recon_decode.wide_launches = 0


def _launches() -> Dict[str, int]:
    """Each kernel's launches since _zero_launches: K1 to K5, the merge,
    the nearest-vertex distance, and K2w
    (``recon_decode.wide_launches``)."""
    return {**{k: fn.launches for k, fn in _wrappers().items()},
            "k2w": fq.recon_decode.wide_launches}


def _tensors(tree) -> List[torch.Tensor]:
    """A frame's result tensors in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def frame_sha1(results: dict) -> str:
    """SHA-1 of every output tensor of a frame (equal hashes: equal
    bits)."""
    return outputs_sha1(_tensors(results))


def sync_counts(capture, item: dict, recon_kw: dict) -> Dict[str, dict]:
    """Per frame form: the synchronising calls inside frame_body (its
    inputs uploaded before), as the sync debug mode's warnings count them,
    and the places (file:line) they were made from."""
    dev = capture.device
    frame, jnt, normal, w2c = capture.upload(item,
                                             recon_kw["inferred_normal"])
    neck = capture._neck_xy(recon_kw["neck_vertex_idx"])
    out = {}
    for name, form in FORMS.items():
        torch.cuda.synchronize(dev)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = capture.frame_body(frame, jnt, normal, w2c,
                                         recon_kw["camera"], neck, **form)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught if "called a synchronizing CUDA "
                 "operation" in str(w.message)]
        places = {}
        for w in syncs:
            key = f"{os.path.relpath(w.filename, _ROOT)}:{w.lineno}"
            places[key] = places.get(key, 0) + 1
        out[name] = {"syncs": len(syncs), "places": places}
        del res
        torch.cuda.synchronize(dev)
    return out


def stream_items(item: dict, n: int, seed: int = 7) -> List[dict]:
    """n frames of distinct poses around ``item``: position maps perturbed
    by 0.02 N(0, 1) and every joint shifted by U(+-2 cm), from a fixed
    generator."""
    gen = torch.Generator().manual_seed(seed)
    items = []
    for _ in range(n):
        pos = np.asarray(item["smpl_pos_map"], np.float32)
        jm = np.array(item["cano2live_jnt_mats"], np.float32)
        pos = pos + 0.02 * torch.randn(pos.shape, generator=gen).numpy()
        jm[:, :3, 3] += (torch.rand((jm.shape[0], 3), generator=gen).numpy()
                         * 0.04 - 0.02)
        items.append(dict(item, smpl_pos_map=pos, cano2live_jnt_mats=jm))
    return items


def device_events(prof, kernels_only: bool = False):
    """(name, start ns, duration ns) of every card activity in a finished
    torch.profiler trace; with ``kernels_only``, without the copies and
    fills (Memcpy, Memset)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if kernels_only and e.name().startswith(("Memcpy", "Memset")):
            continue
        out.append((e.name(), e.start_ns(), e.duration_ns()))
    return out


def union_ns(spans) -> int:
    """The length of the union of (start, end) intervals."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def busy_share(run, device) -> dict:
    """Run ``run()`` under torch.profiler (card activity only) and return
    the union of the kernels' intervals over the span from the first
    kernel's start to the last one's end, the kernel count, and the
    host-clock seconds of the profiled run. None values when the trace
    holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    spans = [(start, start + dur)
             for _, start, dur in device_events(prof, kernels_only=True)]
    if not spans:
        return {"busy_share": None, "kernels": 0, "profiled_s": seconds}
    spans.sort()
    busy = union_ns(spans)
    span = spans[-1][1] - spans[0][0]
    return {"busy_share": busy / span, "kernels": len(spans),
            "busy_s": busy * 1e-9, "span_s": span * 1e-9,
            "profiled_s": seconds}


def stream_phase(capture, item: dict, recon_kw: dict, n_frames: int = 8,
                 lookahead: int = 2) -> dict:
    """The textured production frame on n_frames distinct poses: a
    process_frame loop, then run_pipelined, each timed on the host clock
    from its first call to the card's end, with the launch counts set to 0
    just before and read just after; each frame's output hash must agree
    between the two; then the busy share of a third, profiled pipelined
    run."""
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    dev = capture.device
    items = stream_items(item, n_frames)
    kw = dict(w_recon=True, w_nerf=True)
    normals = [recon_kw["inferred_normal"]] * n_frames
    sc = StreamingCapture(
        capture, make_mesh([dev]), camera=recon_kw["camera"],
        image_size=recon_kw["inferred_normal"].shape[:2],
        neck_vertex_idx=recon_kw["neck_vertex_idx"], **kw)
    runs = {}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        _zero_launches()
        t0 = time.perf_counter()
        results = fn()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        runs[name] = {"seconds": secs, "frames_per_s": n_frames / secs,
                      "s_per_frame": secs / n_frames,
                      "launches": _launches(),
                      "sha1": [frame_sha1(r) for r in results],
                      "num_tris": [int(r["cano_mesh"].num_tris)
                                   for r in results],
                      "recon_num_tris": [int(r["recon_mesh"].num_tris)
                                         for r in results]}
        del results

    timed("loop", lambda: [capture.process_frame(it, **kw, **recon_kw)
                           for it in items])
    timed("pipelined", lambda: sc.run_pipelined(items, normals,
                                                lookahead=lookahead))
    runs["hashes_agree"] = runs["loop"]["sha1"] == runs["pipelined"]["sha1"]
    runs["distinct_poses"] = len(set(runs["loop"]["sha1"])) == n_frames
    runs["profile"] = busy_share(
        lambda: sc.run_pipelined(items, normals, lookahead=lookahead), dev)
    runs["frames"] = n_frames
    runs["lookahead"] = lookahead
    return runs


def shard_phase(capture, item: dict, recon_kw: dict) -> dict:
    """The production frame with shard_mesh=make_mesh() (every visible
    card) and with two slabs on the capture's card, each against the
    unsharded frame by its output hash."""
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    dev = capture.device
    kw = dict(w_recon=True, w_nerf=False, **recon_kw)
    ref = frame_sha1(capture.process_frame(item, **kw))
    out = {"unsharded_sha1": ref, "meshes": {}}
    for name, mesh in (("all_cards", make_mesh()),
                       ("two_slabs", make_mesh([dev, dev]))):
        sharded = AvatarCapture(capture.avatar, capture.statics,
                                capture.grid, recon=capture.recon,
                                tex_avatar=capture.tex_avatar,
                                options=capture.opt, device=dev,
                                shard_mesh=mesh)
        _zero_launches()
        got = frame_sha1(sharded.process_frame(item, **kw))
        out["meshes"][name] = {"devices": [str(d) for d in mesh],
                               "sha1": got, "bit_equal": got == ref,
                               "launches": _launches()}
        del sharded
    return out


def mesh_run_phase(capture, item: dict, recon_kw: dict, n_frames: int = 8,
                   frames_per_device: int = 1) -> dict:
    """The textured production frame on n_frames distinct poses through
    StreamingCapture.run over every visible card (contiguous blocks of a
    batch per card), timed on the host clock to the end of every card,
    against a process_frame loop on the capture's card by the frames'
    output hashes."""
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    mesh = make_mesh()
    items = stream_items(item, n_frames)
    kw = dict(w_recon=True, w_nerf=True)
    normals = [recon_kw["inferred_normal"]] * n_frames
    loop = [frame_sha1(capture.process_frame(it, **kw, **recon_kw))
            for it in items]
    sc = StreamingCapture(
        capture, mesh, camera=recon_kw["camera"],
        image_size=recon_kw["inferred_normal"].shape[:2],
        frames_per_device=frames_per_device,
        neck_vertex_idx=recon_kw["neck_vertex_idx"], **kw)
    sc.run(items[:sc.batch], normals[:sc.batch])            # warm-up
    for dev in set(mesh):
        torch.cuda.synchronize(dev)
    _zero_launches()
    t0 = time.perf_counter()
    results = sc.run(items, normals)
    for dev in set(mesh):
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    got = [frame_sha1(r) for r in results]
    return {"devices": [str(d) for d in mesh], "frames": n_frames,
            "frames_per_device": frames_per_device, "seconds": secs,
            "frames_per_s": n_frames / secs, "launches": _launches(),
            "result_devices": [str(r["cano_mesh"].vertices.device)
                               for r in results],
            "hashes_agree": got == loop}


def sharded_query_check(avatar, statics, grid, pos_map, device) -> dict:
    """ShardedGridQuery over every visible card and over two slabs on one,
    against the unsharded f32 query (query_occupancy over every near-body
    point, scattered into the prior)."""
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.parallel.grid_query import ShardedGridQuery
    from avatarcap_tpu_torch.pipeline.avatar import (compute_pose_features,
                                                     query_occupancy)
    from avatarcap_tpu_torch.pipeline.capture import _scatter_set
    grid = grid.to(device)
    statics = statics.to(device)
    pos_map = torch.as_tensor(pos_map, dtype=torch.float32).to(device)
    with torch.inference_mode():
        avatar = avatar.to(device).eval()
        feat = compute_pose_features(avatar, pos_map)
        occ = query_occupancy(avatar, grid.valid_pts[None], feat, statics)
        ref = _scatter_set(grid.prior_volume, grid.valid_idx,
                           occ["cano_pts_ov"][0, :, 0])
    out = {"points": int(grid.valid_pts.shape[0])}
    for name, mesh in (("all_cards", make_mesh()),
                       ("two_slabs", make_mesh([device, device]))):
        got = ShardedGridQuery(avatar, statics, grid, mesh)(pos_map)
        out[name] = {"bit_equal": bool(torch.equal(got, ref)),
                     "max_abs_err": float((got - ref).abs().max())}
    return out


def main(argv=None) -> int:
    import argparse
    import json
    from avatarcap_tpu_torch import kernels
    from avatarcap_tpu_torch.tools.bench_kernels import (
        gpu_name_and_power_limit)
    from avatarcap_tpu_torch.tools.bench_workloads import (
        build_capture_grid, build_capture_subject, random_avatar,
        toy_avatar_statics)
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default="sync,stream,shard,run",
                        help="comma-separated phases to run")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    kernels.build_all()
    capture, item, recon_kw, _ = build_capture_subject(dev)
    for form in FORMS.values():                        # warm-up frames
        capture.process_frame(item, **form, **recon_kw)
    record = {"gpu": smi, "cards": torch.cuda.device_count()}
    if "sync" in only:
        record["sync"] = sync_counts(capture, item, recon_kw)
    if "stream" in only:
        record["stream"] = stream_phase(capture, item, recon_kw)
    if "shard" in only:
        record["shard"] = shard_phase(capture, item, recon_kw)
        params, statics, _ = toy_avatar_statics(dense=False, device=dev)
        grid, _ = build_capture_grid(statics, (48, 48, 32), pad_to=4096)
        gen = torch.Generator().manual_seed(1)
        avatar = random_avatar(gen)
        record["shard"]["query"] = sharded_query_check(
            avatar, statics, grid,
            torch.randn((1, 256, 256, 6), generator=gen) * 0.1, dev)
    if "run" in only:
        record["run"] = mesh_run_phase(capture, item, recon_kw)
    for key in ("sync", "stream", "shard", "run"):
        if key in record:
            print(f"[{key}] {json.dumps(record[key])}", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
