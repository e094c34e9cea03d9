#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (avatarcap_tpu_torch) on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the root of a checkout; one card)

Phases, each fatal on failure:
  1. build every CUDA kernel from csrc/ (one nvcc per source, all started
     together) and print each ptxas resource report;
  2. build the full-size capture subject: the toy body (6,752 vertices),
     a 384 x 384 x 128 canonical grid, GeoTexAvatar, a texture avatar
     (its copy with a denser density head) and ReconNet at their published
     widths, the capture options (texture path included) and the camera of
     the repo's capture workload; the networks start from fixed
     torch.Generators and are fitted to the toy body with 6 mm wrinkles
     ([fit]: each fit's seconds, final loss and whether the fit cache
     under build/bench_fit/ was hit), as the JAX bench's subject is;
  3. build the weight image K1, K3, K4 and K5 stream (its bytes, chunks and
     build time are printed; the wrappers build it once per packed set);
     hold kernel K1 (warp_template_query) against its plain PyTorch
     version on the inputs of the frame's coarse and refine launches, and
     time kernel, plain version and bound; then K1's two halves, K4
     (template_query) and K5 (offset_query), on the coarse launch's
     points and [points, pose features];
     [query_fused]: pipeline/avatar.query_occupancy_fused (the per-point
     pose-feature fetch in f32, then K1) on the refine launch's 1,966,080
     points with the frame's pose features, its launches counted (1 K1),
     timed beside K1 alone and the fetch alone, and held against its plain
     version (the fetch, then K1's plain version) on 65,536 of them at
     K1's tolerances;
  4. one warm-up and one timed avatar-only capture frame,
     process_frame(item, w_recon=False, w_nerf=False), with the kernel
     launch counts set to 0 just before and read just after the timed
     frame (2 K1 launches, no K2); outputs must be finite with triangles;
     then the synchronised stage times;
  5. the production frame, process_frame(item, w_recon=True,
     w_nerf=False, ...): a warm-up frame, whose merged normals give the
     inputs of the two K2 (recon_decode) launches, recorded through the
     same recon_volume the frame runs; K2 held against its plain version
     on them and timed, beside its weight image's bytes and build time and
     the bytes its tiles pull from L2; [merge]: the normal-fusion merge's
     kernel at the frame's shapes against its plain version on the card,
     one launch a call, times and bound; [pifu]: PIFu's shape network
     as the ReconNet on the subject's avatar, body and grid, its decoder
     fitted to the toy body as the subject's is; 8 untextured production
     frames of distinct poses through StreamingCapture.run_pipelined
     (lookahead 2), the launch counts set to 0 just before and read just
     after (16 K1, 16 K2w, no K2, 8 merges), each frame finite with
     ReconNet triangles; the last frame's merged normals give the inputs
     of its two K2w (recon_decode on PIFu's decoder,
     csrc/recon_decode_wide.cu) launches, the coarse band and the refine
     capacity, on which K2w is held against its plain version and timed
     as K2 is ([k2w], the kernel table's K2w row); then two timed frames
     with the
     launch counts read around each (2 K1, 2 K2 and 1 merge launch), whose
     triangle counts are compared (run-to-run drift), two more with
     torch.backends.cudnn.deterministic = True, and the stage times. The
     drift phase runs the frame's avatar stages (pose features, the grid's
     pose feature columns, coarse field, refine set, refine field, fine
     volume, mesh, skinned mesh) through the frame's own stage functions
     before and after those frames, hashes each stage's output bits (and
     each U-Net module's output) and names the first stage that differs;
     the hashes and the default runs' triangle counts must agree;
  6. the textured production frame, process_frame(item, w_recon=True,
     w_nerf=True, ...): a warm-up frame, whose meshes give the inputs of
     the two K3 (ray_color_query) launches (the avatar's unique vertices
     and the ReconNet's, recorded through the same color stages the frame
     runs); K3 held against its plain version on them and timed; then two
     timed frames with the launch counts read around each (2 K1, 2 K2, 2
     K3 and 1 merge launch), the stage times, and one avatar-only textured
     frame (2 K1, 1 K3, no merge);
     [knn]: the nearest-vertex distance's kernel
     (csrc/nearest_vertex.cu) on the inputs of the textured production
     frame's two anchor launches, recorded from its color stages, and on
     seeded launches of their sizes (1,179,648 and 1,441,792 queries) and
     a train item's (65,536) against the toy body: every row's outputs
     must be knn_plain's bits; timed beside knn_plain on the card and the
     float32 issue bound. Its launches are counted with the other
     kernels': 2 a textured production frame, 1 an avatar-only textured
     frame, 0 in the frames without color and in the PIFu stream, one a
     train item;
     [occupancy]: the fitted subject's avatar weights in
     GeoTexAvatar(if_type="occupancy") at iso_value 0.5 (sigmoid(x) >= 0.5
     iff x >= 0: the SDF frame's surface), through a warm-up and two timed
     textured production frames (the launch counts set to 0 just before
     and read just after each: 2 K1, 2 K2, 2 K3, 1 merge), their triangle
     counts
     beside the SDF frame's, no overflow; then the small subject's three
     frame forms in the occupancy form on the card against the CPU, as
     phase 10 holds the SDF ones;
  7. [capacity]: tools/capacity_stats on the fitted subject, each count
     beside its capacity and the count the JAX package recorded for its
     fitted bench body, and the three frame forms' overflow bits;
     [normal_modes]: the production frame with normal_mode "mc_edge" and
     "sobel_sample" (2 K1 + 2 K2 launches each, overflow, the mean dot
     product of their avatar normals with the trilinear frame's, the
     synchronising calls of frame_body in every form: none), and the small
     production frame in both modes on the card against the CPU at
     phase 10's tolerances;
     [sync]: the synchronising calls that torch.cuda.set_sync_debug_mode
     reports inside AvatarCapture.frame_body, for the avatar-only, the
     production and the textured production frame at full size; there must
     be none;
  8. [stream] (this slice's main path): 8 full-size textured production
     frames of distinct poses through a process_frame loop and through
     StreamingCapture.run_pipelined(lookahead=2), each timed (frames/s,
     seconds a frame) with the launch counts set to 0 just before and read
     just after (the pipelined run: 16 K1, 16 K2, 16 K3); the frames'
     output hashes must agree between the two and differ between poses;
     then the card's busy share over a third, profiled pipelined run
     (torch.profiler: the union of the kernels' intervals over their
     span);
  9. [shard]: the production frame with AvatarCapture(shard_mesh=) over
     every visible card and over two slabs on the first card, and
     ShardedGridQuery on the small subject over the same two meshes, each
     bit-equal to its unsharded counterpart; [preflight]: the peak device
     memory of the production frame, the textured one and a 4-frame
     pipelined stream against the card's budget
     (tools/compile_preflight); [trace]: the top 10 kernels of one
     textured frame by device time with their launches, and each stage's
     launches (tools/trace_frame);
 10. the avatar-only, the production and the textured production frame on
     a small subject on the card and on the CPU (f32 path and kernels),
     which must agree; the textured frame's colors through the kernels on
     the card also against the f32 path on the CPU;
 11. the training phase (tools/bench_train.run); [train_mesh]
     (tools/bench_train.run_mesh): the full-width train step over two
     replicas on the card (and, where more cards are visible, over the
     cards the batch divides among) against the one-device step from one
     state and generator (losses rtol 1e-4, parameters by the step rule),
     the replicas bit-equal after 3 steps, ms, points/s, peak memory and
     busy share per card, the epoch-0 freeze and one finetune step over
     the mesh; [tools]: one short run
     of tools/bench_mc (its tets triangulation included: neither it nor
     the 256-case one may overflow) and one of tools/bench_raster;
 12. the command line ([cli]): the port's generate_subject writes a
     subject (the toy body's 6,752 vertices as an SMPL pkl, the canonical
     and one posed pose, 2 views, 512^2 images, 256^2 position maps,
     20,000 + 2,000 presampled points); cli.main -m train fits it for 2
     epochs and its epoch_latest/net.pt reads back through the test mode's
     loader; the test-mode grid (384 x 384 x 128: KNN band and inside
     prior) is built and timed, and the inside test alone; cli.main -m
     test --nerf --save-avatar-mesh --save-final-mesh runs the subject's
     two full-width textured frames with phase 2's networks saved as
     net.pt / recon_net.pt and the capture options of phase 2, the launch
     counts set to 0 just before and read just after (4 K1, 4 K2, 4 K3);
     the JPEGs and PLYs must exist, the PLYs be finite with triangles, and
     frame 0's avatar PLY's triangle count equal that of process_frame run
     directly on the same dataset item and weights; then the same with
     --stream 2 (one pipelined batch of both frames), whose JPEGs must
     equal the first run's byte for byte and whose PLYs must have its
     triangle counts; then every count of frame 0 beside its capacity
     (tools/capacity_stats) through the kernels and through the f32
     module path, and the rows over capacity; the live position pass's
     inputs go to chiprun_out/cli_live_pass.npz (for
     tests/jax_cli_live_pass.py);
 13. [preprocess] (tools/bench_preprocess.run_scan): a scan made from the
     toy body (posed at the bench pose, subdivided twice to 109,442
     vertices, displaced 6 mm by wrinkle_field, colored by position)
     through preprocess_training_data at the JAX package's defaults (60
     views at 512^2, 256^2 position maps, 2.2 M + 10k presampled points,
     200 fit steps, Poisson at 256^3): seconds per stage, counts, the
     template's mean distance to the scan before and after the fit, peak
     memory; the fit must lower that distance, the Poisson mesh be finite
     without overflow, a second Poisson solve bit-equal, the BVH's labels
     and the card's signed_distance agree on 65,536 points (1e-5, signs
     99.9%), and the port's training dataset read the subject;
     [preprocess_real] (run_real): two 1024^2 real-layout frames through
     preprocess_real_data with a GlobalGenerator(3, 3, 64, 4, 9) from a
     fixed seed on 512^2 crops: seconds per frame; the normal maps finite
     and zero outside the mask, the generator on the card and the CPU
     within 1e-3.
The kernel table's launches are those of phase 8's pipelined run, and
K2w's those of phase 5's [pifu] stream of as many frames.
Prints each kernel's TFLOP/s and the share of its measured time that its
bound explains, the kernel table as one JSON line, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Writes
the detailed record to chiprun_out/chip_smoke.json. Exits non-zero without
a CUDA device, without the package next to it, or on any failed phase.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# K1 tolerances against the plain version: both sum bf16 products in f32,
# in different orders, so a bf16 rounding of an activation can flip; the
# PE's 2^9 frequency amplifies a flipped offset. 2e-2 is the bf16-level
# tolerance at which the JAX package holds its own kernel
# (tests/test_pallas_query.py).
K1_TOL = {"occ": 2e-2, "alpha": 2e-2, "rgb": 2e-2, "offset": 2e-3}
# K2 against its plain version: the same reason and the same 2e-2 at which
# the JAX package holds its kernel (tests/test_recon_fused.py); the flips
# stay rare, so the median difference must stay below 1e-4. K3 sums 64
# such samples per ray: the same two bounds
K2_TOL = 2e-2
K2_MEDIAN_TOL = 1e-4
K3_TOL = 2e-2
K3_MEDIAN_TOL = 1e-4
# a ray whose color exceeds this carries density somewhere along it
K3_COLOR_FLOOR = 1e-3
# PIFu's ReconNet capacities: its fitted field leaves more coarse nodes
# near 0.5 and more surface than AvatarCap's, which overflow the capture
# workload's 262,144 refined nodes and 294,912 triangles; these are the
# capture options of the pifu_sdf configuration
# (benchmark/configs/pifu_sdf.json)
PIFU_RECON_CAPACITIES = dict(recon_refine_capacity=2621440,
                             recon_max_tris=720896, recon_max_active=360448)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_launch(kernel, plain, n, macs_per_point, bytes_per_point,
                   weight_bytes, device, plain_reps=3):
    """Milliseconds of one launch (CUDA-event means: kernel() over 10
    calls, plain() over plain_reps, each after a warm-up) beside its bound:
    the larger of its bf16 operations over the card's peak rate and its
    bytes (each input read once, each output written once, the packed
    weights once) over the memory rate (tools/bench_kernels.launch_bound).
    n counts the launch's points (a ray kernel's samples, with bytes per
    sample)."""
    import torch
    from avatarcap_tpu_torch.tools.bench_kernels import (event_ms,
                                                         launch_bound)
    with torch.inference_mode():
        ms = event_ms(kernel, 10)
        plain_ms = event_ms(plain, plain_reps)
    bound = launch_bound(n, macs_per_point, bytes_per_point, weight_bytes)
    return {"points": n, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "tflops": bound["flops"] / (ms * 1e-3) / 1e12,
            "share_of_bound": bound["bound_ms"] / ms}


def _weight_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def build_subject(device, **kw):
    """(AvatarCapture, item, production-frame kwargs, n_valid) for the
    capture workload (tools/bench_workloads.build_capture_subject)."""
    from avatarcap_tpu_torch.tools.bench_workloads import (
        build_capture_subject)
    return build_capture_subject(device, **kw)


def weight_image_record(capture, device):
    """Build the weight image of the capture's packed set once, timed (the
    wrappers build and cache their own at their first launch)."""
    import torch
    from avatarcap_tpu_torch.ops import fused_query as fq
    pk = capture.packed_query
    fq.weight_image(pk["offset"], pk["template"])               # warm-up
    _sync(device)
    t0 = time.perf_counter()
    image, bias = fq.weight_image(pk["offset"], pk["template"])
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    if image.dtype != torch.bfloat16 or image.numel() != (
            fq.OFFSET_IMAGE_ELEMS + fq.TEMPLATE_IMAGE_ELEMS):
        raise AssertionError("the weight image has the wrong size")
    return {"bytes": image.numel() * 2, "bias_bytes": bias.numel() * 4,
            "chunks": fq.OFFSET_CHUNKS + fq.TEMPLATE_CHUNKS,
            "build_ms": ms}


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
            if not _finite([got[k]]):
                raise AssertionError(f"K1 output {k} is not finite")
            e = float((got[k] - ref[k]).abs().max())
            errs[k] = max(errs.get(k, 0.0), e)
        del got, ref
    bad = {k: e for k, e in errs.items() if e > K1_TOL[k]}
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad} "
                             f"(tolerance {K1_TOL})")
    weight_bytes = _weight_bytes(pk["offset"] + pk["template"])

    def measure(pts, pf):
        # 3 f32 + 64 bf16 in, 8 f32 out per point
        return measure_launch(
            lambda: warp_template_query(pk["offset"], pk["template"], pts,
                                        pf),
            lambda: warp_template_query_plain(pk["offset"], pk["template"],
                                              pts, pf),
            pts.shape[0], MACS_PER_POINT, 3 * 4 + 64 * 2 + 8 * 4,
            weight_bytes, device)

    coarse = measure(*recorded[0])
    refine = measure(*recorded[-1])
    # the kernel table reports the refine launch, the larger of the two
    return {"name": "warp_template_query", "route": "cuda",
            "source": "avatarcap_tpu_torch/csrc/warp_template_query.cu",
            "replaces": "avatarcap_tpu/ops/pallas_query.py:341",
            "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
            "tolerance": K1_TOL, **refine, "library_ms": None,
            "coarse_launch": coarse}


def check_k4_k5(capture, pts, pf, device):
    """K4 and K5 against their plain versions on the coarse K1 launch's
    points and [points, pose features], at K1's tolerances; timed."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import (
        OFFSET_IN_DIM, OFFSET_MACS_PER_POINT, TEMPLATE_MACS_PER_POINT,
        offset_query, offset_query_plain, template_query,
        template_query_plain)
    pk = capture.packed_query
    feats = torch.cat([pts, pf.float()], -1)
    with torch.inference_mode():
        got = template_query(pk["template"], pts)
        ref = template_query_plain(pk["template"], pts)
        off = offset_query(pk["offset"], feats)
        off_ref = offset_query_plain(pk["offset"], feats)
    _sync(device)
    if not _finite(list(got) + [off]):
        raise AssertionError("K4 or K5 output is not finite")
    errs = {k: float((g - r).abs().max())
            for k, g, r in zip(("rgb", "alpha", "occ"), got, ref)}
    off_err = float((off - off_ref).abs().max())
    bad = {k: e for k, e in errs.items() if e > K1_TOL[k]}
    if bad or off_err > K1_TOL["offset"]:
        raise AssertionError(f"K4/K5 disagree with their plain versions: "
                             f"{bad}, offset {off_err} (tolerance {K1_TOL})")
    del got, ref, off, off_ref
    n = pts.shape[0]
    k4 = measure_launch(
        lambda: template_query(pk["template"], pts),
        lambda: template_query_plain(pk["template"], pts), n,
        TEMPLATE_MACS_PER_POINT, 3 * 4 + 5 * 4, _weight_bytes(pk["template"]),
        device)
    k5 = measure_launch(
        lambda: offset_query(pk["offset"], feats),
        lambda: offset_query_plain(pk["offset"], feats), n,
        OFFSET_MACS_PER_POINT, OFFSET_IN_DIM * 4 + 3 * 4,
        _weight_bytes(pk["offset"]), device)
    return ({"name": "template_query", "route": "cuda",
             "source": "avatarcap_tpu_torch/csrc/template_offset_query.cu",
             "replaces": "avatarcap_tpu/ops/pallas_query.py:533",
             "max_abs_err": max(errs.values()),
             "max_abs_err_by_output": errs,
             "tolerance": {k: K1_TOL[k] for k in errs}, **k4,
             "library_ms": None},
            {"name": "offset_query", "route": "cuda",
             "source": "avatarcap_tpu_torch/csrc/template_offset_query.cu",
             "replaces": "avatarcap_tpu/ops/pallas_query.py:172",
             "max_abs_err": off_err, "tolerance": K1_TOL["offset"], **k5,
             "library_ms": None})


def query_fused_phase(capture, item, pts, device, n_check=65536):
    """[query_fused]: query_occupancy_fused on the refine launch's points
    ``pts`` (N, 3) with the frame's pose features: one counted call (1 K1
    launch), CUDA-event times of it, of K1 alone on the same points and
    per-point features, and of the fetch alone; its output against its
    plain version (the same fetch, then K1's plain version) on the first
    ``n_check`` points at K1's tolerances."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import (
        warp_template_query, warp_template_query_plain)
    from avatarcap_tpu_torch.ops.grid_sample import (
        sample_feature_map_at_points)
    from avatarcap_tpu_torch.pipeline.avatar import (
        compute_pose_features, fused_occupancy, query_occupancy_fused)
    from avatarcap_tpu_torch.tools.bench_kernels import event_ms
    pk, st = capture.packed_query, capture.statics
    with torch.inference_mode():
        pos_map = torch.as_tensor(item["smpl_pos_map"], device=device)[None]
        feat = compute_pose_features(capture.avatar, pos_map)
        q = pts[None]

        def fetch(p):
            return sample_feature_map_at_points(
                feat.permute(0, 3, 1, 2), p - st.cano_smpl_center)[0]

        _sync(device)
        _zero_launches()
        out = query_occupancy_fused(pk, q, feat, st)
        _sync(device)
        launches = _launches()
        if launches != {"k1": 1, "k2": 0, "k3": 0, "k4": 0, "k5": 0,
                        "merge": 0, "knn": 0, "k2w": 0}:
            raise AssertionError(f"query_occupancy_fused launched {launches}"
                                 ", expected one K1 launch")
        n = pts.shape[0]
        if (out["cano_pts_ov"].shape != (1, n, 1)
                or out["nonrigid_offset"].shape != (1, n, 3)
                or not _finite(list(out.values()))):
            raise AssertionError("query_occupancy_fused's outputs have the "
                                 "wrong shape or are not finite")
        del out
        pf = fetch(q)
        ms = event_ms(lambda: query_occupancy_fused(pk, q, feat, st), 10)
        k1_ms = event_ms(lambda: warp_template_query(
            pk["offset"], pk["template"], pts, pf), 10)
        fetch_ms = event_ms(lambda: fetch(q), 10)
        del pf
        sub = q[:, :n_check]

        def plain():
            r = warp_template_query_plain(pk["offset"], pk["template"],
                                          sub[0], fetch(sub))
            return fused_occupancy(pk, r["occ"]), r["offset"]

        got = query_occupancy_fused(pk, sub, feat, st)
        ref_occ, ref_off = plain()
        plain_ms = event_ms(plain, 3)
    errs = {"occ": float((got["cano_pts_ov"][0] - ref_occ).abs().max()),
            "offset": float((got["nonrigid_offset"][0] - ref_off).abs().max())}
    if any(e > K1_TOL[k] for k, e in errs.items()):
        raise AssertionError(f"query_occupancy_fused disagrees with its plain "
                             f"version: {errs} (tolerance {K1_TOL})")
    rec = {"points": n, "launches": launches["k1"], "ms": ms,
           "k1_ms": k1_ms, "fetch_ms": fetch_ms,
           "plain_points": int(sub.shape[1]), "plain_ms": plain_ms,
           "max_abs_err": errs}
    print(f"[query_fused] {json.dumps(rec)}")
    return rec


def occupancy_capture(capture, device):
    """``capture``'s grid, ReconNet, texture avatar and options with its
    avatar's weights in GeoTexAvatar(if_type="occupancy") and iso_value
    0.5: sigmoid(x) >= 0.5 iff x >= 0, so the surface is the SDF
    capture's (up to the refinement band and interpolation)."""
    import dataclasses
    import torch
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    with torch.random.fork_rng(devices=[]):
        occ = GeoTexAvatar(if_type="occupancy")
    occ.load_state_dict(capture.avatar.state_dict())
    return AvatarCapture(occ, capture.statics, capture.grid,
                         recon=capture.recon, tex_avatar=capture.tex_avatar,
                         options=dataclasses.replace(capture.opt,
                                                     iso_value=0.5),
                         device=device)


def occupancy_phase(capture, item, recon_kw, sdf_frame, device):
    """[occupancy]: the textured production frame of the occupancy form
    of ``capture``'s avatar (occupancy_capture): a warm-up, two counted
    and timed frames (2 K1, 2 K2, 2 K3 launches each, no overflow), their
    triangle counts against the SDF textured frame's ``sdf_frame``, the
    stage times; then the small subject's occupancy frames on the card
    against the CPU (check_small_frame)."""
    occ = occupancy_capture(capture, device)
    if occ.packed_query["if_type"] != "occupancy":
        raise AssertionError("the occupancy capture packed an SDF head")
    run_frame(occ, item, device, w_nerf=True, w_recon=True, **recon_kw)
    frames = []
    for _ in range(2):
        _, rec = run_frame(occ, item, device, w_nerf=True, w_recon=True,
                           **recon_kw)
        got = (rec["k1_launches"], rec["k2_launches"], rec["k3_launches"],
               rec["merge_launches"])
        if got != (2, 2, 2, 1):
            raise AssertionError(f"the occupancy textured frame launched K1, "
                                 f"K2, K3, merge {got} times, expected 2, 2, "
                                 "2, 1")
        if rec["overflow"]:
            raise AssertionError(f"the occupancy textured frame overflows: "
                                 f"{rec}")
        frames.append(rec)
    out = dict(frames[0])
    out["runs"] = frames
    out["sdf_num_tris"] = sdf_frame["num_tris"]
    out["sdf_recon_num_tris"] = sdf_frame["recon_num_tris"]
    out["num_tris_ratio"] = out["num_tris"] / sdf_frame["num_tris"]
    out["recon_num_tris_ratio"] = (out["recon_num_tris"]
                                   / sdf_frame["recon_num_tris"])
    out["stages"] = stage_times(occ, item, device, w_nerf=True, w_recon=True,
                                **recon_kw)
    del occ
    print(f"[occupancy] {json.dumps(out)}")
    out["small_frame"] = check_small_frame(device, form="occupancy")
    print(f"[occupancy] small subject, card against CPU: "
          f"{json.dumps(out['small_frame'])}")
    return out


def _finite(tensors):
    import torch
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _zero_launches():
    """Set every kernel's launch count to 0 (tools/bench_stream)."""
    from avatarcap_tpu_torch.tools.bench_stream import _zero_launches as zero
    zero()


def _launches():
    """Each kernel's launches since _zero_launches: K1 to K5, the
    normal-fusion merge, the nearest-vertex distance and K2w."""
    from avatarcap_tpu_torch.tools.bench_stream import _launches as launches
    return launches()


def run_frame(capture, item, device, w_nerf=False, **frame_kw):
    """One counted and timed frame: the launch counts are set to 0 just
    before it and read just after. Returns (results, record)."""
    import torch
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    res = capture.process_frame(item, w_nerf=w_nerf, **frame_kw)
    _sync(device)
    secs = time.perf_counter() - t0
    out = {"seconds": secs,
           **{f"{k}_launches": n for k, n in _launches().items()},
           "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           **frame_record(res)}
    return res, out


def frame_record(res):
    """A frame's triangle counts, overflow and mean colors; its meshes,
    images and colors must be finite, with triangles."""
    out = {"num_tris": int(res["cano_mesh"].num_tris),
           "overflow": bool(res["overflow"])}
    meshes = [res["cano_mesh"], res["live_mesh"]]
    images = [res["front_avatar_normal"], res["back_avatar_normal"],
              *res["cano_phong"]]
    if "recon_mesh" in res:
        out["recon_num_tris"] = int(res["recon_mesh"].num_tris)
        out["recon_overflow"] = bool(res["recon_mesh"].overflow)
        meshes += [res["recon_mesh"], res["live_recon_mesh"]]
        images += [res["front_merged_normal"], res["front_image_normal"]]
        if out["recon_num_tris"] <= 0:
            raise AssertionError("the frame's ReconNet mesh has no triangles")
    colors = [res[k] for k in ("avatar_colors", "recon_colors") if k in res]
    for key, mesh in (("avatar_colors", "cano_mesh"),
                      ("recon_colors", "recon_mesh")):
        if key in res:
            valid = res[mesh].valid.repeat_interleave(3)
            out[f"{key}_mean"] = res[key][valid].mean(0).tolist()
            if res[key].shape != res[mesh].vertices.shape:
                raise AssertionError(f"{key} has shape "
                                     f"{tuple(res[key].shape)}")
    if not _finite([t for m in meshes for t in (m.vertices, m.normals)]
                   + images + colors):
        raise AssertionError("frame outputs are not finite")
    if out["num_tris"] <= 0:
        raise AssertionError("frame produced no triangles")
    return out


def stage_times(capture, item, device, w_nerf=False, **frame_kw):
    """Synchronised seconds of each stage of one frame."""
    from avatarcap_tpu_torch.utils.timers import StageTimer
    timer = StageTimer(device)
    capture.process_frame(item, w_nerf=w_nerf, timer=timer, **frame_kw)
    return timer.times


def recon_launch_inputs(capture, res):
    """The inputs of the production frame's two ReconNet decode launches
    (coarse, refine; (N, 33) rows for K2, (N, 257) for K2w), recorded
    through the same recon_volume the frame runs, from that frame's
    merged normals (this pass launches the kernel; it is not the counted
    frame)."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import recon_decode
    recorded = []

    def decode(packed, feats):
        recorded.append(feats)
        return recon_decode(packed, feats)

    with torch.inference_mode():
        feat_map = capture.recon.get_feat_maps(torch.cat(
            [res["front_merged_normal"], res["back_avatar_normal"]], -1)[None])
        capture.recon_volume(feat_map, decode=decode)
    return recorded


def check_recon(capture, recorded, device):
    """The capture's ReconNet kernel (K2 or K2w, by its packed shapes)
    against its plain version on both launches' inputs, at the same
    tolerances (the same arithmetic contract at either's widths); times
    kernel, plain and bound. Returns the kernel-table record (the coarse
    launch, the larger of the two, with the refine launch beside it)."""
    import torch
    from avatarcap_tpu_torch.ops import fused_query as fq
    from avatarcap_tpu_torch.tools.bench_kernels import recon_image_record
    pk = capture.packed_recon
    kernel = fq.RECON_FORMS[tuple(tuple(w.shape) for w in pk[0::2])][0]
    wide = kernel == "k2w"
    plain = fq.recon_decode_wide_plain if wide else fq.recon_decode_plain
    err, median = 0.0, 0.0
    for feats in recorded:
        with torch.inference_mode():
            got = fq.recon_decode(pk, feats)
            ref = plain(pk, feats)
        _sync(device)
        if not _finite([got]):
            raise AssertionError(f"{kernel.upper()} output is not finite")
        d = (got - ref).abs()
        err = max(err, float(d.max()))
        median = max(median, float(d.median()))
        del got, ref, d
    if err > K2_TOL or median > K2_MEDIAN_TOL:
        raise AssertionError(
            f"{kernel.upper()} disagrees with its plain version: max {err}, "
            f"median {median} (tolerance {K2_TOL}, median {K2_MEDIAN_TOL})")
    weight_bytes = _weight_bytes(pk)
    in_dim = fq.RECON_WIDE_IN_DIM if wide else fq.RECON_IN_DIM
    macs = fq.RECON_WIDE_MACS_PER_POINT if wide else fq.RECON_MACS_PER_POINT

    def measure(feats):
        # in_dim f32 in, 1 f32 out per point
        return measure_launch(lambda: fq.recon_decode(pk, feats),
                              lambda: plain(pk, feats), feats.shape[0],
                              macs, in_dim * 4 + 4, weight_bytes, device,
                              plain_reps=1 if wide else 3)

    coarse = measure(recorded[0])
    refine = measure(recorded[-1])
    image = recon_image_record(fq, pk, {"coarse": -(-coarse["points"] // 128),
                                        "refine": -(-refine["points"] // 128)},
                               kind="recon_wide" if wide else "recon")
    for launch, rec in (("coarse", coarse), ("refine", refine)):
        rec["l2_bytes"] = image["l2_bytes"][launch]
        rec["l2_tb_per_s"] = rec["l2_bytes"] / (rec["ms"] * 1e-3) / 1e12
    print(f"[{kernel}] weight image {image['bytes']} B + "
          f"{image['bias_bytes']} B of vectors, built in "
          f"{image['build_ms']:.3f} ms; L2 pull "
          f"{coarse['l2_tb_per_s']:.2f} TB/s coarse, "
          f"{refine['l2_tb_per_s']:.2f} TB/s refine")
    name = "recon_decode_wide" if wide else "recon_decode"
    return {"name": name, "route": "cuda",
            "source": f"avatarcap_tpu_torch/csrc/{name}.cu",
            "replaces": (None if wide
                         else "avatarcap_tpu/ops/pallas_query.py:239"),
            "max_abs_err": err, "median_abs_err": median,
            "tolerance": {"max": K2_TOL, "median": K2_MEDIAN_TOL},
            **coarse, "library_ms": None, "refine_launch": refine,
            "weight_image": {k: image[k] for k in ("bytes", "bias_bytes",
                                                   "build_ms")}}


def production_frames(capture, item, recon_kw, device):
    """Phase 5 up to the kernel check: the warm-up frame, K2's inputs and
    its check. Returns the K2 record."""
    res, _ = run_frame(capture, item, device, w_recon=True, **recon_kw)
    recorded = recon_launch_inputs(capture, res)
    del res
    return check_recon(capture, recorded, device)


def pifu_phase(capture, item, recon_kw, fit, device, n_frames=8,
               lookahead=2, decoder_steps=1000):
    """[pifu]: PIFu's shape network as the ReconNet
    (models/recon.PIFU_SHAPE_NETWORK) on the fitted subject's avatar, body
    and grid, its decoder drawn as the subject's (flax_init_) and fitted
    to the toy body with the subject's wrinkles (fit_recon_decoder,
    ``decoder_steps`` steps) on the features of the ReconNet input of the
    subject's production frame (its merged front and avatar back normals,
    which PIFu's frame shares: no ReconNet feeds them), with
    PIFU_RECON_CAPACITIES over the subject's capture options. n_frames
    untextured production frames of distinct poses through
    StreamingCapture.run_pipelined (lookahead 2) after a warm-up run,
    with the launch counts set to 0 just before and read just after: 2 K1
    and 2 K2w launches a frame, no K2; each frame finite, with ReconNet
    triangles. K2w's inputs from the last frame's normals (the coarse
    band and the refine capacity) are held against its plain version and
    timed (check_recon); then no frame may have overflowed. Returns (K2w's
    kernel record, the phase's record)."""
    import torch
    from avatarcap_tpu_torch.models.recon import (PIFU_SHAPE_NETWORK,
                                                  ReconNetwork)
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    from avatarcap_tpu_torch.tools.bench_stream import stream_items
    from avatarcap_tpu_torch.tools.bench_workloads import (fit_recon_decoder,
                                                           flax_init_)
    with torch.inference_mode():
        res = capture.process_frame(item, w_recon=True, w_nerf=False,
                                    **recon_kw)
        images = torch.cat([res["front_merged_normal"],
                            res["back_avatar_normal"]], -1)
    del res
    recon = flax_init_(ReconNetwork(**PIFU_SHAPE_NETWORK),
                       torch.Generator().manual_seed(3)).to(device)
    _sync(device)
    t0 = time.perf_counter()
    _, loss = fit_recon_decoder(recon, capture.statics, capture.grid,
                                recon_kw["inferred_normal"],
                                steps=decoder_steps,
                                wrinkle_amp=fit["wrinkle_amp"],
                                images=images.clone())
    rec = {"decoder_fit_seconds": time.perf_counter() - t0,
           "decoder_steps": decoder_steps, "decoder_loss": loss,
           "frames": n_frames, "lookahead": lookahead}
    print(f"[pifu] decoder fit: {decoder_steps} steps, loss {loss:.4g}, "
          f"{rec['decoder_fit_seconds']:.1f} s")
    pifu = AvatarCapture(capture.avatar, capture.statics, capture.grid,
                         recon=recon.eval(),
                         options=dataclasses.replace(
                             capture.opt, **PIFU_RECON_CAPACITIES),
                         device=device)
    items = stream_items(item, n_frames)
    normals = [recon_kw["inferred_normal"]] * n_frames
    sc = StreamingCapture(
        pifu, make_mesh([device]), camera=recon_kw["camera"],
        image_size=recon_kw["inferred_normal"].shape[:2],
        neck_vertex_idx=recon_kw["neck_vertex_idx"], w_recon=True,
        w_nerf=False)
    sc.run_pipelined(items, normals, lookahead=lookahead)       # warm-up
    _sync(device)
    _zero_launches()
    t0 = time.perf_counter()
    results = sc.run_pipelined(items, normals, lookahead=lookahead)
    _sync(device)
    secs = time.perf_counter() - t0
    rec.update(seconds=secs, frames_per_s=n_frames / secs,
               launches=_launches(),
               frame=[frame_record(r) for r in results])
    want = {"k1": 2 * n_frames, "k2": 0, "k3": 0, "k4": 0, "k5": 0,
            "merge": n_frames, "knn": 0, "k2w": 2 * n_frames}
    if rec["launches"] != want:
        raise AssertionError(f"the PIFu stream launched {rec['launches']}, "
                             f"expected {want}")
    recorded = recon_launch_inputs(pifu, results[-1])
    del results
    rec["rows"] = [int(f.shape[0]) for f in recorded]
    k2w = check_recon(pifu, recorded, device)
    del recorded, sc, pifu
    k2w["launches"] = rec["launches"]["k2w"]
    print(f"[pifu] {n_frames} frames at {rec['frames_per_s']:.3f} frames/s, "
          f"launches {rec['launches']}, decode rows {rec['rows']}, frames "
          f"{rec['frame']}")
    print(f"[k2w] {json.dumps(k2w)}")
    if any(f["overflow"] or f["recon_overflow"] for f in rec["frame"]):
        raise AssertionError(f"a PIFu frame overflowed: {rec['frame']}")
    return k2w, rec


def merge_phase(capture, device):
    """[merge]: the normal-fusion merge's kernel (csrc/normal_merge.cu) at
    the frame's render size and fusion_iters steps, on
    tools/bench_kernels.merge_inputs' pair (the fitted subject's own front
    images share no valid pixel: its merge is a no-op): held against
    merge_normal_images_plain on the card (bench_kernels.merge_agreement;
    at the capture's 512^2 the two must be equal to the bit), one launch a
    call, timed beside the plain path (the whole call by CUDA events, the
    kernel alone from a profiler trace) and its bound."""
    from avatarcap_tpu_torch.tools import bench_kernels as bk
    rec = bk.merge_row(device, seed=0, reps=10, side=capture.opt.render_res,
                       iters=capture.opt.fusion_iters)
    exact = capture.opt.render_res != 512 or rec["bitwise"]
    if not rec["ok"] or not exact or rec["launches"] != 1:
        raise AssertionError(f"the merge kernel disagrees with its plain "
                             f"version: {rec}")
    return dict(rec, route="cuda", ms=rec["kernel_ms"], call_ms=rec["ms"],
                source="avatarcap_tpu_torch/csrc/normal_merge.cu",
                replaces="none (avatarcap_tpu/fusion/normal_fusion.py:"
                         "264-282, the jitted fori_loops)",
                tolerance={"max": bk.MERGE_TOL, "share_within_1e-4":
                           bk.MERGE_SHARE},
                library_ms=None)


def knn_launch_inputs(capture, item, recon_kw):
    """The inputs (queries, database) of the textured production frame's
    two nearest-vertex launches (the avatar soup's anchors, ReconNet's),
    recorded through the color stages the frame runs (k3_launch_inputs'
    pass) on the meshes of a frame run for it."""
    import torch
    from avatarcap_tpu_torch.ops import knn as K
    res = capture.process_frame(item, w_nerf=True, w_recon=True, **recon_kw)
    kernel, recorded = K.nearest_vertex, []

    def record(queries, database):
        recorded.append((queries.clone(), database.clone()))
        return kernel(queries, database)
    record.launches = 0         # the wrapper counts under its module name
    K.nearest_vertex = record
    try:
        k3_launch_inputs(capture, item, res)
    finally:
        K.nearest_vertex = kernel
    _sync(capture.device)
    del res
    torch.cuda.empty_cache()
    return recorded


def knn_phase(capture, item, recon_kw, device):
    """[knn]: the nearest-vertex distance's kernel (csrc/nearest_vertex.cu)
    held to knn_plain's bits in every row, on the textured production
    frame's two anchor launches (knn_launch_inputs, at the caller's chunk)
    and on tools/bench_kernels.knn_rows' launches of the same sizes and a
    train item's, which time it beside knn_plain on the card and the
    float32 issue bound. Its launches are read with the other kernels'
    (main: the pipelined stream's and the textured frame's)."""
    import torch
    from avatarcap_tpu_torch.ops import knn as K
    from avatarcap_tpu_torch.tools import bench_kernels as bk
    frame = []
    for launch, (q, v) in zip(("frame_avatar", "frame_recon"),
                              knn_launch_inputs(capture, item, recon_kw)):
        with torch.inference_mode():
            d, i = K.nearest_vertex(q, v)
            # anchor_distances' chunk
            d_ref, i_ref = K.knn_plain(q, v, 1, 65536)
        frame.append({"launch": launch, "points": q.shape[0],
                      "vertices": v.shape[0],
                      **bk.knn_agreement(d, i, d_ref, i_ref)})
        del q, v, d, i, d_ref, i_ref
    rows = bk.knn_rows(device, seed=0, reps=10)
    if len(frame) != 2 or any(r["d2_bits_differ"] or r["idx_differ"]
                              for r in frame + rows):
        raise AssertionError(f"the nearest-vertex kernel disagrees with "
                             f"knn_plain: {frame} {rows}")
    timed = [r for r in rows if r["launch"].startswith("frame")]
    return {"name": "nearest_vertex", "route": "cuda",
            "source": "avatarcap_tpu_torch/csrc/nearest_vertex.cu",
            "replaces": "none (avatarcap_tpu/ops/knn.py: knn, a chunked "
                        "product left to XLA)",
            "max_abs_err": max(r["max_abs_err"] for r in frame + rows),
            "tolerance": {"d2_bits_differ": 0, "idx_differ": 0},
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "float32 issue", "library_ms": None,
            "frame_anchors": frame, "rows": rows}


def stage_hashes(capture, item):
    """SHA-1 of the output bits of each avatar stage of the production
    frame, run through the frame's own stage functions on the item, in
    order; and of each U-Net module's output inside the pose features."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    from avatarcap_tpu_torch.pipeline.avatar import (compute_pose_features,
                                                     grid_pose_features)
    from avatarcap_tpu_torch.pipeline.capture import (_extract_mesh,
                                                      hierarchical_volume)
    from avatarcap_tpu_torch.tools.bench_kernels import outputs_sha1
    dev = capture.device
    g, st, o = capture.grid, capture.statics, capture.opt
    pk = capture.packed_query
    modules, fields = [], []

    def hook(name):
        def record(module, args, out):
            if isinstance(out, torch.Tensor):
                modules.append((name, outputs_sha1([out])))
        return record

    handles = [m.register_forward_hook(hook(name))
               for name, m in capture.avatar.named_modules() if name]
    try:
        with torch.inference_mode():
            pos_map = torch.as_tensor(item["smpl_pos_map"],
                                      dtype=torch.float32).to(dev)[None]
            feat = compute_pose_features(capture.avatar, pos_map)
    finally:
        for h in handles:
            h.remove()
    with torch.inference_mode():
        cols = grid_pose_features(feat, st, g.vol_res, dtype=torch.bfloat16,
                                  columns=True)

        def vf(pts, fidx):
            occ = warp_template_query(pk["offset"], pk["template"], pts,
                                      cols[fidx.long() // g.vol_res[2]]
                                      )["occ"][:, 0]
            fields.append((fidx, occ))
            return occ

        vol, _, n_r = hierarchical_volume(
            vf, g, st.cano_bounds, g.c_prior, g.prior_volume, o.iso_value,
            o.hier_alpha, o.refine_capacity, with_stats=True)
        mesh = _extract_mesh(vol, g, st.cano_bounds, o.iso_value, o.max_tris,
                             o.max_active, o.normal_mode)
        jnt = torch.as_tensor(item["cano2live_jnt_mats"],
                              dtype=torch.float32).to(dev)
        live, _ = capture.skinning_stage(mesh, jnt)
    stages = {"pose_features": [feat], "grid_pose_features": [cols],
              "coarse_field": [fields[0][1]],
              "refine_set": [fields[1][0], n_r],
              "refine_field": [fields[1][1]], "fine_volume": [vol],
              "mesh": [mesh.vertices, mesh.normals, mesh.num_tris],
              "skinned_mesh": [live.vertices, live.normals]}
    return {"stages": {k: outputs_sha1(v) for k, v in stages.items()},
            "unet_modules": modules, "num_tris": int(mesh.num_tris),
            "refined_nodes": int(n_r)}


def first_difference(a, b):
    """The first stage (and U-Net module) whose hashes differ between two
    stage_hashes runs, or None."""
    stage = next((k for k in a["stages"]
                  if a["stages"][k] != b["stages"][k]), None)
    module = next((na for (na, ha), (_, hb) in zip(a["unet_modules"],
                                                   b["unet_modules"])
                   if ha != hb), None)
    return {"stage": stage, "unet_module": module}


def timed_production_frames(capture, item, recon_kw, device):
    """Two timed frames, their drift, two more with deterministic cuDNN,
    and the stage times; the avatar stages' hashes before and after."""
    import torch
    hashes = [stage_hashes(capture, item)]
    frames = []
    for deterministic in (False, False, True, True):
        torch.backends.cudnn.deterministic = deterministic
        _, rec = run_frame(capture, item, device, w_recon=True, **recon_kw)
        rec["cudnn_deterministic"] = deterministic
        got = (rec["k1_launches"], rec["k2_launches"],
               rec["merge_launches"], rec["knn_launches"])
        if got != (2, 2, 1, 0):
            raise AssertionError(
                f"the production frame launched K1, K2, merge, knn {got} "
                "times, expected 2, 2 (coarse + refine), 1 and 0")
        frames.append(rec)
    torch.backends.cudnn.deterministic = False
    hashes.append(stage_hashes(capture, item))

    def same(a, b):
        return (a["num_tris"] == b["num_tris"]
                and a["recon_num_tris"] == b["recon_num_tris"])

    out = dict(frames[0])
    out["runs"] = frames
    diff = first_difference(*hashes)
    out["drift"] = {"default_runs_agree": same(frames[0], frames[1]),
                    "deterministic_runs_agree": same(frames[2], frames[3]),
                    "first_differing": diff,
                    "stage_hashes": [h["stages"] for h in hashes],
                    "stage_num_tris": [h["num_tris"] for h in hashes],
                    "stage_refined_nodes": [h["refined_nodes"]
                                            for h in hashes]}
    for i, h in enumerate(hashes):
        print(f"[drift] run {i}: " + " ".join(
            f"{k}={v[:10]}" for k, v in h["stages"].items())
            + f" tris={h['num_tris']} refined={h['refined_nodes']}")
    print(f"[drift] first stage whose hashes differ between the runs: "
          f"{diff['stage']} (U-Net module: {diff['unet_module']}); frame "
          f"triangles {[f['num_tris'] for f in frames]}")
    if diff["stage"] is not None or not out["drift"]["default_runs_agree"]:
        raise AssertionError(f"the production frame's avatar stages differ "
                             f"from run to run: {out['drift']}")
    out["stages"] = stage_times(capture, item, device, w_recon=True,
                                **recon_kw)
    return out


def k3_launch_inputs(capture, item, res):
    """The arguments of the textured frame's two K3 launches (the avatar's
    unique vertices, the ReconNet's), recorded through the same color
    stages the frame runs, on that frame's meshes (this pass launches the
    kernel; it is not the counted frame)."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import ray_color_query
    from avatarcap_tpu_torch.pipeline.avatar import compute_pose_features
    recorded = []

    def ray_query(*args, **kw):
        recorded.append((args, kw))
        return ray_color_query(*args, **kw)

    with torch.inference_mode():
        pos_map = torch.as_tensor(item["smpl_pos_map"],
                                  device=capture.device)[None]
        feat = compute_pose_features(capture.avatar, pos_map)
        colors, _, uniq = capture.nerf_color_stage(
            feat, res["cano_mesh"], ray_query=ray_query)
        capture.color_transfer_stage(
            feat, res["recon_mesh"], res["cano_mesh"].vertices,
            colors.flip(-1), uniq, ray_query=ray_query)
    return recorded


def check_k3(recorded, device):
    """K3 against its plain version on both launches' arguments; times
    kernel, plain and bound."""
    import torch
    from avatarcap_tpu_torch.ops.fused_query import (
        MACS_PER_POINT, POSE_FEAT_DIM, ray_color_query, ray_color_query_plain)
    err, median, launches = 0.0, 0.0, []
    for args, kw in recorded:
        with torch.inference_mode():
            got = ray_color_query(*args, **kw)
            ref = ray_color_query_plain(*args, **kw)
        _sync(device)
        if not _finite([got]):
            raise AssertionError("K3 output is not finite")
        d = (got - ref).abs()
        err = max(err, float(d.max()))
        median = max(median, float(d.median()))
        share = float((ref.max(-1).values > K3_COLOR_FLOOR).float().mean())
        launches.append({"rays": got.shape[0], "samples": kw["n_samples"],
                         "anchors": args[6].shape[1],
                         "share_colored": share})
        print(f"[k3] {got.shape[0]} rays: share of rays with a color above "
              f"{K3_COLOR_FLOOR}: {share:.4f}")
        if share == 0.0:
            raise AssertionError("K3's rays carry no color: a degenerate "
                                 "field proves nothing")
        del got, ref, d
    if err > K3_TOL or median > K3_MEDIAN_TOL:
        raise AssertionError(
            f"K3 disagrees with its plain version: max {err}, median "
            f"{median} (tolerance {K3_TOL}, median {K3_MEDIAN_TOL})")
    for (args, kw), rec in zip(recorded, launches):
        n_anchors = rec["anchors"]
        per_ray = (3 + 3 + n_anchors + 3) * 4 + 2 * POSE_FEAT_DIM * 2
        rec.update(measure_launch(
            lambda: ray_color_query(*args, **kw),
            lambda: ray_color_query_plain(*args, **kw),
            rec["rays"] * rec["samples"], MACS_PER_POINT,
            per_ray / rec["samples"], _weight_bytes(args[0] + args[1]),
            device, plain_reps=1))
    # the kernel table reports the avatar launch, the larger of the two
    return {"name": "ray_color_query", "route": "cuda",
            "source": "avatarcap_tpu_torch/csrc/ray_color_query.cu",
            "replaces": "avatarcap_tpu/ops/pallas_query.py:496",
            "max_abs_err": err, "median_abs_err": median,
            "tolerance": {"max": K3_TOL, "median": K3_MEDIAN_TOL},
            **launches[0], "library_ms": None,
            "recon_launch": launches[-1]}


def textured_frames(capture, item, recon_kw, device):
    """Phase 6: the warm-up textured frame, K3's inputs and check, two
    timed textured production frames, their stage times and one
    avatar-only textured frame. Returns (K3 record, frame record)."""
    res, _ = run_frame(capture, item, device, w_nerf=True, w_recon=True,
                       **recon_kw)
    recorded = k3_launch_inputs(capture, item, res)
    del res
    k3 = check_k3(recorded, device)
    del recorded
    print(f"[k3] {json.dumps(k3)}")
    frames = []
    for _ in range(2):
        _, rec = run_frame(capture, item, device, w_nerf=True, w_recon=True,
                           **recon_kw)
        got = (rec["k1_launches"], rec["k2_launches"], rec["k3_launches"],
               rec["merge_launches"], rec["knn_launches"])
        if got != (2, 2, 2, 1, 2):
            raise AssertionError(
                f"the textured production frame launched K1, K2, K3, merge, "
                f"knn {got} times, expected 2, 2, 2, 1, 2")
        frames.append(rec)
    out = dict(frames[0])
    out["runs"] = frames
    out["stages"] = stage_times(capture, item, device, w_nerf=True,
                                w_recon=True, **recon_kw)
    _, avatar_only = run_frame(capture, item, device, w_nerf=True,
                               w_recon=False)
    got = (avatar_only["k1_launches"], avatar_only["k2_launches"],
           avatar_only["k3_launches"], avatar_only["merge_launches"],
           avatar_only["knn_launches"])
    if got != (2, 0, 1, 0, 1):
        raise AssertionError(
            f"the avatar-only textured frame launched K1, K2, K3, merge, knn "
            f"{got} times, expected 2, 0, 1, 0, 1")
    out["avatar_only"] = avatar_only
    return k3, out


def _color_agreement(a, b, mesh_key, color_key, tol):
    """Colors of two textured frames compared vertex by vertex, the
    vertices matched by their volume-edge keys (kernel noise may move a
    few triangles, which shifts the soup slots after them). Returns
    (share of b's vertices found in a, share of found ones within tol)."""
    import numpy as np

    def per_vertex(res):
        mesh = res[mesh_key]
        ids = mesh.edge_ids.cpu().numpy()
        valid = mesh.valid.repeat_interleave(3).cpu().numpy() & (ids >= 0)
        uid, first = np.unique(ids[valid], return_index=True)
        return uid, res[color_key].cpu().numpy()[valid][first]

    ua, ca = per_vertex(a)
    ub, cb = per_vertex(b)
    _, ia, ib = np.intersect1d(ua, ub, return_indices=True)
    close = np.abs(ca[ia] - cb[ib]).max(-1) <= tol
    return len(ia) / max(1, len(ub)), float(close.mean()) if len(ia) else 0.0


def small_subject(device, **options):
    """The small subject (48 x 48 x 32 grid, 128^2 renders; tools/
    bench_workloads.SMALL_SUBJECT) with its random networks on ``device``:
    a card and the CPU get the same weights, which two fits would not
    give. ``options`` go over SMALL_CAPTURE_OPTIONS."""
    from avatarcap_tpu_torch.tools.bench_workloads import (
        SMALL_CAPTURE_OPTIONS, SMALL_SUBJECT)
    return build_subject(device, options=dict(SMALL_CAPTURE_OPTIONS,
                                              **options),
                         fit=False, **SMALL_SUBJECT)


def card_cpu_agreement(a, b, w_recon, key):
    """A small frame on the card (a) against the CPU (b): triangle counts
    within 1%, and 99% of the avatar's (and the merged) front normal
    pixels within 1e-2. Raises on a disagreement; returns the record."""
    pairs = [("num_tris", a["cano_mesh"], b["cano_mesh"])]
    images = [("front_avatar_normal", a["front_avatar_normal"],
               b["front_avatar_normal"])]
    if w_recon:
        pairs.append(("recon_num_tris", a["recon_mesh"], b["recon_mesh"]))
        images.append(("front_merged_normal", a["front_merged_normal"],
                       b["front_merged_normal"]))
    rec = {}
    ok = True
    for name, ma, mb in pairs:
        ta, tb = int(ma.num_tris), int(mb.num_tris)
        rec[name] = {"card": ta, "cpu": tb}
        ok &= ta > 0 and abs(ta - tb) <= 0.01 * tb
    for name, ia, ib in images:
        agree = float(((ia.cpu() - ib).abs().max(-1).values < 1e-2)
                      .float().mean())
        rec[f"{name}_pixels_agreeing"] = agree
        ok &= agree >= 0.99
    if not ok:
        raise AssertionError(f"small frame ({key}) differs between the card "
                             f"and the CPU: {rec}")
    return rec


def check_small_frame(device, form="sdf"):
    """The avatar-only, the production and the textured production frame
    on a small subject, on the card and on the CPU, through the f32 module
    path (use_fused_query=False) and through the kernels (their plain
    versions on the CPU); ``form="occupancy"`` runs the subject's avatar
    in the occupancy form (occupancy_capture). The textured frames' colors are matched vertex
    by vertex through the soups' edge keys. The textured frame takes 4
    samples per ray, so that the kernels' 4 anchored near flags and lerped
    pose features are the f32 path's per-sample KNN and fetch: the card's
    color stages through the kernels, run on the CPU f32 frame's meshes,
    are also held against that frame's colors."""
    import torch
    from avatarcap_tpu_torch.pipeline.capture import CaptureMesh
    from avatarcap_tpu_torch.pipeline.avatar import compute_pose_features
    cpu = torch.device("cpu")
    outs = {}
    for fused in (False, True):
        for dev in (device, cpu):
            cap, item, recon_kw, _ = small_subject(dev,
                                                   use_fused_query=fused)
            if form == "occupancy":
                cap = occupancy_capture(cap, dev)
            if fused and dev == device:
                card_cap = cap
            outs[fused, dev.type] = (
                cap.process_frame(item, w_recon=False, w_nerf=False),
                cap.process_frame(item, w_recon=True, w_nerf=False,
                                  **recon_kw),
                cap.process_frame(item, w_recon=True, w_nerf=True,
                                  **recon_kw))
    report = {}
    for fused in (False, True):
        for w_recon in (False, True):
            key = ("fused" if fused else "f32") + ("_w_recon" if w_recon
                                                   else "")
            report[key] = card_cpu_agreement(
                outs[fused, device.type][w_recon], outs[fused, "cpu"][w_recon],
                w_recon, key)
    for key, fused in (("f32_w_nerf", False), ("fused_w_nerf", True)):
        a, b = outs[fused, device.type][2], outs[fused, "cpu"][2]
        rec = {}
        ok = True
        for mesh_key, color_key in (("cano_mesh", "avatar_colors"),
                                    ("recon_mesh", "recon_colors")):
            found, agree = _color_agreement(a, b, mesh_key, color_key,
                                            K3_TOL)
            rec[color_key] = {"vertices_found": found, "agreeing": agree}
            ok &= found >= 0.95 and agree >= 0.99
        report[key] = rec
        if not ok:
            raise AssertionError(f"small textured frame ({key}) colors "
                                 f"differ between the card and the CPU: "
                                 f"{rec}")
    ref = outs[False, "cpu"][2]
    with torch.inference_mode():
        pos_map = torch.as_tensor(item["smpl_pos_map"], device=device)[None]
        feat = compute_pose_features(card_cap.avatar, pos_map)
        cm, rm = (CaptureMesh(*(None if t is None else t.to(device)
                                for t in ref[k]))
                  for k in ("cano_mesh", "recon_mesh"))
        colors, _, uniq = card_cap.nerf_color_stage(feat, cm)
        colors = colors.flip(-1)
        recon_colors, _ = card_cap.color_transfer_stage(
            feat, rm, cm.vertices, colors, uniq)
    rec = {}
    for name, got, mesh in (("avatar_colors", colors, cm),
                            ("recon_colors", recon_colors, rm)):
        valid = mesh.valid.repeat_interleave(3).cpu()
        d = (got.cpu()[valid] - ref[name][valid]).abs().max(-1).values
        rec[name] = {"agreeing": float((d <= K3_TOL).float().mean()),
                     "max_abs_err": float(d.max())}
        if rec[name]["agreeing"] < 0.99:
            raise AssertionError(
                f"the card's color stages through the kernels differ from "
                f"the CPU f32 frame's colors on its meshes: {rec}")
    report["fused_card_vs_f32_cpu_w_nerf"] = rec
    return report


def sync_phase(capture, item, recon_kw):
    """[sync]: the synchronising calls inside frame_body in its three
    forms at full size (tools/bench_stream.sync_counts); there must be
    none."""
    from avatarcap_tpu_torch.tools.bench_stream import sync_counts
    rec = sync_counts(capture, item, recon_kw)
    print("[sync] synchronising calls inside frame_body: " + ", ".join(
        f"{k} {v['syncs']}" for k, v in rec.items()) + f" {json.dumps(rec)}")
    if any(v["syncs"] for v in rec.values()):
        raise AssertionError(f"frame_body waits for the card: {rec}")
    return rec


def stream_phase(capture, item, recon_kw):
    """[stream]: 8 full-size textured production frames of distinct
    poses through a process_frame loop and through run_pipelined
    (lookahead 2), and the busy share of a profiled pipelined run
    (tools/bench_stream.stream_phase). The frames' hashes must agree and
    differ from pose to pose; the pipelined run launches 8 x 2 K1, K2, K3
    and nearest-vertex kernels and 8 merges."""
    from avatarcap_tpu_torch.tools.bench_stream import stream_phase as run
    rec = run(capture, item, recon_kw)
    for way in ("loop", "pipelined"):
        r = rec[way]
        print(f"[stream] {way}: {r['frames_per_s']:.3f} frames/s, "
              f"{r['s_per_frame']:.4f} s a frame, launches {r['launches']}, "
              f"sha1 {[h[:10] for h in r['sha1']]}")
    prof = rec["profile"]
    print(f"[stream] hashes agree {rec['hashes_agree']}, distinct poses "
          f"{rec['distinct_poses']}; busy share of the card over the "
          f"profiled pipelined run {prof['busy_share']} ({prof['kernels']} "
          f"kernels, {prof['profiled_s']:.2f} s profiled)")
    want = {"k1": 16, "k2": 16, "k3": 16, "k4": 0, "k5": 0, "merge": 8,
            "knn": 16, "k2w": 0}
    if rec["pipelined"]["launches"] != want:
        raise AssertionError(f"the pipelined stream launched "
                             f"{rec['pipelined']['launches']}, expected "
                             f"{want}")
    if not rec["hashes_agree"] or not rec["distinct_poses"]:
        raise AssertionError(
            "the pipelined frames differ from the process_frame loop's, or "
            f"the poses do not: {rec['loop']['sha1']} "
            f"{rec['pipelined']['sha1']}")
    return rec


def shard_phase(capture, item, recon_kw, device):
    """[shard]: the production frame point-sharded over every visible card
    and over two slabs on the first, bit-equal to the unsharded frame; and
    ShardedGridQuery on the small subject against the unsharded f32 query
    (tools/bench_stream)."""
    import torch
    from avatarcap_tpu_torch.tools import bench_stream
    rec = bench_stream.shard_phase(capture, item, recon_kw)
    small, sitem, _, _ = small_subject(device)
    rec["query"] = bench_stream.sharded_query_check(
        small.avatar, small.statics, small.grid,
        torch.as_tensor(sitem["smpl_pos_map"])[None], device)
    rec["devices_used"] = torch.cuda.device_count()
    print(f"[shard] {json.dumps(rec)}")
    bad = [k for k, m in rec["meshes"].items() if not m["bit_equal"]]
    bad += [k for k in ("all_cards", "two_slabs")
            if not rec["query"][k]["bit_equal"]]
    if bad:
        raise AssertionError(f"sharded results differ from the unsharded "
                             f"ones: {bad}")
    return rec


def capacity_phase(capture, item, recon_kw, frames):
    """[capacity]: tools/capacity_stats on the fitted subject, each count
    beside its capacity and the JAX package's recorded count for its
    fitted bench body (their ratio), and the overflow bit of each frame
    form of phases 4-6 (``frames``: form -> frame record). Every count
    must be under its capacity and within 15% of the JAX count, and no
    form may overflow."""
    from avatarcap_tpu_torch.tools.capacity_stats import (JAX_BENCH_COUNTS,
                                                          capacity_stats)
    stats = capacity_stats(capture, item,
                           inferred_normal=recon_kw["inferred_normal"],
                           camera=recon_kw["camera"],
                           neck_vertex_idx=recon_kw["neck_vertex_idx"])
    rows = {}
    for name, row in stats.items():
        if not isinstance(row, dict):
            continue
        jax_count = JAX_BENCH_COUNTS.get(name)
        rows[name] = dict(row, jax_count=jax_count,
                          under_capacity=row["count"] <= row["capacity"])
        if jax_count:
            rows[name]["ratio_to_jax"] = row["count"] / jax_count
            rows[name]["within_15pct"] = abs(row["count"] / jax_count
                                             - 1.0) <= 0.15
        print(f"[capacity] {name}: {row['count']} of {row['capacity']} "
              f"(headroom {row['headroom']}), JAX bench {jax_count}"
              + (f", ratio {rows[name]['ratio_to_jax']:.3f}" if jax_count
                 else ""))
    overflow = {form: rec["overflow"] for form, rec in frames.items()}
    overflow["capacity_stats_frame"] = stats["frame_overflow"]
    print(f"[capacity] overflow by frame form: {json.dumps(overflow)}")
    # the capacities were sized to the JAX bench's fitted body: the port's
    # fitted subject must be that body
    bad = [k for k, r in rows.items() if not r["under_capacity"]
           or not r.get("within_15pct", True)]
    if bad or any(overflow.values()):
        raise AssertionError(f"the fitted subject's counts are off the JAX "
                             f"bench's or over capacity: {bad}; overflow "
                             f"{overflow}")
    return {"rows": rows, "overflow": overflow}


def normal_modes_phase(capture, item, recon_kw, device):
    """[normal_modes]: the production frame with normal_mode "mc_edge" and
    "sobel_sample" on the full-size subject (2 K1 + 2 K2 launches each),
    their overflow bits, the mean dot product of their avatar normals
    with the trilinear frame's over the soup, and frame_body's
    synchronising calls in its three forms (none); then the small
    production frame in both modes on the card against the CPU at phase
    10's tolerances."""
    import dataclasses
    import torch
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    from avatarcap_tpu_torch.tools.bench_stream import sync_counts
    ref, _ = run_frame(capture, item, device, w_recon=True, **recon_kw)
    valid = ref["cano_mesh"].valid.repeat_interleave(3)
    out = {}
    for mode in ("mc_edge", "sobel_sample"):
        cap = AvatarCapture(
            capture.avatar, capture.statics, capture.grid,
            recon=capture.recon, tex_avatar=capture.tex_avatar,
            options=dataclasses.replace(capture.opt, normal_mode=mode),
            device=device)
        res, rec = run_frame(cap, item, device, w_recon=True, **recon_kw)
        if (rec["k1_launches"], rec["k2_launches"]) != (2, 2):
            raise AssertionError(f"the {mode} frame launched K1 "
                                 f"{rec['k1_launches']} and K2 "
                                 f"{rec['k2_launches']} times, expected 2, 2")
        if rec["num_tris"] != int(ref["cano_mesh"].num_tris):
            raise AssertionError(f"the {mode} frame has {rec['num_tris']} "
                                 "triangles, the trilinear frame "
                                 f"{int(ref['cano_mesh'].num_tris)}")
        dots = (res["cano_mesh"].normals[valid]
                * ref["cano_mesh"].normals[valid]).sum(-1)
        rec["mean_dot_with_trilinear"] = float(dots.mean())
        rec["sync"] = sync_counts(cap, item, recon_kw)
        out[mode] = rec
        print(f"[normal_modes] {mode}: {rec['seconds']:.3f} s, launches K1 "
              f"{rec['k1_launches']} K2 {rec['k2_launches']}, triangles "
              f"{rec['num_tris']} / {rec['recon_num_tris']}, overflow "
              f"{rec['overflow']}, mean dot with the trilinear normals "
              f"{rec['mean_dot_with_trilinear']:.5f}, synchronising calls "
              + ", ".join(f"{k} {v['syncs']}" for k, v in rec["sync"].items()))
        if any(v["syncs"] for v in rec["sync"].values()):
            raise AssertionError(f"frame_body waits for the card with "
                                 f"normal_mode={mode}: {rec['sync']}")
        if rec["mean_dot_with_trilinear"] < 0.5:
            raise AssertionError(f"the {mode} normals point away from the "
                                 "trilinear ones")
        del cap, res
    out["small"] = {}
    for mode in ("mc_edge", "sobel_sample"):
        frames = {}
        for dev in (device, torch.device("cpu")):
            cap, sitem, skw, _ = small_subject(dev, normal_mode=mode)
            frames[dev.type] = cap.process_frame(sitem, w_recon=True, **skw)
        out["small"][mode] = card_cpu_agreement(
            frames[device.type], frames["cpu"], True, f"{mode}_w_recon")
    print(f"[normal_modes] small frames, card against CPU: "
          f"{json.dumps(out['small'])}")
    return out


def preflight_phase(capture, item, recon_kw):
    """[preflight]: tools/compile_preflight's peak memory of the
    production frame, the textured one and a 4-frame pipelined stream
    against the card's budget; each must fit."""
    from avatarcap_tpu_torch.tools.compile_preflight import preflight
    reports = preflight(capture, item, recon_kw, batch=4)
    for r in reports:
        print(f"[preflight] {r['program']}: peak {r['peak_gib']:.2f} GiB of "
              f"a {r['budget_gib']:.2f} GiB budget ({r['total_gib']:.2f} "
              f"GiB less {r['margin_gib']:.0f}): ok {r['ok']}")
    if not all(r["ok"] for r in reports):
        raise AssertionError(f"a program exceeds the budget: {reports}")
    return reports


def trace_phase(capture, item, recon_kw):
    """[trace]: one textured production frame under torch.profiler
    (tools/trace_frame): its top 10 kernels by device time with their
    launches, the total launches, and each stage's launches."""
    from avatarcap_tpu_torch.tools.trace_frame import trace
    rec = trace(capture, item, recon_kw, frames=1, w_nerf=True, top=10)
    print(f"[trace] textured frame: {rec['total_ms']:.2f} ms of device time "
          f"in {rec['launches']:.0f} launches of {rec['distinct_ops']} "
          f"distinct kernels; profiled frame {rec['profiled_s_per_frame']:.3f}"
          f" s")
    for o in rec["ops"]:
        print(f"[trace] {o['ms']:9.3f} ms {o['launches']:6.0f} launches "
              f"{o['share']:6.1%}  {o['name'][:110]}")
    print("[trace] launches by stage: " + ", ".join(
        f"{k} {v['launches']:.0f} ({v['ms']:.1f} ms)"
        for k, v in rec["stages"].items())
        + f"; outside the stages {rec['launches_outside_stages']:.0f}")
    if rec["launches"] <= 0 or rec["clock"] != "cuda":
        raise AssertionError("the profiler saw no kernel of the frame")
    return rec


def tools_phase(device):
    """[tools]: one short run of tools/bench_mc (the capture grid's size)
    and one of tools/bench_raster (a million triangles), CUDA-event
    times."""
    from avatarcap_tpu_torch.tools import bench_mc, bench_raster
    rec = {"bench_mc": bench_mc.run(iters=3, device=device),
           "bench_raster": bench_raster.run(iters=3, device=device)}
    for tool, r in rec.items():
        print(f"[tools] {tool}: " + ", ".join(
            f"{k} {v['ms']:.3f} ms" for k, v in r["passes"].items())
            + "; " + json.dumps({k: v for k, v in r.items()
                                 if k != "passes"}))
    mc = rec["bench_mc"]
    if mc["overflow"] or mc["tets_overflow"] or not (
            mc["triangles"] > 0 and mc["tets_triangles"] > mc["triangles"]):
        raise AssertionError(f"bench_mc's ellipsoid: {mc}")
    return rec


CLI_DIR = os.path.join(HERE, "build", "cli_phase")


def save_cli_networks(capture):
    """Phase 2's avatar, texture avatar and ReconNet as the checkpoint
    files the CLI reads (net.pt, recon_net.pt), under CLI_DIR."""
    import shutil
    import torch
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    dirs = {}
    for key, module, name in (("net_ckpt", capture.avatar, "net.pt"),
                              ("net_ckpt_finetuned", capture.tex_avatar,
                               "net.pt"),
                              ("recon_net_ckpt", capture.recon,
                               "recon_net.pt")):
        d = os.path.join(CLI_DIR, "networks", key)
        os.makedirs(d)
        torch.save(module.state_dict(), os.path.join(d, name))
        dirs[key] = d
    return dirs


def _ply_check(path):
    """(triangles, vertices finite) of a PLY the CLI wrote."""
    import numpy as np
    from avatarcap_tpu_torch.data.mesh_io import load_ply
    v, f, n, _ = load_ply(path)
    return len(f), bool(np.isfinite(v).all() and np.isfinite(n).all())


def cli_stream_run(device, cfg, flags, outputs):
    """The test CLI again with --stream 2 (both frames in one pipelined
    batch), its launch counts set to 0 just before and read just after;
    its JPEGs must equal the unstreamed run's byte for byte and its PLYs'
    triangle counts theirs."""
    import numpy as np
    import yaml
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.data.mesh_io import load_ply
    cfg = dict(cfg, testing=dict(cfg["testing"], output_dir=os.path.join(
        CLI_DIR, "out_stream")))
    path = os.path.join(CLI_DIR, "config_stream.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    _zero_launches()
    t0 = time.perf_counter()
    records = cli.main(["-c", path] + flags + ["--stream", "2"])
    _sync(device)
    rec = {"test_cli_s": time.perf_counter() - t0, "frames": records,
           "launches": _launches()}
    if (len(records), rec["launches"]["k1"], rec["launches"]["k2"],
            rec["launches"]["k3"]) != (2, 4, 4, 4):
        raise AssertionError(f"the streamed CLI's {len(records)} frames "
                             f"launched {rec['launches']}, expected 2 frames "
                             "of 2 K1, 2 K2 and 2 K3")
    a, b = (os.path.join(CLI_DIR, d) for d in ("out", "out_stream"))
    rec["jpegs_equal"] = {
        name: open(os.path.join(a, name), "rb").read()
        == open(os.path.join(b, name), "rb").read() for name in outputs}
    rec["ply"] = {}
    for i in (0, 1):
        for kind in ("avatar", "recon"):
            name = f"{i:04d}_{kind}.ply"
            pa, pb = (load_ply(os.path.join(d, name)) for d in (a, b))
            rec["ply"][name] = {
                "triangles": [len(pa[1]), len(pb[1])],
                "bit_equal": all(np.array_equal(x, y)
                                 for x, y in zip(pa, pb))}
    bad = ([n for n, ok in rec["jpegs_equal"].items() if not ok]
           + [n for n, r in rec["ply"].items()
              if r["triangles"][0] != r["triangles"][1]])
    print(f"[cli] --stream 2: {rec['test_cli_s']:.2f} s, launches "
          f"{rec['launches']}, JPEGs equal {all(rec['jpegs_equal'].values())}"
          f", PLYs bit-equal "
          f"{all(r['bit_equal'] for r in rec['ply'].values())}")
    if bad:
        raise AssertionError(f"the streamed CLI's outputs differ from the "
                             f"unstreamed run's: {bad}")
    return rec


def cli_phase(device, network_dirs):
    """Phase 12 (see the module docstring). Returns the [cli] record."""
    import numpy as np
    import torch
    import yaml
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.body.smpl import SmplParams, canonical_pose
    from avatarcap_tpu_torch.config import load_config
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset
    from avatarcap_tpu_torch.data.image_io import load_float_image
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureGrid)
    from avatarcap_tpu_torch.tools.bench_workloads import CAPTURE_OPTIONS
    from avatarcap_tpu_torch.tools.gen_synthetic import generate_subject
    from avatarcap_tpu_torch.utils.toy_body import (make_toy_smpl_params,
                                                    write_smpl_pkl)
    from avatarcap_tpu_torch.weights import load_reference_checkpoint
    rec = {}
    subject = os.path.join(CLI_DIR, "subject")
    smpl_dir = os.path.join(CLI_DIR, "smpl")
    os.makedirs(smpl_dir)
    params = make_toy_smpl_params(n_lat=77, n_lon=90)     # 6,752 vertices
    write_smpl_pkl(params, os.path.join(smpl_dir,
                                        cli.SMPL_FILES["M"]))
    posed = canonical_pose().copy()
    posed[6:] += np.random.RandomState(0).uniform(
        -0.2, 0.2, posed.size - 6).astype(np.float32)
    t0 = time.perf_counter()
    generate_subject(subject, params, np.zeros(10, np.float32),
                     np.stack([canonical_pose(), posed]), n_views=2,
                     img_size=512, pos_map_res=256, device=device)
    _sync(device)
    rec["subject_write_s"] = time.perf_counter() - t0

    opts = {k: v for k, v in CAPTURE_OPTIONS.items() if k != "render_res"}
    cfg = {"training": {"training_data_dir": subject,
                        "net_ckpt_dir": os.path.join(CLI_DIR, "train"),
                        "end_epoch": 2, "finetune_tex": False},
           "testing": {"vol_res": [384, 384, 128], "render_res": 512,
                       "testing_data_dir": subject,
                       "output_dir": os.path.join(CLI_DIR, "out"),
                       "capture_options": opts, **network_dirs},
           "smpl_model_dir": smpl_dir}
    cfg_path = os.path.join(CLI_DIR, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    t0 = time.perf_counter()
    cli.main(["-c", cfg_path, "-m", "train"])
    _sync(device)
    rec["train_cli_s"] = time.perf_counter() - t0
    latest = os.path.join(CLI_DIR, "train", "epoch_latest", "net.pt")
    back = GeoTexAvatar()
    load_reference_checkpoint(back, latest)
    saved = torch.load(latest, map_location="cpu", weights_only=True)
    if any(not torch.equal(v, saved[k])
           for k, v in back.state_dict().items()):
        raise AssertionError("epoch_latest/net.pt does not read back")

    params = SmplParams.load(os.path.join(smpl_dir, cli.SMPL_FILES["M"]))
    _sync(device)
    t0 = time.perf_counter()
    ds = AvatarCapDataset(subject, training=False, smpl_params=params,
                          vol_res=(384, 384, 128), device=device)
    _sync(device)
    rec["test_grid_s"] = time.perf_counter() - t0
    # the inside test's share of the grid build, run once more alone
    from avatarcap_tpu_torch.ops.inside import points_inside_mesh
    tris = torch.as_tensor(ds.cano_smpl_v[params.faces], device=device)
    t0 = time.perf_counter()
    points_inside_mesh(ds.infer_pts, tris)
    _sync(device)
    rec["inside_test_s"] = time.perf_counter() - t0
    rec["grid_nodes"] = int(ds.infer_pts.shape[0])
    rec["grid_triangles"] = int(len(params.faces))
    rec["near_body_nodes"] = ds.num_valid_pts
    rec["near_body_nodes_stand_in_grid"] = 9238537
    rec["inside_prior_nodes"] = int((ds.prior_volume > 0).sum())

    flags = ["-m", "test", "--nerf", "--save-avatar-mesh",
             "--save-final-mesh"]
    _zero_launches()
    t0 = time.perf_counter()
    records = cli.main(["-c", cfg_path] + flags)
    _sync(device)
    rec["test_cli_s"] = time.perf_counter() - t0
    launches = _launches()
    frame = records[0]
    rec.update(frame=frame, frames=records, launches=launches)
    if (len(records), launches["k1"], launches["k2"],
            launches["k3"]) != (2, 4, 4, 4):
        raise AssertionError(f"the CLI's {len(records)} frames launched "
                             f"{launches}, expected 2 frames of 2 K1, 2 K2 "
                             "and 2 K3")
    out = os.path.join(CLI_DIR, "out")
    outputs = [f"{sub}/{i:04d}.jpg" for sub in ("cano_avatar", "live_avatar",
                                                "live_recon") for i in (0, 1)]
    for name in outputs:
        if not os.path.getsize(os.path.join(out, name)):
            raise AssertionError(f"the CLI wrote no {name}")
    plys = {k: _ply_check(os.path.join(out, f"0000_{k}.ply"))
            for k in ("avatar", "recon")}
    rec["ply_triangles"] = {k: v[0] for k, v in plys.items()}
    if not all(n > 0 and ok for n, ok in plys.values()):
        raise AssertionError(f"the CLI's PLYs: {plys}")
    rec["stream"] = cli_stream_run(device, cfg, flags, outputs)

    # process_frame on the same dataset item and weights
    c = load_config(cfg_path)
    statics = AvatarStatics(*(torch.as_tensor(np.asarray(a, np.float32))
                              for a in (np.load(os.path.join(
                                  subject,
                                  "cano_base_blend_weight_volume.npy")),
                                  ds.cano_smpl_v, params.weights,
                                  ds.cano_bounds, ds.cano_smpl_center)))
    avatar = GeoTexAvatar()
    load_reference_checkpoint(avatar, os.path.join(
        network_dirs["net_ckpt"], "net.pt"))
    tex = GeoTexAvatar()
    load_reference_checkpoint(tex, os.path.join(
        network_dirs["net_ckpt_finetuned"], "net.pt"))
    recon = ReconNetwork()
    load_reference_checkpoint(recon, os.path.join(
        network_dirs["recon_net_ckpt"], "recon_net.pt"))
    capture = AvatarCapture(
        avatar, statics, CaptureGrid(ds.valid_pts, ds.valid_pts_idx,
                                     ds.prior_volume, (384, 384, 128)),
        recon=recon, tex_avatar=tex, options=cli._capture_options(c),
        device=device)
    item = ds[0]
    normal = load_float_image(os.path.join(
        subject, f"imgs/{item['data_idx']:03d}/normal_view_000.exr"))
    with torch.inference_mode():
        res = capture.process_frame(
            item, w_recon=True, w_nerf=True, inferred_normal=normal,
            neck_vertex_idx=cli.NECK_VERTEX_IDX,
            camera=ds.data_config["camera"])
    rec["process_frame_triangles"] = int(res["live_mesh"].num_tris)
    if rec["process_frame_triangles"] != rec["ply_triangles"]["avatar"]:
        raise AssertionError(
            f"the CLI's avatar PLY has {rec['ply_triangles']['avatar']} "
            f"triangles, process_frame {rec['process_frame_triangles']}")
    # where the CLI subject's frame overflows: every count beside its
    # capacity (tools/capacity_stats) through the kernels and through the
    # f32 module path (the path tests/test_torch_capture.py holds equal to
    # the JAX package's XLA path, count for count)
    import dataclasses
    from avatarcap_tpu_torch.tools.capacity_stats import capacity_stats
    stats_kw = dict(inferred_normal=normal, camera=ds.data_config["camera"],
                    neck_vertex_idx=cli.NECK_VERTEX_IDX)
    rec["capacity"] = {"kernels": capacity_stats(capture, item, **stats_kw)}
    f32 = AvatarCapture(
        avatar, statics, capture.grid, recon=recon, tex_avatar=tex,
        options=dataclasses.replace(capture.opt, use_fused_query=False),
        device=device)
    rec["capacity"]["f32"] = capacity_stats(f32, item, **stats_kw)
    del f32
    # the inputs of the lift's live position pass, where the frame
    # overflows, for tests/jax_cli_live_pass.py (the JAX package's pass
    # on them, on the CPU)
    live = res["live_mesh"]
    h, w = normal.shape[:2]
    mvp = capture._projection(ds.data_config["camera"], h, w) @ \
        torch.as_tensor(item["w2c_RT"], device=device)
    o = capture.opt
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    np.savez_compressed(
        os.path.join(HERE, "chiprun_out", "cli_live_pass.npz"),
        vertices=live.vertices.cpu().numpy(), valid=live.valid.cpu().numpy(),
        mvp=mvp.cpu().numpy(), height=h, width=w, window=o.cano_window,
        big_tri_capacity=o.live_big_tris,
        max_candidates=o.raster_max_candidates)
    for path, stats in rec["capacity"].items():
        over = {k: v for k, v in stats.items()
                if isinstance(v, dict) and v["count"] > v["capacity"]}
        print(f"[cli] capacity ({path}): frame overflow "
              f"{stats['frame_overflow']}; over capacity: {json.dumps(over)}")
    print(f"[cli] subject write {rec['subject_write_s']:.2f} s; train CLI "
          f"(2 epochs) {rec['train_cli_s']:.2f} s; test grid "
          f"{rec['test_grid_s']:.2f} s (inside test {rec['inside_test_s']:.2f}"
          f" s of it; {rec['grid_nodes']} nodes x "
          f"{rec['grid_triangles']} triangles; {rec['near_body_nodes']} "
          f"near-body nodes, the stand-in grid had 9238537); test CLI "
          f"{rec['test_cli_s']:.2f} s, its frame {frame['seconds']:.3f} s, "
          f"overflow {frame['overflow']}, stages "
          + ", ".join(f"{k} {1e3 * v:.1f} ms"
                      for k, v in frame["stages"].items()))
    del capture, res, ds
    return rec


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
    phase_s = {}

    def mark(name):
        # wall seconds of each phase since the previous mark
        phase_s[name] = time.perf_counter() - t_all - sum(phase_s.values())

    record["build"] = build_kernels()
    mark("build")

    t0 = time.perf_counter()
    capture, item, recon_kw, info = build_subject(device)
    record["subject"] = {"seconds": time.perf_counter() - t0,
                         "grid_valid_points": info["n_valid"],
                         "vol_res": list(capture.grid.vol_res)}
    record["fit"] = info["fit"]
    print(f"[fit] {json.dumps(info['fit'])}")
    print(f"[subject] {record['subject']}")
    mark("subject")

    record["weight_image"] = weight_image_record(capture, device)
    print(f"[weight_image] {json.dumps(record['weight_image'])}")
    recorded, n_refined = k1_launch_inputs(capture, item)
    k1 = check_k1(capture, recorded, device)
    k1["refined_nodes"] = n_refined
    print(f"[k1] {json.dumps(k1)}")
    k4, k5 = check_k4_k5(capture, *recorded[0], device)
    print(f"[k4] {json.dumps(k4)}")
    print(f"[k5] {json.dumps(k5)}")
    mark("k1_k4_k5")
    record["query_fused"] = query_fused_phase(capture, item, recorded[-1][0],
                                              device)
    k1["query_fused_ms"] = record["query_fused"]["ms"]
    del recorded
    mark("query_fused")

    run_frame(capture, item, device, w_recon=False)           # warm-up
    _, frame = run_frame(capture, item, device, w_recon=False)
    got = (frame["k1_launches"], frame["k2_launches"], frame["k3_launches"],
           frame["merge_launches"], frame["knn_launches"])
    if got != (2, 0, 0, 0, 0):
        raise AssertionError(
            f"the avatar-only frame launched K1, K2, K3, merge, knn {got} "
            "times, expected 2, 0, 0, 0, 0")
    frame["stages"] = stage_times(capture, item, device, w_recon=False)
    record["frame"] = frame
    print(f"[frame] {json.dumps(frame)}")
    mark("frame")

    k2 = production_frames(capture, item, recon_kw, device)
    print(f"[k2] {json.dumps(k2)}")
    k2w, record["pifu"] = pifu_phase(capture, item, recon_kw, info["fit"],
                                     device)
    merge = merge_phase(capture, device)
    print(f"[merge] {json.dumps(merge)}")
    frame_r = timed_production_frames(capture, item, recon_kw, device)
    record["frame_w_recon"] = frame_r
    print(f"[frame_w_recon] {json.dumps(frame_r)}")
    mark("k2_frame_w_recon")

    k3, frame_n = textured_frames(capture, item, recon_kw, device)
    record["frame_w_nerf"] = frame_n
    print(f"[frame_w_nerf] {json.dumps(frame_n)}")
    mark("k3_frame_w_nerf")
    knn = knn_phase(capture, item, recon_kw, device)
    print(f"[knn] {json.dumps(knn)}")
    mark("knn")
    record["occupancy"] = occupancy_phase(capture, item, recon_kw, frame_n,
                                          device)
    mark("occupancy")

    record["capacity"] = capacity_phase(
        capture, item, recon_kw, {"avatar_only": frame,
                                  "w_recon": frame_r, "w_recon_w_nerf": frame_n})
    mark("capacity")
    record["normal_modes"] = normal_modes_phase(capture, item, recon_kw,
                                                device)
    mark("normal_modes")
    record["sync"] = sync_phase(capture, item, recon_kw)
    mark("sync")
    record["stream"] = stream_phase(capture, item, recon_kw)
    mark("stream")
    record["shard"] = shard_phase(capture, item, recon_kw, device)
    mark("shard")
    record["preflight"] = preflight_phase(capture, item, recon_kw)
    mark("preflight")
    record["trace"] = trace_phase(capture, item, recon_kw)
    mark("trace")
    network_dirs = save_cli_networks(capture)
    del capture
    from avatarcap_tpu_torch.ops.fused_query import weight_image
    record["weight_image"]["builds_by_wrappers"] = weight_image.builds
    print(f"[weight_image] built {weight_image.builds} times by the "
          "wrappers in this run (once per packed set and kernel family)")
    kerns = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k5": k5}
    for name, kern in (*kerns.items(), ("merge", merge), ("knn", knn)):
        # launches of this slice's main path, the pipelined stream of
        # textured production frames; the single frame's beside them
        kern["launches"] = record["stream"]["pipelined"]["launches"][name]
        kern["launches_textured_frame"] = frame_n[f"{name}_launches"]
    # K2w's launches are the PIFu stream's ([pifu], as many frames)
    k2w["launches_textured_frame"] = frame_n["k2w_launches"]
    kerns["k2w"] = k2w

    record["small_frame"] = check_small_frame(device)
    print(f"[small] {json.dumps(record['small_frame'])}")
    mark("small")

    from avatarcap_tpu_torch.tools import bench_train
    record["train"] = bench_train.run(device)
    print(f"[train] {json.dumps(record['train'])}")
    mark("train")
    record["train_mesh"] = bench_train.run_mesh(device)
    print(f"[train_mesh] {json.dumps(record['train_mesh'])}")
    mark("train_mesh")
    record["tools"] = tools_phase(device)
    mark("tools")

    import shutil
    try:
        record["cli"] = cli_phase(device, network_dirs)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    print(f"[cli] {json.dumps(record['cli'])}")
    mark("cli")

    from avatarcap_tpu_torch.tools import bench_preprocess
    try:
        record["preprocess"] = bench_preprocess.run_scan(device)
        print(f"[preprocess] {json.dumps(record['preprocess'])}")
        mark("preprocess")
        record["preprocess_real"] = bench_preprocess.run_real(device)
        print(f"[preprocess_real] {json.dumps(record['preprocess_real'])}")
        mark("preprocess_real")
    finally:
        shutil.rmtree(bench_preprocess.WORK_DIR, ignore_errors=True)
    record["phase_seconds"] = phase_s
    print(f"[time] seconds by phase: {json.dumps(phase_s)}")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tolerance", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels_line = {"kernels": [{k: kern[k] for k in keys}
                                for kern in (*kerns.values(), merge, knn)]}
    from avatarcap_tpu_torch.tools.bench_kernels import (
        PEAK_BF16_FLOPS, gpu_name_and_power_limit)
    smi = gpu_name_and_power_limit()
    for name, kern in kerns.items():
        print(f"[rate] {name} {kern['name']}: {kern['tflops']:.1f} TFLOP/s "
              f"of {PEAK_BF16_FLOPS / 1e12:.0f}, {kern['ms']:.3f} ms against "
              f"a bound of {kern['bound_ms']:.3f} ms "
              f"({100 * kern['share_of_bound']:.1f}%)")
    record.update(kerns, merge=merge, knn=knn)
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
