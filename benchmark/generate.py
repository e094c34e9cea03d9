"""The one traffic generator: what a mix's data file asks for, drawn from
the run's seed.

A capture mix is a video of distinct poses (a closed loop, one client):
``stream_items`` of avatarcap_tpu_torch/tools/bench_stream.py at commit
2621afd, drawn from the seed instead of a fixed generator, with joint
shifts that drift along the sequence and a synthetic inferred normal map
per frame. A training mix is a pool of posed batches and their sample
jitter (subject.train_batch's draws).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.subject import bench_camera, seed_parts, train_batch


def capture_video(mix: dict, cfg: dict, cano_v: np.ndarray, num_joints: int,
                  seed: int) -> List[Dict]:
    """``mix["frames"]`` distinct frames: a base position map N(0,
    pos_map_sigma) at the configuration's map size; per frame, fresh
    N(0, pos_noise) on it, every joint's shift a random walk of steps
    U(+-joint_step) kept within +-joint_max, and an inferred normal map
    that is ``normal_base`` (facing the camera) tilted by U(+-normal_tilt)
    in x and y plus N(0, normal_noise) per pixel, normalised, on the
    image's central half (zero elsewhere); the configuration's camera."""
    rng = np.random.default_rng(seed_parts(seed, 2)[1])
    res = cfg["pos_map_res"]
    img = cfg["capture"]["img_res"]
    w2c, camera = bench_camera(img, cfg["capture"]["w2c"])
    base = rng.standard_normal((res, res, 6)).astype(np.float32) * mix[
        "pos_map_sigma"]
    shift = np.zeros((num_joints, 3), np.float32)
    q = img // 4
    frames = []
    for _ in range(mix["frames"]):
        pos = base + mix["pos_noise"] * rng.standard_normal(
            base.shape).astype(np.float32)
        shift = np.clip(shift + rng.uniform(
            -mix["joint_step"], mix["joint_step"], shift.shape),
            -mix["joint_max"], mix["joint_max"]).astype(np.float32)
        jm = np.tile(np.eye(4, dtype=np.float32), (num_joints, 1, 1))
        jm[:, :3, 3] = shift
        frame = {"live_smpl_v": cano_v.astype(np.float32),
                 "cano2live_jnt_mats": jm, "smpl_pos_map": pos,
                 "w2c_RT": w2c, "camera": camera,
                 "neck_vertex_idx": cfg["capture"]["neck_vertex_idx"]}
        if mix["w_recon"]:
            tilt = rng.uniform(-mix["normal_tilt"], mix["normal_tilt"], 2)
            n = np.zeros((img - 2 * q, img - 2 * q, 3), np.float32)
            n[...] = np.asarray(mix["normal_base"], np.float32)
            n[..., :2] += tilt
            n += mix["normal_noise"] * rng.standard_normal(n.shape).astype(
                np.float32)
            n /= np.linalg.norm(n, axis=-1, keepdims=True)
            normal = np.zeros((img, img, 3), np.float32)
            normal[q:img - q, q:img - q] = n
            frame["inferred_normal"] = normal
        frames.append(frame)
    return frames


def train_pool(mix: dict, cfg: dict, params, cano_v: np.ndarray,
               center: np.ndarray, seed: int) -> List[Dict]:
    """``mix["pool"]`` posed batches, each with its (B, R, S) uniform
    sample jitter, all distinct."""
    rng = np.random.default_rng(seed_parts(seed, 3)[2])
    tr = cfg["train"]
    pool = []
    for _ in range(mix["pool"]):
        b = train_batch(params, cano_v, center, tr, rng)
        b["t_rand"] = rng.uniform(
            0.0, 1.0, (tr["batch_size"], tr["n_rays"], tr["n_samples"])
        ).astype(np.float32)
        pool.append(b)
    return pool
