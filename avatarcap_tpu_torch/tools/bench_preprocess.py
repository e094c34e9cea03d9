"""The offline preprocessing on one NVIDIA GPU at full size
(tools/preprocess.py), and its checks: the ``[preprocess]`` and
``[preprocess_real]`` phases of chip_smoke.py, also runnable alone.

- ``run_scan``: a scan made from the capture subject's toy body (6,752
  vertices), posed at the bench pose, subdivided twice (109,442
  vertices, 218,880 faces), displaced 6 mm along its normals by
  bench_workloads.wrinkle_field and colored by position, written as
  scan/000.ply with smpl/shape.txt and smpl/pose_0000.txt; then
  ``preprocess_training_data`` at the JAX package's defaults (60 views at
  512^2, 256^2 position maps, 2.2 M + 10k presampled points, 200 fit
  steps, Poisson at 256^3). Records each stage's seconds, the counts,
  the template's mean distance to the scan before and after the fit and
  the peak device memory. Checks: the fit lowers that distance; the
  Poisson mesh is finite and its marching tets did not overflow; a
  second Poisson solve on the same points gives the same bits; on
  65,536 presampled points the BVH's labels and the device's
  ``signed_distance`` agree within 1e-5 in magnitude, in sign on 99.9%;
  the port's ``AvatarCapDataset(training=True)`` reads the subject, its
  first item finite.
- ``run_real``: two real-layout frames (1024^2 color JPG and mask, the
  toy body at two poses 2.2 m in front of the camera) through
  ``preprocess_real_data`` with a ``GlobalGenerator(3, 3, 64, 4, 9)``
  (the reference's define_G widths) drawn from a fixed torch.Generator,
  on 512^2 crops. Records the seconds per frame. Checks: the normal maps
  are finite, zero outside the mask and not zero inside; the generator's
  output on one crop on the device and on the CPU agree within 1e-3.

Each returns its record and raises AssertionError on a failed check.

Usage: python -m avatarcap_tpu_torch.tools.bench_preprocess [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import time
from pathlib import Path

import cv2 as cv
import numpy as np
import torch
import yaml

from avatarcap_tpu_torch.body.smpl import (SmplParams, canonical_pose,
                                           smpl_forward)
from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.models.pix2pix import GlobalGenerator
from avatarcap_tpu_torch.tools import preprocess
from avatarcap_tpu_torch.utils.toy_body import make_toy_smpl_params

WORK_DIR = Path(__file__).resolve().parents[2] / "build" / "preprocess_phase"
# The device's signed distance against the BVH's labels: the same float32
# projection on both sides, candidates from a KNN on the device
SDF_ATOL = 1e-5
SDF_SIGN_SHARE = 0.999
SDF_CHECK_POINTS = 65536
# The generator on the device and on the CPU: float32 on both, the
# convolutions summed in different orders
GENERATOR_ATOL = 1e-3


def bench_pose(seed: int = 2, spread: float = 0.15) -> np.ndarray:
    """The canonical pose with every joint rotation but the root's moved
    by U(+-spread) from RandomState(seed) (the JAX package's end-to-end
    preprocessing test draws its scan pose so)."""
    pose = canonical_pose().copy()
    rng = np.random.RandomState(seed)
    pose[6:] += rng.uniform(-spread, spread, pose.size - 6).astype(
        np.float32)
    return pose


def _fk_vertices(params: SmplParams, pose: np.ndarray,
                 shape: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return smpl_forward(params, torch.as_tensor(pose),
                            torch.as_tensor(shape)).vertices.numpy()


def write_scan_subject(data_dir: str, params: SmplParams, pose: np.ndarray,
                       subdivisions: int = 2,
                       wrinkle_amp: float = 0.006) -> dict:
    """A scan subject in the layout preprocess_training_data reads: the
    body posed at ``pose`` (zero shape), subdivided ``subdivisions``
    times, displaced ``wrinkle_amp`` along its normals by wrinkle_field
    (about the scan's box center), colored by position; scan/000.ply with
    normals and colors, smpl/shape.txt, smpl/pose_0000.txt."""
    from avatarcap_tpu_torch.data.mesh_io import save_ply
    from avatarcap_tpu_torch.tools.bench_workloads import wrinkle_field
    os.makedirs(os.path.join(data_dir, "scan"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "smpl"), exist_ok=True)
    shape = np.zeros(10, np.float32)
    v, f = preprocess.subdivide_mesh(_fk_vertices(params, pose, shape),
                                     params.faces, iterations=subdivisions)
    center = 0.5 * (v.max(0) + v.min(0))
    bump = wrinkle_field(torch.as_tensor(v - center)).numpy()
    v = (v + wrinkle_amp * bump[:, None]
         * preprocess.vertex_normals(v, f)).astype(np.float32)
    lo, hi = v.min(0), v.max(0)
    save_ply(os.path.join(data_dir, "scan/000.ply"), v, f,
             normals=preprocess.vertex_normals(v, f),
             colors=((v - lo) / (hi - lo)).astype(np.float32))
    np.savetxt(os.path.join(data_dir, "smpl/shape.txt"), shape)
    np.savetxt(os.path.join(data_dir, "smpl/pose_0000.txt"), pose)
    return {"scan_vertices": len(v), "scan_faces": len(f)}


def write_real_frames(data_dir: str, params: SmplParams, poses,
                      img_size: int = 1024,
                      focal: float = 1500.0) -> np.ndarray:
    """Real-layout frames: per pose, imgs/color/color_NNNN.jpg (the body
    drawn far to near, each face colored by its position) and
    imgs/mask/mask_NNNN.png at img_size^2 through a pinhole camera at the
    origin, smpl/pose_NNNN.txt, smpl/shape.txt and dataConfig.yaml with
    the camera (poses carry their translation in front of the camera).
    Returns the camera's 3 x 3 intrinsics."""
    for sub in ("imgs/color", "imgs/mask", "smpl"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)
    shape = np.zeros(10, np.float32)
    np.savetxt(os.path.join(data_dir, "smpl/shape.txt"), shape)
    cam = {"fx": focal, "fy": focal, "cx": img_size / 2.0,
           "cy": img_size / 2.0, "img_width": img_size,
           "img_height": img_size}
    with open(os.path.join(data_dir, "dataConfig.yaml"), "w") as f:
        yaml.safe_dump({"data_type": "real", "camera": cam}, f)
    K = np.array([[focal, 0, cam["cx"]], [0, focal, cam["cy"]], [0, 0, 1]],
                 np.float32)
    for i, pose in enumerate(poses):
        np.savetxt(os.path.join(data_dir, f"smpl/pose_{i:04d}.txt"), pose)
        tri = _fk_vertices(params, pose, shape)[params.faces]   # (F, 3, 3)
        proj = tri @ K.T
        xy = np.round(proj[..., :2] / proj[..., 2:]).astype(np.int32)
        lo, hi = tri.min((0, 1)), tri.max((0, 1))
        color = 255 * (tri.mean(1) - lo) / (hi - lo)
        img = np.zeros((img_size, img_size, 3), np.uint8)
        mask = np.zeros((img_size, img_size), np.uint8)
        for fi in np.argsort(-tri[..., 2].mean(1)):
            cv.fillConvexPoly(img, xy[fi], color[fi].tolist())
            cv.fillConvexPoly(mask, xy[fi], 255)
        cv.imwrite(os.path.join(data_dir, f"imgs/color/color_{i:04d}.jpg"),
                   img)
        cv.imwrite(os.path.join(data_dir, f"imgs/mask/mask_{i:04d}.png"),
                   mask)
    return K


def random_generator(seed: int = 0, ngf: int = 64, n_downsampling: int = 4,
                     n_blocks: int = 9) -> GlobalGenerator:
    """GlobalGenerator(3, 3, ngf, n_downsampling, n_blocks) with every
    convolution's weights N(0, 0.02) (the reference's pix2pixHD
    weights_init) and zero biases, drawn on the host from
    torch.Generator(seed) in module order."""
    g = torch.Generator().manual_seed(seed)
    model = GlobalGenerator(3, 3, ngf, n_downsampling, n_blocks)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.normal_(0.0, 0.02, generator=g)
                m.bias.zero_()
    return model.eval()


def _peak_reset(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def run_scan(device=None, work_dir=WORK_DIR, subdivisions: int = 2,
             dense: bool = True, check_points: int = SDF_CHECK_POINTS,
             **sizes) -> dict:
    """The [preprocess] phase (module docstring); ``sizes``
    (preprocess_training_data's n_views, img_size, pos_map_res,
    sur_count, vol_count, fit_iterations) and ``dense=False`` (the sparse
    toy body) shrink it for a rehearsal on the CPU."""
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset
    from avatarcap_tpu_torch.ops.closest_point import signed_distance
    device = resolve_device(device)
    data_dir = str(Path(work_dir) / "scan_subject")
    shutil.rmtree(data_dir, ignore_errors=True)
    params = make_toy_smpl_params(**(dict(n_lat=77, n_lon=90) if dense
                                     else {}))
    rec = write_scan_subject(data_dir, params, bench_pose(),
                             subdivisions=subdivisions)
    _peak_reset(device)
    t0 = time.perf_counter()
    run = preprocess.preprocess_training_data(data_dir, params,
                                              device=device, **sizes)
    rec["seconds"] = time.perf_counter() - t0
    rec["peak_gb"] = _peak_gb(device)
    scan = run["scans"][0]
    recon = scan.pop("reconstruction")
    rec["stage_seconds"] = {**run["seconds"], **scan["seconds"]}
    rec["counts"] = counts = scan["counts"]

    before = counts["template_scan_mean_distance_before"]
    after = counts["template_scan_mean_distance_after"]
    if not after < before:
        raise AssertionError(f"the fit did not bring the template nearer "
                             f"the scan: {before} -> {after} m")
    verts, nt = recon["verts"], counts["triangles"]
    if nt <= 0 or not np.isfinite(verts).all():
        raise AssertionError(f"the Poisson mesh ({nt} triangles) is empty "
                             "or not finite")
    if counts["poisson_overflow"]:
        raise AssertionError("the Poisson mesh's marching tets overflowed")

    t0 = time.perf_counter()
    again, nt2 = preprocess.poisson_reconstruct(
        recon["points"], recon["normals"], device=device)
    rec["poisson_repeat_s"] = time.perf_counter() - t0
    rec["poisson_bit_equal"] = (nt2 == nt
                                and again.tobytes() == verts.tobytes())
    if not rec["poisson_bit_equal"]:
        raise AssertionError(f"a second Poisson solve differs: {nt2} "
                             f"against {nt} triangles")

    with np.load(os.path.join(data_dir, "cano_pts_ov/000.npz")) as data:
        pts = data["sur_pts"][:check_points]
        labels = data["sur_pts_ov"][:check_points]
    faces = torch.arange(3 * nt, device=device).reshape(-1, 3)
    with torch.no_grad():
        sdf, _ = signed_distance(torch.as_tensor(pts, device=device),
                                 torch.as_tensor(verts, device=device),
                                 faces)
    sdf = sdf.cpu().numpy()
    rec["sdf_check"] = {
        "points": len(pts),
        "max_abs_err": float(np.abs(np.abs(sdf) - np.abs(labels)).max()),
        "sign_share": float((np.sign(sdf) == np.sign(labels)).mean())}
    if (rec["sdf_check"]["max_abs_err"] > SDF_ATOL
            or rec["sdf_check"]["sign_share"] < SDF_SIGN_SHARE):
        raise AssertionError(f"the device's signed distance disagrees with "
                             f"the BVH's: {rec['sdf_check']}")

    ds = AvatarCapDataset(data_dir, training=True, smpl_params=params)
    item = ds[0]
    rec["dataset_items"] = len(ds)
    if not all(np.isfinite(v).all() for v in item.values()
               if isinstance(v, np.ndarray) and v.dtype.kind == "f"):
        raise AssertionError("the dataset's first item is not finite")
    return rec


def run_real(device=None, work_dir=WORK_DIR, img_size: int = 1024,
             dense: bool = True, generator_kw=None) -> dict:
    """The [preprocess_real] phase (module docstring); ``img_size``,
    ``dense=False`` and ``generator_kw`` (random_generator's widths)
    shrink it for a rehearsal on the CPU."""
    from avatarcap_tpu_torch.data.image_io import load_float_image
    device = resolve_device(device)
    data_dir = str(Path(work_dir) / "real_subject")
    shutil.rmtree(data_dir, ignore_errors=True)
    params = make_toy_smpl_params(**(dict(n_lat=77, n_lon=90) if dense
                                     else {}))
    poses = []
    for seed in (3, 4):
        pose = bench_pose(seed)
        pose[:3] = (0.0, 0.0, 2.2)
        poses.append(pose)
    K = write_real_frames(data_dir, params, poses, img_size=img_size,
                          focal=1500.0 * img_size / 1024)
    gen = random_generator(**(generator_kw or {}))
    gen_dev = copy.deepcopy(gen).to(device)
    _peak_reset(device)
    t0 = time.perf_counter()
    frames = preprocess.preprocess_real_data(data_dir, params,
                                             generator=gen_dev,
                                             device=device)
    rec = {"seconds": time.perf_counter() - t0, "peak_gb": _peak_gb(device),
           "frames": frames}
    for i in range(len(poses)):
        normal = load_float_image(os.path.join(
            data_dir, f"imgs/normal/normal_{i:04d}"))
        mask = cv.imread(os.path.join(data_dir,
                                      f"imgs/mask/mask_{i:04d}.png"),
                         cv.IMREAD_UNCHANGED)
        if (normal.shape != (img_size, img_size, 3)
                or not np.isfinite(normal).all()
                or np.abs(normal[mask == 0]).max() != 0.0
                or not np.abs(normal[mask > 0]).max() > 0.0):
            raise AssertionError(f"frame {i}'s normal map is not finite, "
                                 "not zero outside the mask, or empty")

    img = cv.imread(os.path.join(data_dir, "imgs/color/color_0000.jpg"))
    mask = cv.imread(os.path.join(data_dir, "imgs/mask/mask_0000.png"),
                     cv.IMREAD_UNCHANGED)
    crop, _, _ = preprocess.crop_square_by_smpl(
        img.astype(np.float32) / 255.0, mask,
        _fk_vertices(params, poses[0], np.zeros(10, np.float32)), K)
    x = torch.from_numpy(crop * 2.0 - 1.0).permute(2, 0, 1)[None]
    with torch.no_grad():
        out_dev = gen_dev(x.to(device)).cpu()
        out_cpu = gen(x)
    rec["generator_card_cpu_max_abs"] = float((out_dev - out_cpu).abs().max())
    rec["crop"] = list(crop.shape)
    if rec["generator_card_cpu_max_abs"] > GENERATOR_ATOL:
        raise AssertionError(f"the generator on {device} and on the CPU "
                             f"differ by {rec['generator_card_cpu_max_abs']}")
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        print(f"[preprocess] {json.dumps(run_scan(device))}")
        print(f"[preprocess_real] {json.dumps(run_real(device))}")
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    if device.type == "cuda":
        from avatarcap_tpu_torch.tools.bench_kernels import \
            gpu_name_and_power_limit
        print(gpu_name_and_power_limit())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
