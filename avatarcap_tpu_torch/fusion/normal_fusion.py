"""Canonical normal fusion (counterpart of
avatarcap_tpu/fusion/normal_fusion.py: ``lift_image_normals``,
``canonicalize_normal_map``, ``merge_normal_images`` and
``merge_normal_images_cover``).

- The lift rasterizes the live mesh's positions from the capture camera
  (a perspective index pass), keeps the vertices whose projected
  position-buffer sample lies within 5 cm of themselves, samples the
  image normals there and rotates them back to canonical space.
- The merge is the reference's two-phase optimisation: 50 Adam steps
  (lr 1e-2) on a 64 x 64 axis-angle rotation grid, then 50 (lr 1e-1) on
  the normal image. On the card both phases are one launch of
  csrc/normal_merge.cu, which computes the gradients in closed form; on
  the CPU they run under ``torch.autograd`` (merge_normal_images_plain).
  The Adam step (ops/adam.py, and the kernel's copy of it) is optax's
  order of operations, so the 100-step trajectory stays close to the JAX
  package's. Then the distance-transform blend and the face box.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from avatarcap_tpu_torch import kernels
from avatarcap_tpu_torch.body.skinning import mats16_inv_rotate
from avatarcap_tpu_torch.device import device_constant
from avatarcap_tpu_torch.ops.adam import Adam
from avatarcap_tpu_torch.ops.morphology import distance_transform_l1, erode_3x3
from avatarcap_tpu_torch.ops.se3 import axis_angle_to_matrix
from avatarcap_tpu_torch.render.raster import rasterize
from avatarcap_tpu_torch.render.visualize import render_cano_mesh
from avatarcap_tpu_torch.utils.timers import count, live_rows, span

# the rotation grid's side (csrc/normal_merge.cu: kGrid) and the two
# phases' learning rates
MERGE_GRID = 64
MERGE_LR = (1e-2, 1e-1)
# the kernel's workspace besides its gradient images: the grid twice
# (ping-pong), Adam's two moments of it
MERGE_WORK_FLOATS = 4 * MERGE_GRID * MERGE_GRID * 3


def lift_image_normals(live_tris: torch.Tensor, valid_tris: torch.Tensor,
                       normal_map: torch.Tensor, vert_mats16: torch.Tensor,
                       mv: torch.Tensor, proj: torch.Tensor,
                       fx: float, fy: float, cx: float, cy: float,
                       img_h: int, img_w: int, window: int = 4,
                       big_tris: int = 0, max_candidates: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image-space normals -> per-soup-vertex canonical normals.

    Args:
      live_tris: (T, 3, 3) live-space triangle soup; valid_tris: (T,).
      normal_map: (img_h, img_w, 3) image normals (camera convention).
      vert_mats16: (3T, 16) flat per-vertex cano->live skinning mats.
      mv: (4, 4) world -> camera; proj: (4, 4) perspective projection.
    Returns:
      ((T, 3, 3) canonical normals, 0 where invisible or invalid; () bool
      overflow of the position pass).
    """
    T = live_tris.shape[0]
    verts = live_tris.reshape(-1, 3)

    # live position pass
    mvp = proj @ mv
    vh = torch.cat([live_tris, torch.ones_like(live_tris[..., :1])], dim=-1)
    clip = torch.einsum("ij,tvj->tvi", mvp, vh)
    pos_pass = rasterize(clip, live_tris, valid_tris, img_h, img_w,
                         window=window, big_tri_capacity=big_tris,
                         max_candidates=max_candidates)

    # project the vertices; visible where the position buffer agrees.
    # Nearest sample (align_corners=True, border clamp) of both maps in one
    # 6-channel row gather.
    cam = torch.einsum("ij,nj->ni", mv[:3, :3], verts) + mv[:3, 3]
    gx = 2.0 * ((cam[:, 0] / cam[:, 2] * fx + cx) / img_w) - 1.0
    gy = 2.0 * ((cam[:, 1] / cam[:, 2] * fy + cy) / img_h) - 1.0
    xpix = torch.round((gx + 1.0) * 0.5 * (img_w - 1)).to(torch.int64)
    ypix = torch.round((gy + 1.0) * 0.5 * (img_h - 1)).to(torch.int64)
    xpix = xpix.clamp(0, img_w - 1)
    ypix = ypix.clamp(0, img_h - 1)
    both = torch.cat([pos_pass.attrs, normal_map], dim=-1).reshape(-1, 6)
    rows = both[ypix * img_w + xpix]                       # (3T, 6)
    proj_v, proj_n = rows[:, :3], rows[:, 3:]
    vis = (verts - proj_v).norm(dim=-1) < 0.05
    valid = vis & (proj_n.norm(dim=-1) > 1e-6)

    # canonicalize: flip y/z, undo the view rotation, then each vertex's
    # skinning rotation (closed-form inverse on the flat mats)
    proj_n = torch.stack([proj_n[:, 0], -proj_n[:, 1], -proj_n[:, 2]], -1)
    # inv_ex: inv would read its error flag back to the host
    inv_mv_r = torch.linalg.inv_ex(mv)[0][:3, :3]
    proj_n = torch.einsum("ij,nj->ni", inv_mv_r, proj_n)
    proj_n = mats16_inv_rotate(vert_mats16, proj_n)
    proj_n = torch.where(valid[:, None], proj_n, torch.zeros_like(proj_n))
    return proj_n.reshape(T, 3, 3), pos_pass.overflow


def canonicalize_normal_map(cano_tris: torch.Tensor, live_tris: torch.Tensor,
                            valid_tris: torch.Tensor,
                            normal_map: torch.Tensor,
                            vert_mats: torch.Tensor,
                            mv: torch.Tensor, proj: torch.Tensor,
                            front_mvp: torch.Tensor, front_mv: torch.Tensor,
                            back_mvp: torch.Tensor, back_mv: torch.Tensor,
                            fx: float, fy: float, cx: float, cy: float,
                            img_h: int, img_w: int, res: int = 512,
                            window: int = 4
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image normals lifted onto the canonical mesh and rendered front and
    back: lift_image_normals, then render/visualize.render_cano_mesh (the
    standalone form; the capture interpolates at its shared canonical
    index passes instead).

    Args:
      cano_tris, live_tris: (T, 3, 3) corresponding soups; valid_tris (T,).
      normal_map: (img_h, img_w, 3) image normals (camera convention).
      vert_mats: (T, 3, 4, 4) per-soup-vertex cano -> live mats.
      mv, proj: the capture camera's (4, 4); front_* / back_*: the
        canonical orthographic matrices (camera.cano_front_back_mvp).
    Returns (front (res, res, 3), back (res, res, 3)).
    """
    attr_tris, _ = lift_image_normals(
        live_tris, valid_tris, normal_map, vert_mats.reshape(-1, 16), mv,
        proj, fx, fy, cx, cy, img_h, img_w, window=window)
    return render_cano_mesh(cano_tris, attr_tris, valid_tris, front_mvp,
                            front_mv, back_mvp, back_mv, res=res,
                            window=window)


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bilinear interpolation matrix."""
    x = np.arange(n_out) * ((n_in - 1) / max(n_out - 1, 1))
    x0 = np.floor(x).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    t = (x - x0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), x0] += 1.0 - t
    m[np.arange(n_out), x1] += t
    return m


def _resize_bilinear_ac(img: torch.Tensor, wr: torch.Tensor,
                        wc: torch.Tensor) -> torch.Tensor:
    """align_corners=True bilinear resize of (H, W, C) to (h, w, C) by the
    separable interpolation matrices wr = _resize_matrix(H, h) and
    wc = _resize_matrix(W, w), on the image's device (a matmul's backward
    is a matmul)."""
    out = torch.einsum("Oh,hwc->Owc", wr, img)
    return torch.einsum("Pw,Owc->OPc", wc, out)


def _neighbor_shift(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """The reference's neighbour image: an affine grid shift of dj (2/H)
    in x and di (2/W) in y, nearest sampling, align_corners=True. The
    sampled grid resolves to static per-axis indices (on the 64-grid an
    edge-clamped one-pixel shift), taken here as slices."""
    H, W, _ = img.shape

    def axis_indices(n, d, scale):
        x = np.linspace(-1.0, 1.0, n) + d / (scale / 2.0)
        u = np.clip((x + 1.0) * 0.5 * (n - 1), 0.0, n - 1)
        return np.round(u).astype(np.int64)

    def shift_axis(a, dim, idxs):
        n = a.shape[dim]
        base = np.arange(n)
        if np.array_equal(idxs, base):
            return a
        if np.array_equal(idxs, np.minimum(base + 1, n - 1)):
            return torch.cat([a.narrow(dim, 1, n - 1),
                              a.narrow(dim, n - 1, 1)], dim=dim)
        if np.array_equal(idxs, np.maximum(base - 1, 0)):
            return torch.cat([a.narrow(dim, 0, 1),
                              a.narrow(dim, 0, n - 1)], dim=dim)
        return a.index_select(dim, device_constant(idxs, a.device))

    out = shift_axis(img, 0, axis_indices(H, di, W))
    return shift_axis(out, 1, axis_indices(W, dj, H))


def _merge_masks(src_img: torch.Tensor, tar_img: torch.Tensor):
    """The merge's masks: (the target's distance transform, valid (H, H,
    1), the valid pixels' count, n_valid = 3 x that count, at least 1)."""
    src_mask = src_img.norm(dim=-1) > 0.0
    tar_mask = erode_3x3(tar_img.norm(dim=-1) > 0.0, iterations=3)
    dt = distance_transform_l1(tar_mask.to(torch.float32))
    valid = (src_mask & tar_mask)[..., None]
    n_pixels = valid.sum()
    return dt, valid, n_pixels, torch.clamp(n_pixels * 3, min=1)


def _merge_blend(src: torch.Tensor, src_img: torch.Tensor, dt: torch.Tensor,
                 neck_xy: Sequence[int]) -> torch.Tensor:
    """The distance-transform blend of the optimised ``src`` with the
    avatar normals, then the avatar normals in the face box."""
    dtw = (dt / 5.0)[..., None]
    init_w = torch.where(dtw > 1.0, 0.0, 1.0)
    src = (src * dtw + src_img * init_w) / (dtw + init_w)

    # face box rows [neck_y - 90, neck_y), cols [neck_x - 35,
    # neck_x + 35): the reference's Python slice is empty when either
    # start is negative, and a stop past the edge clips
    x, y = int(neck_xy[0]), int(neck_xy[1])
    if y - 90 >= 0 and x - 35 >= 0:
        src[y - 90:y, x - 35:x + 35] = src_img[y - 90:y, x - 35:x + 35]
    return src


def merge_normal_images_plain(src_img: torch.Tensor, tar_img: torch.Tensor,
                              neck_xy: Sequence[int],
                              iter_num: int = 100) -> torch.Tensor:
    """merge_normal_images under ``torch.autograd``: the version CPU
    tensors run, and the card's kernel is held to.

    Runs its own autograd (also when called under ``inference_mode``).
    """
    with torch.inference_mode(False), torch.enable_grad():
        # clones outside inference mode, so autograd may save them
        src_img = src_img.detach().clone()
        tar_img = tar_img.detach().clone()
        H = src_img.shape[0]
        dt, valid, _, n_valid = _merge_masks(src_img, tar_img)
        # the 64 -> H resize matrix, built once (not in every step)
        wr = device_constant(_resize_matrix(MERGE_GRID, H), src_img.device)

        def loss_fn(rot_aa, src):
            rot_mat = axis_angle_to_matrix(_resize_bilinear_ac(rot_aa, wr, wr))
            rotated = torch.einsum("ijab,ijb->ija", rot_mat, src)
            sq = torch.square(rotated - tar_img)
            data = torch.where(valid, sq, torch.zeros_like(sq)).sum() / n_valid
            smooth = 0.0
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    if di or dj:
                        smooth = smooth + torch.mean(torch.square(
                            _neighbor_shift(rot_aa, di, dj) - rot_aa))
            return data + 1.0 * smooth

        rot_aa = torch.zeros((MERGE_GRID, MERGE_GRID, 3), dtype=src_img.dtype,
                             device=src_img.device)
        opt = Adam([rot_aa])
        for _ in range(iter_num // 2):
            rot_aa.requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(rot_aa, src_img), rot_aa)
            rot_aa, = opt.step([rot_aa.detach()], [g], MERGE_LR[0])

        src = src_img.detach()          # a new leaf: src_img keeps no grad
        opt = Adam([src])
        for _ in range(iter_num - iter_num // 2):
            src.requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(rot_aa, src), src)
            src, = opt.step([src.detach()], [g], MERGE_LR[1])
        return _merge_blend(src, src_img, dt, neck_xy)


def _bias_corrections(b: float, n: int) -> np.ndarray:
    """1 - b^t for t = 1..n, each as ops/adam.Adam._correction computes
    it (float32 powers)."""
    return np.array([np.float32(1) - np.float32(b) ** np.float32(t)
                     for t in range(1, n + 1)], np.float32)


@functools.lru_cache(maxsize=None)
def merge_tables(H: int, iter_num: int) -> Dict[str, np.ndarray]:
    """The host-side tables the merge kernel takes, from
    ``_resize_matrix(MERGE_GRID, H)`` (M, (H, 64)) and Adam's bias
    corrections:

    - ``taps_idx`` / ``taps_w`` (H, 2): each fine row's two grid rows and
      weights (M's nonzero entries; a row with one pads with its own index
      and weight 0): the upsample's taps, rows and columns alike;
    - ``adj_off`` (65,), ``adj_idx`` / ``adj_w`` (nnz,): M^T by grid row
      (CSR, fine rows ascending), the supports the adjoint gathers over;
    - ``corr1`` / ``corr2`` (ceil(iter_num / 2),): 1 - 0.9^t and
      1 - 0.999^t for the steps t of either phase.

    Cached per (H, iter_num): callers must not write to the arrays.
    """
    m = _resize_matrix(MERGE_GRID, H)
    taps_idx = np.zeros((H, 2), np.int32)
    taps_w = np.zeros((H, 2), np.float32)
    for o in range(H):
        cols = np.flatnonzero(m[o])
        taps_idx[o] = cols[0]
        taps_idx[o, :len(cols)] = cols
        taps_w[o, :len(cols)] = m[o, cols]
    mt = m.T
    nnz = np.count_nonzero(mt, axis=1)
    adj_idx = np.concatenate([np.flatnonzero(r) for r in mt]).astype(np.int32)
    n = iter_num - iter_num // 2
    return {"taps_idx": taps_idx, "taps_w": taps_w,
            "adj_off": np.concatenate([[0], np.cumsum(nnz)]).astype(np.int32),
            "adj_idx": adj_idx, "adj_w": mt[mt != 0].astype(np.float32),
            "corr1": _bias_corrections(0.9, n),
            "corr2": _bias_corrections(0.999, n)}


def _merge_launch(src_img: torch.Tensor, tar_img: torch.Tensor,
                  neck_xy: Sequence[int], iter_num: int) -> torch.Tensor:
    dev = src_img.device
    H = src_img.shape[0]
    if tuple(src_img.shape) != (H, H, 3) or tuple(tar_img.shape) != (H, H, 3):
        raise ValueError(f"src_img and tar_img must both be (H, H, 3), got "
                         f"{tuple(src_img.shape)} and {tuple(tar_img.shape)}")
    if H < 2 or 3 * H * H >= 2 ** 31:
        raise ValueError(f"image side {H} out of the kernel's range")
    if src_img.dtype != torch.float32 or tar_img.dtype != torch.float32:
        raise ValueError(f"float32 images expected, got {src_img.dtype} and "
                         f"{tar_img.dtype}")
    if tar_img.device != dev:
        raise ValueError(f"tar_img on {tar_img.device}, src_img on {dev}")
    if iter_num < 0:
        raise ValueError(f"iter_num must be >= 0, got {iter_num}")
    src_img = src_img.detach().contiguous()
    tar_img = tar_img.detach().contiguous()
    dt, valid, n_pixels, n_valid = _merge_masks(src_img, tar_img)
    tables = {k: device_constant(v, dev)
              for k, v in merge_tables(H, iter_num).items()}
    out = torch.empty_like(src_img)
    work = torch.empty(MERGE_WORK_FLOATS + 3 * H * H + 3 * MERGE_GRID * H,
                       dtype=torch.float32, device=dev)
    with live_rows(n_pixels), span("merge_kernel"):
        count("rows", H * H)
        kernels.launch(
            "merge", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 7 + [ctypes.c_float] * 2
            + [ctypes.c_void_p] * 2,
            (src_img.data_ptr(), tar_img.data_ptr(), valid.data_ptr(),
             n_valid.data_ptr(), H, iter_num // 2, iter_num - iter_num // 2,
             *(tables[k].data_ptr() for k in (
                 "taps_idx", "taps_w", "adj_off", "adj_idx", "adj_w",
                 "corr1", "corr2")),
             *MERGE_LR, work.data_ptr(), out.data_ptr()), dev)
    return _merge_blend(out, src_img, dt, neck_xy)


def merge_normal_images(src_img: torch.Tensor, tar_img: torch.Tensor,
                        neck_xy: Sequence[int],
                        iter_num: int = 100) -> torch.Tensor:
    """Optimization-based normal fusion.

    Phase 1 (iter_num // 2 steps): Adam(lr 1e-2) on a 64 x 64 axis-angle
    rotation grid that aligns the rotated avatar normals with the image
    normals, plus neighbour smoothness. Phase 2 (the rest): Adam(lr 1e-1)
    on the normal image itself. Then distance-transform blending, and the
    avatar normals kept in a face box below the neck.

    CUDA tensors run both phases in one launch of
    ``csrc/normal_merge.cu`` (closed-form gradients; counted in
    ``kernels.launches["merge"]``, and a span ``merge_kernel`` under a
    tracer, its ``rows`` the H x H pixels, ``live`` the valid ones); CPU
    tensors run merge_normal_images_plain. The masks, the distance
    transform and the blend are PyTorch on either.

    Args:
      src_img: (H, H, 3) avatar normals; tar_img: (H, H, 3) canonicalized
        image normals.
      neck_xy: (x, y) integer canonical-image neck position.
    Returns:
      (H, H, 3) merged normals.
    """
    if src_img.device.type == "cuda":
        return _merge_launch(src_img, tar_img, neck_xy, iter_num)
    if src_img.device.type == "cpu":
        return merge_normal_images_plain(src_img, tar_img, neck_xy, iter_num)
    raise ValueError(f"unsupported device {src_img.device}")


def merge_normal_images_cover(src_img: torch.Tensor,
                              tar_img: torch.Tensor) -> torch.Tensor:
    """Avatar normals overwritten wherever the image normal is valid."""
    valid = tar_img.norm(dim=-1) > 1e-6
    return torch.where(valid[..., None], tar_img, src_img)
