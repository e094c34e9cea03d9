"""Frozen copy of avatarcap_tpu_torch/fusion/normal_fusion.py at commit 2621afd, the f32 reference path of the benchmark.

Canonical normal fusion, the merge alone (``merge_normal_images`` and
``merge_normal_images_cover``; the copy leaves out the lift).

- The merge is the reference's two-phase optimisation: 50 Adam steps
  (lr 1e-2) on a 64 x 64 axis-angle rotation grid, then 50 (lr 1e-1) on
  the normal image, under ``torch.autograd``. The Adam step
  (ops/adam.py) is optax's order of operations, so the 100-step
  trajectory stays close to the JAX package's. Then the
  distance-transform blend and the face box.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.device import device_constant
from benchmark.reference.adam import Adam
from benchmark.reference.morphology import distance_transform_l1, erode_3x3
from benchmark.reference.se3 import axis_angle_to_matrix


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


def merge_normal_images(src_img: torch.Tensor, tar_img: torch.Tensor,
                        neck_xy: Sequence[int],
                        iter_num: int = 100) -> torch.Tensor:
    """Optimization-based normal fusion.

    Phase 1 (iter_num // 2 steps): Adam(lr 1e-2) on a 64 x 64 axis-angle
    rotation grid that aligns the rotated avatar normals with the image
    normals, plus neighbour smoothness. Phase 2 (the rest): Adam(lr 1e-1)
    on the normal image itself. Then distance-transform blending, and the
    avatar normals kept in a face box below the neck.

    Runs its own autograd (also when called under ``inference_mode``).

    Args:
      src_img: (H, H, 3) avatar normals; tar_img: (H, H, 3) canonicalized
        image normals.
      neck_xy: (x, y) integer canonical-image neck position.
    Returns:
      (H, H, 3) merged normals.
    """
    with torch.inference_mode(False), torch.enable_grad():
        # clones outside inference mode, so autograd may save them
        src_img = src_img.detach().clone()
        tar_img = tar_img.detach().clone()
        H = src_img.shape[0]
        src_mask = src_img.norm(dim=-1) > 0.0
        tar_mask = erode_3x3(tar_img.norm(dim=-1) > 0.0, iterations=3)
        dt = distance_transform_l1(tar_mask.to(torch.float32))
        valid = (src_mask & tar_mask)[..., None]
        n_valid = torch.clamp(valid.sum() * 3, min=1)
        # the 64 -> H resize matrix, built once (not in every step)
        wr = device_constant(_resize_matrix(64, H), src_img.device)

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

        rot_aa = torch.zeros((64, 64, 3), dtype=src_img.dtype,
                             device=src_img.device)
        opt = Adam([rot_aa])
        for _ in range(iter_num // 2):
            rot_aa.requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(rot_aa, src_img), rot_aa)
            rot_aa, = opt.step([rot_aa.detach()], [g], 1e-2)

        src = src_img.detach()          # a new leaf: src_img keeps no grad
        opt = Adam([src])
        for _ in range(iter_num - iter_num // 2):
            src.requires_grad_(True)
            g, = torch.autograd.grad(loss_fn(rot_aa, src), src)
            src, = opt.step([src.detach()], [g], 1e-1)

        # distance-transform blending
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


def merge_normal_images_cover(src_img: torch.Tensor,
                              tar_img: torch.Tensor) -> torch.Tensor:
    """Avatar normals overwritten wherever the image normal is valid."""
    valid = tar_img.norm(dim=-1) > 1e-6
    return torch.where(valid[..., None], tar_img, src_img)
