"""Frozen copy of avatarcap_tpu_torch/ops/se3.py at commit 2621afd, the f32 reference path of the benchmark.

Rotation and transform math (counterpart of avatarcap_tpu/ops/se3.py:
``axis_angle_to_matrix``, ``rigid_inverse``, ``inverse_3x3``,
``affine_inverse``, ``transform_points`` and ``transform_dirs``)."""

from __future__ import annotations

import torch


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotations (Rodrigues, with
    small-angle Taylor terms below theta^2 = 1e-8)."""
    theta2 = (aa * aa).sum(-1, keepdim=True)
    small = theta2[..., 0] < 1e-8
    theta2_safe = torch.where(small[..., None], torch.ones_like(theta2),
                              theta2)
    theta = torch.sqrt(theta2_safe[..., 0])
    sin_over = torch.where(small, 1.0 - theta2[..., 0] / 6.0,
                           torch.sin(theta) / theta)
    one_minus_cos_over = torch.where(small, 0.5 - theta2[..., 0] / 24.0,
                                     (1.0 - torch.cos(theta))
                                     / theta2_safe[..., 0])
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([torch.stack([zeros, -z, y], -1),
                     torch.stack([z, zeros, -x], -1),
                     torch.stack([-y, x, zeros], -1)], -2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    KK = aa[..., :, None] * aa[..., None, :] - theta2[..., None] * eye
    return (eye + sin_over[..., None, None] * K
            + one_minus_cos_over[..., None, None] * KK)


def rigid_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transforms: inv([R t; 0 1]) =
    [R^T -R^T t; 0 1], without a general solve."""
    Rt = mats[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ mats[..., :3, 3:])], dim=-1)   # (..., 3, 4)
    # a fill, where a tensor made from a host list would copy it to the
    # card and wait (the train step calls this once per batch item)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices; a
    determinant below 1e-20 in magnitude divides by 1."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, torch.ones_like(det),
                                det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj * inv_det[..., None, None]


def affine_inverse(mats: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) affine transforms: inv([A t; 0 1]) =
    [A^-1 -A^-1 t; 0 1], exact for a non-orthogonal A (blended LBS
    matrices)."""
    a_inv = inverse_3x3(mats[..., :3, :3])
    t = torch.einsum("...ij,...j->...i", a_inv, mats[..., :3, 3])
    top = torch.cat([a_inv, -t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mats.dtype,
                          device=mats.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def transform_points(mats: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) affine mats applied to (..., 3) points (broadcast)."""
    return (torch.einsum("...ij,...j->...i", mats[..., :3, :3], pts)
            + mats[..., :3, 3])


def transform_dirs(mats: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The linear part of (..., 4, 4) affine mats applied to (..., 3)
    direction vectors."""
    return torch.einsum("...ij,...j->...i", mats[..., :3, :3], dirs)
