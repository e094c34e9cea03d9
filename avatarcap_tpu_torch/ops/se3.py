"""Rotation math (counterpart of avatarcap_tpu/ops/se3.py:
``axis_angle_to_matrix`` and ``rigid_inverse``)."""

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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mats.dtype,
                          device=mats.device).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)
