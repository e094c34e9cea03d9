"""Frozen copy of avatarcap_tpu_torch/ops/morphology.py at commit 2621afd, the f32 reference path of the benchmark.

Binary erosion and the L1 distance transform (counterpart of
avatarcap_tpu/ops/morphology.py), cv2.erode / cv2.distanceTransform
semantics on the device."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def erode_3x3(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary erosion with a 3x3 rect kernel. Out-of-image pixels count as
    set (cv2.erode's default border): the min filter is -max(-m), and the
    -inf pad of ``max_pool2d`` drops out of the max. mask: (H, W) bool or
    {0, 1}."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iterations):
        m = -F.max_pool2d(-m, 3, stride=1, padding=1)
    return m[0, 0] > 0.5


def _dt_1d(init: torch.Tensor, dim: int) -> torch.Tensor:
    """Exact 1-D L1 distance along ``dim``: min-plus against the |i - j|
    cost matrix. Materialises (..., n, n): 0.54 GB in f32 at 512^2."""
    n = init.shape[dim]
    i = torch.arange(n, device=init.device)
    cost = (i[:, None] - i[None, :]).abs().to(init.dtype)      # (n, n)
    moved = init.movedim(dim, -1)
    out = (moved[..., None, :] + cost).amin(-1)
    return out.movedim(-1, dim)


def distance_transform_l1(mask: torch.Tensor, big: float = 1e6
                          ) -> torch.Tensor:
    """L1 (cityblock) distance to the nearest zero pixel, exact: 0 on zero
    pixels (cv2.distanceTransform(mask, DIST_L1, 3)). mask: (H, W) {0, 1}."""
    init = torch.where(mask > 0, big, 0.0).to(torch.float32)
    return _dt_1d(_dt_1d(init, 1), 0)
