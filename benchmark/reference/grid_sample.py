"""Frozen copy of avatarcap_tpu_torch/ops/grid_sample.py at commit 2621afd, the f32 reference path of the benchmark.

Pixel-aligned and volume sampling with torch ``grid_sample`` semantics
(bilinear, border padding, ``align_corners=True``), the conventions the
JAX file avatarcap_tpu/ops/grid_sample.py was written to reproduce.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(input_nchw: torch.Tensor, grid: torch.Tensor
                   ) -> torch.Tensor:
    """(N, C, H, W) sampled at (N, Hg, Wg, 2) -> (N, C, Hg, Wg)."""
    return F.grid_sample(input_nchw, grid, mode="bilinear",
                         padding_mode="border", align_corners=True)


def grid_sample_3d(input_ncdhw: torch.Tensor, grid: torch.Tensor
                   ) -> torch.Tensor:
    """(N, C, D, H, W) sampled at (N, Dg, Hg, Wg, 3) -> (N, C, Dg, Hg, Wg);
    grid[..., 0] indexes W, 1 H and 2 D."""
    return F.grid_sample(input_ncdhw, grid, mode="bilinear",
                         padding_mode="border", align_corners=True)


def sample_feature_map_at_points(feat_map: torch.Tensor,
                                 pts_centered: torch.Tensor) -> torch.Tensor:
    """Pixel-aligned feature fetch of the warp field.

    The grid coordinate is the raw metric offset from the canonical body
    center (the map spans a 2 m x 2 m window) with y negated.

    Args:
      feat_map: (N, C, H, W).
      pts_centered: (N, P, 3) points minus the canonical body center.
    Returns:
      (N, P, C).
    """
    grid = torch.stack([pts_centered[..., 0], -pts_centered[..., 1]], -1)
    out = grid_sample_2d(feat_map, grid[:, :, None, :])     # (N, C, P, 1)
    return out[..., 0].permute(0, 2, 1)
