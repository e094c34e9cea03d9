"""3D Sobel gradient normals of a scalar volume (counterpart of
avatarcap_tpu/ops/sobel.py).

The reference's normal extraction (utils/recon_util.py:9-48): a 3x3x3
Sobel bank scaled by 1 / (16 * 2 * voxel), trilinearly sampled at mesh
vertices and normalised; the gradient points inward for an
inside-positive field, so the sampled normals are negated here. The bank
is separable ([1, 2, 1] x [1, 2, 1] x [-1, 0, 1]) and is applied as shifted
adds with a zero boundary, in the JAX module's order of operations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from avatarcap_tpu_torch.ops.grid_sample import grid_sample_3d


def _shifted(v: torch.Tensor, axis: int):
    """(previous, current, next) neighbours along ``axis`` of a 3D volume,
    zero past its ends (a conv's pad of 1)."""
    pad = [0] * 6
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1   # F.pad: last dim first
    p = F.pad(v, pad)
    n = v.shape[axis]
    return p.narrow(axis, 0, n), p.narrow(axis, 1, n), p.narrow(axis, 2, n)


def _smooth(v: torch.Tensor, axis: int) -> torch.Tensor:
    """[1, 2, 1] along ``axis``."""
    lo, mid, hi = _shifted(v, axis)
    return lo + 2.0 * mid + hi


def _diff(v: torch.Tensor, axis: int) -> torch.Tensor:
    """[-1, 0, +1] along ``axis``: next minus previous (the sign of the
    reference bank, whose first plane carries the negative weights)."""
    lo, _, hi = _shifted(v, axis)
    return hi - lo


def extract_normal_volume(volume: torch.Tensor,
                          voxel_size: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) scalar volume -> (X, Y, Z, 3) Sobel gradient volume, each
    axis scaled by 1 / (32 voxel_size[axis])."""
    scale = 1.0 / (16.0 * 2.0 * voxel_size)
    sz = _smooth(volume, 2)
    sy = _smooth(volume, 1)
    gx = _diff(_smooth(sz, 1), 0) * scale[0]
    gy = _diff(_smooth(sz, 0), 1) * scale[1]
    gz = _diff(_smooth(sy, 0), 2) * scale[2]
    return torch.stack([gx, gy, gz], dim=-1)


def sample_volume_normals(volume: torch.Tensor, voxel_size: torch.Tensor,
                          pts_grid: torch.Tensor,
                          eps: float = 1e-12) -> torch.Tensor:
    """Outward unit normals at points: the Sobel gradient volume sampled
    trilinearly (grid_sample, border padding, aligned corners), negated and
    normalised.

    Args:
      volume: (X, Y, Z); voxel_size: (3,).
      pts_grid: (N, 3) normalised volume coordinates in [-1, 1], (x, y, z)
        order (ops/marching_cubes.mesh_grid_coords).
    Returns (N, 3).
    """
    nvol = extract_normal_volume(volume, voxel_size)        # (X, Y, Z, 3)
    vol = nvol.permute(3, 0, 1, 2)[None]                     # (1, 3, X, Y, Z)
    grid = pts_grid.flip(-1)[None, None, None]               # (1, 1, 1, N, 3)
    n = grid_sample_3d(vol, grid)[0, :, 0, 0].T              # (N, 3)
    return -n / n.norm(dim=-1, keepdim=True).clamp_min(eps)
