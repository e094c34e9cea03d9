"""Frozen copy of avatarcap_tpu_torch/body/skinning.py at commit 2621afd, the f32 reference path of the benchmark.

Forward linear blend skinning (counterpart of
avatarcap_tpu/body/skinning.py: ``blend_joint_mats``, ``skin_points``,
``skin_normals``, the flat ``mats16`` helpers and the volume-accelerated
KNN-Gaussian LBS).

Per-point matrices stay flat, (N, 16) row-major with channel 4 r + c =
mat[r, c], as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.device import device_constant
from benchmark.reference.knn import approx_lbs_weights


def blend_joint_mats16(lbs: torch.Tensor, jnt_mats: torch.Tensor
                       ) -> torch.Tensor:
    """(N, J) x (J, 4, 4) -> (N, 16) flat per-point affine mats."""
    J = jnt_mats.shape[-3]
    return lbs @ jnt_mats.reshape(J, 16)


def blend_joint_mats(lbs: torch.Tensor, jnt_mats: torch.Tensor
                     ) -> torch.Tensor:
    """(..., N, J) x (..., J, 4, 4) -> (..., N, 4, 4) per-point affine
    mats."""
    J = jnt_mats.shape[-3]
    m16 = lbs @ jnt_mats.reshape(jnt_mats.shape[:-3] + (J, 16))
    return m16.reshape(m16.shape[:-1] + (4, 4))


def skin_points(points: torch.Tensor, lbs: torch.Tensor,
                jnt_mats: torch.Tensor) -> torch.Tensor:
    """Forward-skin (N, 3) points with (N, J) blend weights and (J, 4, 4)
    joint transforms: the blended flat mats applied to each point."""
    return mats16_apply_points(blend_joint_mats16(lbs, jnt_mats), points)


def skin_normals(normals: torch.Tensor, lbs: torch.Tensor,
                 jnt_mats: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3) normals by the blended (..., N, J) x (..., J, 4,
    4) matrices' linear part, without renormalising."""
    pt_mats = blend_joint_mats(lbs, jnt_mats)
    return torch.einsum("...nxy,...ny->...nx", pt_mats[..., :3, :3],
                        normals)


def mats16_apply_points(m16: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack(
        [m16[..., 0] * x + m16[..., 1] * y + m16[..., 2] * z + m16[..., 3],
         m16[..., 4] * x + m16[..., 5] * y + m16[..., 6] * z + m16[..., 7],
         m16[..., 8] * x + m16[..., 9] * y + m16[..., 10] * z
         + m16[..., 11]], dim=-1)


def mats16_rotate(m16: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    return torch.stack(
        [m16[..., 0] * x + m16[..., 1] * y + m16[..., 2] * z,
         m16[..., 4] * x + m16[..., 5] * y + m16[..., 6] * z,
         m16[..., 8] * x + m16[..., 9] * y + m16[..., 10] * z], dim=-1)


def build_skin_weight_volume(cano_smpl_vertices: torch.Tensor,
                             skinning_weights: torch.Tensor,
                             bounds: torch.Tensor, voxel: float = 0.01,
                             k: int = 4, radius: float = 0.05
                             ) -> torch.Tensor:
    """Per-subject KNN-Gaussian LBS weights on a regular canonical grid
    over ``bounds``: (Gx, Gy, Gz, J), node-aligned (align_corners)."""
    lo = bounds[0].detach().cpu().numpy()
    hi = bounds[1].detach().cpu().numpy()
    res = np.maximum(np.ceil((hi - lo) / voxel).astype(np.int32) + 1, 2)
    dev = cano_smpl_vertices.device
    lin = [torch.linspace(0.0, 1.0, int(r), device=dev) for r in res]
    g = torch.stack(torch.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    pts = g * (bounds[1] - bounds[0]) + bounds[0]
    w = approx_lbs_weights(pts, cano_smpl_vertices, skinning_weights,
                           k=k, radius=radius)
    return w.reshape(tuple(int(r) for r in res) + (w.shape[-1],))


def _cell_table(vol: torch.Tensor) -> torch.Tensor:
    """(Gx, Gy, Gz, C) -> (cells, 8C): corner (dx, dy, dz) at channels
    [k C, (k + 1) C), k = 4 dx + 2 dy + dz."""
    Gx, Gy, Gz, C = vol.shape
    return torch.cat(
        [vol[dx:Gx - 1 + dx, dy:Gy - 1 + dy, dz:Gz - 1 + dz]
         for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
        dim=-1).reshape(-1, 8 * C)


def _corner_weights(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) cell offsets -> (..., 8, 1) trilinear corner weights."""
    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
    return torch.stack([(1 - tx) * (1 - ty) * (1 - tz),
                        (1 - tx) * (1 - ty) * tz,
                        (1 - tx) * ty * (1 - tz),
                        (1 - tx) * ty * tz,
                        tx * (1 - ty) * (1 - tz),
                        tx * (1 - ty) * tz,
                        tx * ty * (1 - tz),
                        tx * ty * tz], dim=-2)


def _trilerp_rows(vol: torch.Tensor, pts01: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of (Gx, Gy, Gz, C) at (N, 3) points in [0, 1]
    (border clamp, node-aligned): one 8C-wide cell row per point."""
    Gx, Gy, Gz, C = vol.shape
    cells = _cell_table(vol)
    hi = device_constant([Gx - 1, Gy - 1, Gz - 1], pts01.device, pts01.dtype)
    f = torch.minimum(torch.clamp(pts01 * hi, min=0.0), hi)
    i0 = torch.floor(f).long()
    i0 = torch.minimum(i0, device_constant([Gx - 2, Gy - 2, Gz - 2],
                                           pts01.device, torch.long))
    t = f - i0.to(f.dtype)
    cell = (i0[:, 0] * (Gy - 1) + i0[:, 1]) * (Gz - 1) + i0[:, 2]
    rows = cells[cell].reshape(-1, 8, C)
    return (rows * _corner_weights(t)).sum(1)


def _trilerp_rows_grouped(vol: torch.Tensor, pts01: torch.Tensor,
                          group: int) -> torch.Tensor:
    """Like _trilerp_rows with ONE cell row per group of ``group``
    consecutive points, anchored at the group centroid's cell (the shared
    cell's interpolant extrapolates linearly for a straddling vertex)."""
    Gx, Gy, Gz, C = vol.shape
    cells = _cell_table(vol)
    scale = device_constant([Gx - 1, Gy - 1, Gz - 1], pts01.device,
                            pts01.dtype)
    f = torch.minimum(torch.clamp(pts01 * scale, min=0.0), scale)
    fg = f.reshape(-1, group, 3)
    i0 = torch.floor(fg.mean(1)).long()
    i0 = torch.minimum(torch.clamp(i0, min=0),
                       device_constant([Gx - 2, Gy - 2, Gz - 2],
                                       pts01.device, torch.long))
    t = fg - i0[:, None, :].to(f.dtype)
    cell = (i0[:, 0] * (Gy - 1) + i0[:, 1]) * (Gz - 1) + i0[:, 2]
    rows = cells[cell].reshape(-1, 1, 8, C)
    return (rows * _corner_weights(t)).sum(2).reshape(-1, C)


def skin_points_by_volume(points: torch.Tensor, weight_volume: torch.Tensor,
                          bounds: torch.Tensor, jnt_mats: torch.Tensor,
                          return_pt_mats: bool = False, row_group: int = 1):
    """Forward-skin (N, 3) canonical points with the per-subject weight
    volume and (J, 4, 4) cano->live joint transforms. Trilinear sampling
    commutes with the blend, so matrices are blended on the grid and
    sampled at the points. ``row_group`` > 1 shares one cell row per group
    (N must be a multiple). Returns live points, and with
    ``return_pt_mats`` the flat (N, 16) per-point mats."""
    G = weight_volume.shape
    mat_field = (weight_volume.reshape(-1, G[-1])
                 @ jnt_mats.reshape(G[-1], 16)).reshape(G[:3] + (16,))
    pts01 = (points - bounds[0]) / (bounds[1] - bounds[0])
    if row_group > 1:
        m16 = _trilerp_rows_grouped(mat_field, pts01, row_group)
    else:
        m16 = _trilerp_rows(mat_field, pts01)
    out = mats16_apply_points(m16, points)
    if return_pt_mats:
        return out, m16
    return out


def mats16_inv_rotate(m16: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply the inverse of the 3x3 part of flat (..., 16) mats to
    (..., 3) vectors: closed-form adjugate over the determinant (clamped
    to 1 below 1e-20), exact for blended, non-orthogonal LBS matrices."""
    a, b, c = m16[..., 0], m16[..., 1], m16[..., 2]
    d, e, f = m16[..., 4], m16[..., 5], m16[..., 6]
    g, h, i = m16[..., 8], m16[..., 9], m16[..., 10]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, torch.ones_like(det), det)
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    ox = A * x - (b * i - c * h) * y + (b * f - c * e) * z
    oy = B * x + (a * i - c * g) * y - (a * f - c * d) * z
    oz = C * x - (a * h - b * g) * y + (a * e - b * d) * z
    return torch.stack([ox, oy, oz], dim=-1) * inv_det[..., None]
