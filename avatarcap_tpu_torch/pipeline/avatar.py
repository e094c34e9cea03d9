"""GeoTexAvatar evaluation for capture (counterpart of
avatarcap_tpu/pipeline/avatar.py:37-301, the inference half).

Plain functions over tensors; the pose feature map is an explicit
activation computed once per pose. Layouts follow the JAX package's public
functions (NHWC feature maps, (B, N, 3) point batches).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.layers import f32_convolutions
from avatarcap_tpu_torch.ops.fused_query import (pack_offset_weights,
                                                 pack_template_weights)
from avatarcap_tpu_torch.ops.grid_sample import sample_feature_map_at_points


class AvatarStatics(NamedTuple):
    """Per-subject constants, computed once at load time."""

    weight_volume: torch.Tensor        # (X, Y, Z, J) canonical LBS weights
    cano_smpl_vertices: torch.Tensor   # (V, 3)
    smpl_skinning_weights: torch.Tensor  # (V, J)
    cano_bounds: torch.Tensor          # (2, 3)
    cano_smpl_center: torch.Tensor     # (3,)

    def to(self, device) -> "AvatarStatics":
        return AvatarStatics(*(torch.as_tensor(t).to(device) for t in self))


class FrameInputs(NamedTuple):
    """Per-frame pose-dependent inputs (batched, leading dim B)."""

    live_smpl_v: torch.Tensor          # (B, V, 3)
    cano2live_jnt_mats: torch.Tensor   # (B, J, 4, 4)
    smpl_pos_map: torch.Tensor         # (B, H, W, 6) NHWC


def compute_pose_features(model: GeoTexAvatar, smpl_pos_map: torch.Tensor
                          ) -> torch.Tensor:
    """U-Net over the SMPL position map, once per pose: (B, H, W, 6) ->
    (B, H, W, 64) NHWC. Convolutions run in full f32 (no TF32)."""
    with f32_convolutions():
        return model.pose_features(smpl_pos_map)


def query_occupancy(model: GeoTexAvatar, cano_pts: torch.Tensor,
                    pose_feat_map: torch.Tensor, statics: AvatarStatics):
    """Canonical occupancy/SDF query (f32 module path): warp offsets, then
    the template's geometry head, no masking.

    Args:
      cano_pts: (B, N, 3); pose_feat_map: (B, H, W, C).
    Returns dict(cano_pts_ov (B, N, 1), nonrigid_offset (B, N, 3)).
    """
    B = cano_pts.shape[0]
    center = statics.cano_smpl_center[None].expand(B, 3)
    offsets = model.query_offsets(cano_pts, pose_feat_map, center)
    _, _, occ = model.query_template(cano_pts + offsets)
    return {"cano_pts_ov": occ, "nonrigid_offset": offsets}


def pack_fused_query_weights(model: GeoTexAvatar):
    """Operands of ops/fused_query.warp_template_query (eval only)."""
    return {"template": pack_template_weights(model.cano_template),
            "offset": pack_offset_weights(model.warping_field)}


def grid_pose_features(pose_feat_map: torch.Tensor, statics: AvatarStatics,
                       grid_shape, flat_idx: Optional[torch.Tensor] = None,
                       dtype: Optional[torch.dtype] = None,
                       columns: bool = False) -> torch.Tensor:
    """Pose features for regular-grid query points. The pixel-aligned
    fetch depends only on (x, y), so each grid column (X*Y of them) is
    sampled once and broadcast along z.

    Args:
      pose_feat_map: (1, H, W, C).
      grid_shape: (X, Y, Z) of the canonical grid over cano_bounds.
      flat_idx: optional (N,) flat indices into the x-major grid; None
        means the full grid in order.
      dtype: cast the column table (before any broadcast).
      columns: return the (X*Y, C) column table itself.
    Returns:
      (N, C) pose features (N = X*Y*Z when flat_idx is None).
    """
    X, Y, Z = grid_shape
    lo, hi = statics.cano_bounds[0], statics.cano_bounds[1]
    dev = pose_feat_map.device
    xs = torch.linspace(0.0, 1.0, X, device=dev) * (hi[0] - lo[0]) + lo[0]
    ys = torch.linspace(0.0, 1.0, Y, device=dev) * (hi[1] - lo[1]) + lo[1]
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    cols = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.zeros(X * Y, device=dev)], dim=-1)
    pts_c = cols - statics.cano_smpl_center[None]
    pf_cols = sample_feature_map_at_points(
        pose_feat_map.permute(0, 3, 1, 2), pts_c[None])[0]    # (X*Y, C)
    if dtype is not None:
        pf_cols = pf_cols.to(dtype)
    if columns:
        return pf_cols
    if flat_idx is None:
        return pf_cols.repeat_interleave(Z, dim=0)
    # padded (out-of-grid) indices clamp to the last column, as the JAX
    # gather does
    return pf_cols[(flat_idx.long() // Z).clamp(0, X * Y - 1)]
