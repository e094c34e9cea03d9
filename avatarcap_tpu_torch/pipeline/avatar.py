"""GeoTexAvatar queries (counterpart of avatarcap_tpu/pipeline/avatar.py):
the pose features, the occupancy query (the f32 module path, and kernel
K1's), the grid pose features, inverse skinning, and the masked query and
volume rendering of posed, canonical and template-space points.

Plain functions over tensors; the pose feature map is an explicit
activation computed once per pose. Layouts follow the JAX package's public
functions (NHWC feature maps, (B, N, 3) point batches). Training runs the
same functions on a model in ``train()`` mode: its BatchNorms then use
batch statistics and update their running ones, in call order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from avatarcap_tpu_torch.body.skinning import skin_points
from avatarcap_tpu_torch.models.avatar import (TEMPLATE_FREQS, WARP_FREQS,
                                               GeoTexAvatar,
                                               sample_weight_volume)
from avatarcap_tpu_torch.models.layers import f32_convolutions
from avatarcap_tpu_torch.ops.fused_query import (pack_offset_weights,
                                                 pack_template_weights,
                                                 warp_template_query)
from avatarcap_tpu_torch.ops.grid_sample import sample_feature_map_at_points
from avatarcap_tpu_torch.ops.knn import knn, knn_gather
from avatarcap_tpu_torch.ops.se3 import rigid_inverse
from avatarcap_tpu_torch.ops.volume_render import (
    raw2outputs, stratified_z_vals, z_vals_to_dists)
from avatarcap_tpu_torch.utils.timers import NO_SPAN

# 8 cm body proximity gate of every near-body test (the reference's
# arch_avatar.py:191): the masked query, the anchored ray flags, the
# distance volume and the ray kernel's threshold
NEAR_SMPL_DIST = 0.08


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


def stage(timer, name: str):
    """``timer(name)``, a context manager around one stage, or the shared
    no-op (utils/timers.NO_SPAN)."""
    return timer(name) if timer is not None else NO_SPAN


def compute_pose_features(model: GeoTexAvatar, smpl_pos_map: torch.Tensor,
                          train: bool = False) -> torch.Tensor:
    """U-Net over the SMPL position map, once per pose: (B, H, W, 6) ->
    (B, H, W, 64) NHWC. Convolutions run in full f32 (no TF32).

    ``train`` runs the U-Net in training mode (batch statistics, running
    statistics updated, autograd kept); otherwise in eval mode, without
    autograd. The U-Net's mode is restored afterwards."""
    unet = model.warping_field.unet
    was_training = unet.training
    unet.train(train)
    try:
        with f32_convolutions(), torch.set_grad_enabled(
                train and torch.is_grad_enabled()):
            return model.pose_features(smpl_pos_map)
    finally:
        unet.train(was_training)


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
    """Operands of ops/fused_query.warp_template_query (eval only), with
    the template's ``if_type``. K1's input panels are PE(10)'s 63 rows and
    the 3 + 64 decoder columns, so other encodings raise a ValueError:
    such an avatar runs on the f32 module path."""
    if model.encodings != (TEMPLATE_FREQS, WARP_FREQS):
        raise ValueError(
            f"positional encodings {model.encodings}: the kernels take "
            f"({TEMPLATE_FREQS}, {WARP_FREQS}) only; run this avatar with "
            "use_fused_query=False")
    return {"template": pack_template_weights(model.cano_template),
            "offset": pack_offset_weights(model.warping_field),
            "if_type": model.if_type}


def fused_occupancy(packed: dict, occ: torch.Tensor) -> torch.Tensor:
    """K1's raw geometry head -> the template's occupancy value: the
    sigmoid for an ``occupancy`` packed set (applied after the kernel,
    which computes what the TPU kernel computes), the SDF as it is."""
    return torch.sigmoid(occ) if packed["if_type"] == "occupancy" else occ


def query_occupancy_fused(packed: dict, cano_pts: torch.Tensor,
                          pose_feat_map: torch.Tensor,
                          statics: AvatarStatics):
    """query_occupancy through kernel K1: per-point pose features (the
    bilinear fetch in f32; K1's wrapper rounds them to bf16, as the TPU
    kernel's does), then the warp + template in one launch. The occupancy
    head's sigmoid follows the kernel, so the result matches the f32
    module path for either ``if_type``.

    Args:
      packed: from pack_fused_query_weights; cano_pts: (B, N, 3);
        pose_feat_map: (B, H, W, C).
    Returns dict(cano_pts_ov (B, N, 1), nonrigid_offset (B, N, 3)).
    """
    B, N, _ = cano_pts.shape
    pts_c = cano_pts - statics.cano_smpl_center[None, None]
    pose_feat = sample_feature_map_at_points(
        pose_feat_map.permute(0, 3, 1, 2), pts_c)              # (B, N, C)
    out = warp_template_query(packed["offset"], packed["template"],
                              cano_pts.reshape(B * N, 3),
                              pose_feat.reshape(B * N, -1))
    return {"cano_pts_ov": fused_occupancy(packed, out["occ"]).reshape(
                B, N, 1),
            "nonrigid_offset": out["offset"].reshape(B, N, 3)}


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


def _near_flag(wpts: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) against (V, 3) -> (B, N) bool: within NEAR_SMPL_DIST of
    the nearest vertex."""
    return torch.stack([knn(q, verts, k=1)[0][:, 0]
                        < NEAR_SMPL_DIST * NEAR_SMPL_DIST for q in wpts])


def inverse_skin_points(wpts: torch.Tensor, frame: FrameInputs,
                        statics: AvatarStatics):
    """Posed -> canonical points by inverse LBS: the nearest live vertex's
    skinning weights give a first canonical point (no gradient), whose
    weights from the canonical weight volume then skin the posed point
    back. wpts (B, N, 3) -> (cano_pts (B, N, 3), near_flag (B, N) bool:
    within NEAR_SMPL_DIST of the nearest live vertex)."""
    lo, hi = statics.cano_bounds[0], statics.cano_bounds[1]
    canos, nears = [], []
    for q, live_v, cano2live in zip(wpts, frame.live_smpl_v,
                                    frame.cano2live_jnt_mats):
        d2, idx = knn(q, live_v, k=1)
        nears.append(d2[:, 0] < NEAR_SMPL_DIST * NEAR_SMPL_DIST)
        live2cano = rigid_inverse(cano2live)
        w0 = knn_gather(statics.smpl_skinning_weights, idx)[:, 0]  # (N, J)
        cano0 = ((skin_points(q, w0, live2cano) - lo) / (hi - lo)).detach()
        w1 = sample_weight_volume(statics.weight_volume, cano0[None])[0]
        canos.append(skin_points(q, w1, live2cano))
    return torch.stack(canos), torch.stack(nears)


def avatar_forward(model: GeoTexAvatar, wpts: torch.Tensor,
                   dists: torch.Tensor, pose_feat_map: torch.Tensor,
                   statics: AvatarStatics, pts_space: str = "cano",
                   frame: Optional[FrameInputs] = None, timer=None):
    """Masked implicit query (f32 module path; the JAX package's
    ``_forward_impl``/``avatar_forward``) of wpts (B, N, 3) with sample
    lengths dists (B, N). ``posed`` points are inverse-skinned to the
    canonical space through ``frame`` (inverse_skin_points, which also
    flags them near the live body) and then warped; ``cano`` points are
    warped by the pose-dependent offsets before the template, ``temp``
    points go to the template as they are; both are near-body flagged
    against the canonical body before the warp. Density is kept only
    inside the bounds (on the warped point) and near the body, then turned
    into alpha = 1 - exp(-density dist). ``timer``: ``timer(stage)`` -> a
    context manager around the stages ``inverse_skinning`` and
    ``ray_query``.

    Returns dict(raw (B, N, 4) rgb + alpha, occ (B, N, 1),
    nonrigid_offset (B, N, 3)).
    """
    if pts_space not in ("posed", "cano", "temp"):
        raise ValueError(f"unknown pts_space {pts_space!r}")
    B = wpts.shape[0]
    if pts_space == "posed":
        if frame is None:
            raise ValueError("pts_space='posed' needs the frame's inputs")
        with stage(timer, "inverse_skinning"):
            cano_pts, near_flag = inverse_skin_points(wpts, frame, statics)
    else:
        cano_pts = wpts
        near_flag = _near_flag(wpts, statics.cano_smpl_vertices)
    with stage(timer, "ray_query"):
        if pts_space in ("posed", "cano"):
            center = statics.cano_smpl_center[None].expand(B, 3)
            offsets = model.query_offsets(cano_pts, pose_feat_map, center)
            cano_pts = cano_pts + offsets
        else:
            offsets = torch.zeros_like(wpts)
        rgb, alpha, occ = model.query_template(cano_pts)
        inside = ((cano_pts > statics.cano_bounds[0])
                  & (cano_pts < statics.cano_bounds[1])).all(-1)
        alpha = torch.where((inside & near_flag)[..., None], alpha,
                            torch.zeros_like(alpha))
        alpha = 1.0 - torch.exp(-alpha * dists[..., None])
    return {"raw": torch.cat([rgb, alpha], dim=-1), "occ": occ,
            "nonrigid_offset": offsets}




def render_rays(model: GeoTexAvatar, ray_o: torch.Tensor,
                ray_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor,
                depth: torch.Tensor, pose_feat_map: torch.Tensor,
                statics: AvatarStatics, n_samples: int = 64,
                perturb: bool = False,
                generator: Optional[torch.Generator] = None,
                pts_space: str = "cano", near_dist: float = 0.05,
                far_dist: float = 0.05,
                frame: Optional[FrameInputs] = None,
                t_rand: Optional[torch.Tensor] = None):
    """Volume-render ray batches through the masked query.

    Args:
      ray_o, ray_d: (B, R, 3); near, far, depth: (B, R). Where depth >
        1e-6 the band is [depth - near_dist, depth + far_dist].
      generator, t_rand: the uniform draws of ``perturb``, or the
        generator to draw them from (ops/volume_render.stratified_z_vals).
      frame: the frame's inputs, for ``pts_space="posed"``.
    Returns dict(rgb_map (B, R, 3), acc_map, depth_map (B, R), raw
    (B, R*S, 4), occ (B, R*S, 1), nonrigid_offset (B, R*S, 3)).
    """
    B, R = ray_o.shape[:2]
    has_depth = depth > 1e-6
    near = torch.where(has_depth, depth - near_dist, near)
    far = torch.where(has_depth, depth + far_dist, far)
    z_vals = stratified_z_vals(near, far, n_samples, perturb, generator,
                               t_rand)
    wpts = ray_o[:, :, None] + ray_d[:, :, None] * z_vals[..., None]
    dists = z_vals_to_dists(z_vals)
    out = avatar_forward(model, wpts.reshape(B, R * n_samples, 3),
                         dists.reshape(B, R * n_samples), pose_feat_map,
                         statics, pts_space, frame)
    ro = raw2outputs(out["raw"].reshape(B * R, n_samples, 4),
                     z_vals.reshape(B * R, n_samples))
    return {"rgb_map": ro.rgb_map.reshape(B, R, 3),
            "acc_map": ro.acc_map.reshape(B, R),
            "depth_map": ro.depth_map.reshape(B, R),
            "raw": out["raw"], "occ": out["occ"],
            "nonrigid_offset": out["nonrigid_offset"]}
