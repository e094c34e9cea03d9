"""Frozen copy of avatarcap_tpu_torch/models/avatar.py at commit 2621afd, the f32 reference path of the benchmark.

GeoTexAvatar: canonical implicit template + pose-conditioned warp field
(counterpart of avatarcap_tpu/models/avatar.py).

Module names are the reference torch names (``cano_template.shared_mlp``,
``warping_field.unet``, ``warping_field.out_layer_coord_affine``, ...), so a
reference checkpoint loads with ``load_state_dict`` (see weights.py).
Capture runs it in ``eval()`` (the warp field's BatchNorms use their
running statistics); training runs it in ``train()``.

The defaults are the reference's capture configuration: template PE(10)
in SDF mode, no PE on the warp field's point input (kernel K1 bakes in
these widths; other encodings run on the f32 module path only). Other
encodings widen the template's input to ``embed_dim(pos_encoding)`` and
the OffsetDecoder's to ``embed_dim(pos_encoding) + 64``;
``if_type="occupancy"`` puts a sigmoid on the geometry head's first
channel. The JAX GeoHead is the torch reference's ``geo_mlp = MLP(256, 2,
(128,), leaky)`` and OutOffsetHead its ``out_layer_coord_affine`` Conv1d;
both keep the reference's U(+-1e-5) output init.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.layers import PointConv1d
from benchmark.reference.mlp import MLP, OffsetDecoder
from benchmark.reference.unets import UnetNoCond7DS
from benchmark.reference.embed import embed_dim, positional_encoding
from benchmark.reference.grid_sample import (grid_sample_3d,
                                                 sample_feature_map_at_points)

TEMPLATE_FREQS = 10
WARP_FREQS = 0
POSE_FEAT_DIM = 64
IF_TYPES = ("sdf", "occupancy")


def tiny_uniform_(t: torch.Tensor) -> torch.Tensor:
    """U(-1e-5, 1e-5) output-layer init of the reference."""
    with torch.no_grad():
        return t.uniform_(-1e-5, 1e-5)


class DoubleTNet(nn.Module):
    """PE(pos_encoding) -> shared MLP [256 x 6, res@4] -> 256; geo head ->
    (sdf or occupancy, density); color head -> rgb."""

    def __init__(self, pos_encoding: int = TEMPLATE_FREQS,
                 if_type: str = "sdf"):
        super().__init__()
        if if_type not in IF_TYPES:
            raise ValueError(f"if_type={if_type!r}: one of {IF_TYPES}")
        self.pos_encoding = pos_encoding
        self.if_type = if_type
        self.shared_mlp = MLP(embed_dim(pos_encoding), 256, (256,) * 6,
                              res_layers=(4,))
        self.geo_mlp = MLP(256, 2, (128,), nlactv="leaky_relu")
        self.clr_mlp = MLP(256, 3, (256, 128))
        tiny_uniform_(self.geo_mlp.fc_list[1].weight)
        nn.init.zeros_(self.geo_mlp.fc_list[1].bias)

    def forward(self, pts: torch.Tensor):
        """pts (..., N, 3) -> rgb (..., N, 3), alpha (..., N, 1),
        occ (..., N, 1): the SDF, or the occupancy sigmoid(geo)."""
        feat = self.shared_mlp(positional_encoding(pts, self.pos_encoding))
        geo = self.geo_mlp(feat)
        rgb = torch.sigmoid(self.clr_mlp(feat))
        occ = geo[..., :1]
        if self.if_type == "occupancy":
            occ = torch.sigmoid(occ)
        return rgb, torch.relu(geo[..., 1:2]), occ


class WarpingField(nn.Module):
    """Pose-dependent non-rigid warp: U-Net pose features once per pose,
    then per point a bilinear feature fetch + OffsetDecoder on
    [PE(pos_encoding) of the point, features] + 3-d head."""

    def __init__(self, pos_encoding: int = WARP_FREQS):
        super().__init__()
        self.pos_encoding = pos_encoding
        self.unet = UnetNoCond7DS(6, POSE_FEAT_DIM, nf=32)
        self.mlp = OffsetDecoder(embed_dim(pos_encoding) + POSE_FEAT_DIM)
        self.out_layer_coord_affine = PointConv1d(256, 3)
        tiny_uniform_(self.out_layer_coord_affine.weight)
        nn.init.zeros_(self.out_layer_coord_affine.bias)

    def pose_features(self, smpl_pos_map: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 6) NHWC -> (B, H, W, 64) NHWC."""
        x = smpl_pos_map.permute(0, 3, 1, 2).contiguous()
        return self.unet(x).permute(0, 2, 3, 1).contiguous()

    def forward(self, pts: torch.Tensor, pose_feat_map: torch.Tensor,
                cano_smpl_center: torch.Tensor) -> torch.Tensor:
        """pts (B, N, 3), pose_feat_map (B, H, W, C) NHWC,
        cano_smpl_center (B, 3) -> offsets (B, N, 3). The fetch's grid
        coordinates carry no gradient, as in the reference."""
        pts_c = (pts - cano_smpl_center[:, None, :]).detach()
        pose_feat = sample_feature_map_at_points(
            pose_feat_map.permute(0, 3, 1, 2), pts_c)
        h = self.mlp(torch.cat([positional_encoding(pts, self.pos_encoding),
                                pose_feat], dim=-1))
        return self.out_layer_coord_affine(h)


def sample_weight_volume(weight_volume: torch.Tensor,
                         pts01: torch.Tensor) -> torch.Tensor:
    """Trilinear LBS weight fetch: (X, Y, Z, J) canonical blend-weight
    volume at (B, N, 3) points normalised to [0, 1] in the canonical
    bounds -> (B, N, J). The grid's (x, y, z) index the volume's (W, H, D)
    = (Z, Y, X), so the points go in as [z, y, x]: world x indexes the
    volume's X axis."""
    B, N, _ = pts01.shape
    vol = weight_volume.permute(3, 0, 1, 2)[None]          # (1, J, X, Y, Z)
    # [z, y, x] by a flip: an index list would be copied to the card
    # and waited for
    grid = (2.0 * pts01 - 1.0).flip(-1).reshape(1, 1, 1, B * N, 3)
    w = grid_sample_3d(vol, grid)                          # (1, J, 1, 1, BN)
    return w[0, :, 0, 0].reshape(-1, B, N).permute(1, 2, 0)


class GeoTexAvatar(nn.Module):
    """Template + warp field (the reference's ``network`` module)."""

    def __init__(self, if_type: str = "sdf",
                 pos_encoding_template: int = TEMPLATE_FREQS,
                 pos_encoding_warp: int = WARP_FREQS):
        super().__init__()
        self.if_type = if_type
        self.cano_template = DoubleTNet(pos_encoding_template, if_type)
        self.warping_field = WarpingField(pos_encoding_warp)

    @property
    def encodings(self):
        """(template, warp) positional-encoding frequencies."""
        return (self.cano_template.pos_encoding,
                self.warping_field.pos_encoding)

    def pose_features(self, smpl_pos_map):
        return self.warping_field.pose_features(smpl_pos_map)

    def query_offsets(self, pts, pose_feat_map, cano_smpl_center):
        return self.warping_field(pts, pose_feat_map, cano_smpl_center)

    def query_template(self, pts):
        return self.cano_template(pts)
