"""GeoTexAvatar: canonical implicit template + pose-conditioned warp field
(counterpart of avatarcap_tpu/models/avatar.py).

Module names are the reference torch names (``cano_template.shared_mlp``,
``warping_field.unet``, ``warping_field.out_layer_coord_affine``, ...), so a
reference checkpoint loads with ``load_state_dict`` (see weights.py).
Capture runs it in ``eval()`` (the warp field's BatchNorms use their
running statistics); training runs it in ``train()``.

The configuration is the reference's capture one, fixed: template PE(10)
in SDF mode, no PE on the warp field's point input (kernel K1 bakes in the
same widths). The occupancy form (``if_type="occupancy"``, a sigmoid on
the geometry head) is not ported: GeoTexAvatar raises for it. The JAX
GeoHead is the torch reference's ``geo_mlp = MLP(256, 2, (128,), leaky)``
and OutOffsetHead its
``out_layer_coord_affine`` Conv1d; both keep the reference's U(+-1e-5)
output init.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from avatarcap_tpu_torch.models.layers import PointConv1d
from avatarcap_tpu_torch.models.mlp import MLP, OffsetDecoder
from avatarcap_tpu_torch.models.unets import UnetNoCond7DS
from avatarcap_tpu_torch.ops.embed import embed_dim, positional_encoding
from avatarcap_tpu_torch.ops.grid_sample import (grid_sample_3d,
                                                 sample_feature_map_at_points)

TEMPLATE_FREQS = 10
POSE_FEAT_DIM = 64


def tiny_uniform_(t: torch.Tensor) -> torch.Tensor:
    """U(-1e-5, 1e-5) output-layer init of the reference."""
    with torch.no_grad():
        return t.uniform_(-1e-5, 1e-5)


class DoubleTNet(nn.Module):
    """PE(10) -> shared MLP 63 -> [256 x 6, res@4] -> 256; geo head ->
    (sdf, density); color head -> rgb."""

    def __init__(self):
        super().__init__()
        self.shared_mlp = MLP(embed_dim(TEMPLATE_FREQS), 256, (256,) * 6,
                              res_layers=(4,))
        self.geo_mlp = MLP(256, 2, (128,), nlactv="leaky_relu")
        self.clr_mlp = MLP(256, 3, (256, 128))
        tiny_uniform_(self.geo_mlp.fc_list[1].weight)
        nn.init.zeros_(self.geo_mlp.fc_list[1].bias)

    def forward(self, pts: torch.Tensor):
        """pts (..., N, 3) -> rgb (..., N, 3), alpha (..., N, 1),
        occ (..., N, 1)."""
        feat = self.shared_mlp(positional_encoding(pts, TEMPLATE_FREQS))
        geo = self.geo_mlp(feat)
        rgb = torch.sigmoid(self.clr_mlp(feat))
        return rgb, torch.relu(geo[..., 1:2]), geo[..., :1]


class WarpingField(nn.Module):
    """Pose-dependent non-rigid warp: U-Net pose features once per pose,
    then per point a bilinear feature fetch + OffsetDecoder + 3-d head."""

    def __init__(self):
        super().__init__()
        self.unet = UnetNoCond7DS(6, POSE_FEAT_DIM, nf=32)
        self.mlp = OffsetDecoder(3 + POSE_FEAT_DIM)
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
        h = self.mlp(torch.cat([pts, pose_feat], dim=-1))
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
    grid = (2.0 * pts01 - 1.0)[..., [2, 1, 0]].reshape(1, 1, 1, B * N, 3)
    w = grid_sample_3d(vol, grid)                          # (1, J, 1, 1, BN)
    return w[0, :, 0, 0].reshape(-1, B, N).permute(1, 2, 0)


class GeoTexAvatar(nn.Module):
    """Template + warp field (the reference's ``network`` module)."""

    def __init__(self, if_type: str = "sdf"):
        if if_type != "sdf":
            raise NotImplementedError(
                f"if_type={if_type!r}: the port's GeoTexAvatar has the SDF "
                "geometry head only")
        super().__init__()
        self.cano_template = DoubleTNet()
        self.warping_field = WarpingField()

    def pose_features(self, smpl_pos_map):
        return self.warping_field.pose_features(smpl_pos_map)

    def query_offsets(self, pts, pose_feat_map, cano_smpl_center):
        return self.warping_field(pts, pose_feat_map, cano_smpl_center)

    def query_template(self, pts):
        return self.cano_template(pts)
