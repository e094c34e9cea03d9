"""ReconNet: pixel-aligned implicit reconstruction (counterpart of
avatarcap_tpu/models/recon.py).

HGFilter over the concatenated front|back normal maps (6 channels) and a
residual decoder over [pixel-aligned feature, z]. The defaults are
AvatarCap's: one depth-4 stack without pooling (512^2 -> 256^2 x 32) and a
weight-normed decoder 33 -> 512 -> 256 -> 128 -> 1 (leaky 0.02, skips
[h, x] into layers 1 and 2, sigmoid). The keywords give other members of
the PIFu family; PIFu's shape network (Saito et al., ICCV 2019,
``scripts/test.sh``) is ``PIFU_SHAPE_NETWORK``: four depth-2 stacks pooled
to 128^2 x 256 and a decoder 257 -> 1024 -> 512 -> 256 -> 128 -> 1 (leaky
0.01, no weight norm) with the input concatenated again before every
layer after the first, the output layer too. Module names are the reference's
(``image_encoder.*``, ``image_decoder.fc_list.*``); public layouts are the
JAX package's (NHWC maps, (B, N, 3) points).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from avatarcap_tpu_torch.models.hourglass import HGFilter
from avatarcap_tpu_torch.models.layers import f32_convolutions
from avatarcap_tpu_torch.models.mlp import MLP
from avatarcap_tpu_torch.ops.grid_sample import sample_feature_map_at_points


# ReconNetwork's keywords for PIFu's shape network
PIFU_SHAPE_NETWORK = dict(feat_channels=256, depth=2, n_stack=4,
                          down_type="ave_pool", widths=(1024, 512, 256, 128),
                          res_layers=(1, 2, 3, 4), weight_norm=False,
                          leaky_slope=0.01)


class ReconNetwork(nn.Module):
    """``feat_channels``: the last stack's channels (the HGFilter's
    ``last_ch``); ``depth``, ``n_stack``, ``down_type``: the HGFilter's
    form; ``widths``, ``res_layers``, ``weight_norm``, ``leaky_slope``: the
    decoder's (models/mlp.MLP), whose input is feat_channels + 1 wide."""

    def __init__(self, feat_channels: int = 32, depth: int = 4,
                 n_stack: int = 1, down_type: str = "no_down",
                 widths: Sequence[int] = (512, 256, 128),
                 res_layers: Sequence[int] = (1, 2),
                 weight_norm: bool = True, leaky_slope: float = 0.02):
        super().__init__()
        self.image_encoder = HGFilter(depth=depth, in_ch=6,
                                      last_ch=feat_channels,
                                      down_type=down_type, n_stack=n_stack)
        self.image_decoder = MLP(feat_channels + 1, 1, tuple(widths),
                                 res_layers=tuple(res_layers),
                                 nlactv="leaky_relu", last_op="sigmoid",
                                 weight_norm=weight_norm,
                                 leaky_slope=leaky_slope)

    def get_feat_maps(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 6) NHWC -> last stack's (B, Hf, Wf, C) NHWC (H/2, or
        H/4 with ``ave_pool``). Convolutions run in full f32 (no TF32)."""
        with f32_convolutions():
            feats, _ = self.image_encoder(
                image.permute(0, 3, 1, 2).contiguous())
        return feats[-1].permute(0, 2, 3, 1).contiguous()

    def decode_points(self, feat_map: torch.Tensor, cano_pts: torch.Tensor,
                      cano_smpl_center: torch.Tensor) -> torch.Tensor:
        """Per-point pixel-aligned decode.

        Args:
          feat_map: (B, Hf, Wf, C) NHWC; cano_pts: (B, N, 3);
          cano_smpl_center: (B, 3).
        Returns:
          (B, N) occupancy in [0, 1].
        """
        pts_c = cano_pts - cano_smpl_center[:, None, :]
        pix_feat = sample_feature_map_at_points(
            feat_map.permute(0, 3, 1, 2), pts_c)                  # (B, N, C)
        h = torch.cat([pix_feat, pts_c[..., 2:3]], dim=-1)
        return self.image_decoder(h)[..., 0]

    def forward(self, image, cano_pts, cano_smpl_center):
        return self.decode_points(self.get_feat_maps(image), cano_pts,
                                  cano_smpl_center)
