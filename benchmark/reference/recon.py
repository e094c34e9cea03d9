"""Frozen copy of avatarcap_tpu_torch/models/recon.py at commit 2621afd, the f32 reference path of the benchmark.

ReconNet: pixel-aligned implicit reconstruction (counterpart of
avatarcap_tpu/models/recon.py).

HGFilter over the concatenated front|back normal maps (6 channels, 512^2
-> 256^2 x 32) and a weight-normed residual decoder
33 -> 512 -> 256 -> 128 -> 1 (leaky 0.02, skips [h, x] into layers 1 and
2, sigmoid) over [pixel-aligned feature, z]. Module names are the
reference's (``image_encoder.*``, ``image_decoder.fc_list.*``); public
layouts are the JAX package's (NHWC maps, (B, N, 3) points).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.reference.hourglass import HGFilter
from benchmark.reference.layers import f32_convolutions
from benchmark.reference.mlp import MLP
from benchmark.reference.grid_sample import sample_feature_map_at_points


class ReconNetwork(nn.Module):
    def __init__(self, feat_channels: int = 32):
        super().__init__()
        self.image_encoder = HGFilter(depth=4, in_ch=6,
                                      last_ch=feat_channels)
        self.image_decoder = MLP(feat_channels + 1, 1, (512, 256, 128),
                                 res_layers=(1, 2), nlactv="leaky_relu",
                                 last_op="sigmoid", weight_norm=True)

    def get_feat_maps(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 6) NHWC -> last stack's (B, H/2, W/2, C) NHWC.
        Convolutions run in full f32 (no TF32)."""
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
