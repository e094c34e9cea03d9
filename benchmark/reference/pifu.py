"""PIFu's shape network as a ReconNet, the f32 reference of the benchmark's
pifu_sdf configuration.

Written from PIFu (Saito et al., ICCV 2019, github.com/shunsukesaito/PIFu)
as ``scripts/test.sh`` runs it (``--mlp_dim 257 1024 512 256 128 1
--num_stack 4 --num_hourglass 2 --hg_down ave_pool --norm group``):

- ``lib/model/HGFilters.py``: a 7 x 7 / 2 stem, ConvBlocks and a 2 x 2
  average pool, four stacked hourglasses of depth 2 at 256 channels
  (GroupNorm(32), bicubic x 2 upsampling); the last stack's 128^2 x 256 map
  is the one the decoder samples (benchmark/reference/hourglass.py's
  HGFilter, which follows the same file);
- ``lib/model/SurfaceClassifier.py``: plain kernel-size-1 Conv1d layers, no
  weight norm; before every layer after the first the 257-d input is
  concatenated again ([h, x], ``no_residual`` False, the 128 -> 1 head
  included); ``F.leaky_relu`` at its default slope 0.01 after every layer
  but the last, then a sigmoid;
- ``lib/model/HGPIFuNet.py``: the point's feature is the bilinear sample of
  the last map at its projection, followed by z.

Where this differs from PIFu:

- the input is 6 channels, the fused front and the back normal images
  (AvatarCap's ReconNet input), not an RGB image;
- z is the canonical offset ``z - center_z``, not PIFu's depth normalizer;
- the decoder's weights are fitted to the benchmark's body
  (benchmark/subject.py), not PIFu's released checkpoint;
- it is queried on AvatarCap's 384 x 384 x 128 coarse-to-fine grid, not on
  PIFu's evaluation grid.

Module and key names are the program's ReconNetwork's (``image_encoder.*``,
``image_decoder.fc_list.{i}.0`` hidden layers, ``image_decoder.fc_list.4``
the head), so one state dict loads into both; the constructor takes the
program's keywords and refuses any that do not describe PIFu's network.
Public layouts are NHWC maps and (N, C) point rows, as in
benchmark/reference/recon.py. Float32 throughout; the convolutions without
TF32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.grid_sample import sample_feature_map_at_points
from benchmark.reference.hourglass import HGFilter
from benchmark.reference.layers import PointConv1d, f32_convolutions


class SurfaceClassifier(nn.Module):
    """PIFu's residual SurfaceClassifier on channels-last rows:
    ``filter_channels`` [257, 1024, 512, 256, 128, 1]; layer l > 0 takes
    [y, x] (filter_channels[l] + filter_channels[0] inputs); leaky ReLU
    (``slope``) after every layer but the last, then a sigmoid."""

    def __init__(self, filter_channels: Sequence[int], slope: float = 0.01):
        super().__init__()
        self.slope = slope
        self.fc_list = nn.ModuleList()
        last = len(filter_channels) - 2
        for i in range(len(filter_channels) - 1):
            cin = filter_channels[i] + (filter_channels[0] if i else 0)
            conv = PointConv1d(cin, filter_channels[i + 1])
            # the hidden layers sit in a Sequential, as the program's MLP
            # keeps them (its keys: fc_list.{i}.0)
            self.fc_list.append(conv if i == last else nn.Sequential(conv))

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        y = feature
        for i, f in enumerate(self.fc_list):
            y = f(y if i == 0 else torch.cat([y, feature], dim=-1))
            if i != len(self.fc_list) - 1:
                y = F.leaky_relu(y, self.slope)
        return torch.sigmoid(y)


class ReconNetwork(nn.Module):
    """PIFu's shape network (see the module docstring). The keywords are
    the program's ReconNetwork's; anything but PIFu's values is a
    ValueError."""

    def __init__(self, feat_channels: int = 256, depth: int = 2,
                 n_stack: int = 4, down_type: str = "ave_pool",
                 widths: Sequence[int] = (1024, 512, 256, 128),
                 res_layers: Sequence[int] = (1, 2, 3, 4),
                 weight_norm: bool = False, leaky_slope: float = 0.01):
        super().__init__()
        widths = tuple(widths)
        if tuple(res_layers) != tuple(range(1, len(widths) + 1)):
            raise ValueError(f"res_layers {tuple(res_layers)}: PIFu's "
                             "SurfaceClassifier takes the input again before "
                             "every layer after the first")
        if weight_norm:
            raise ValueError("PIFu's SurfaceClassifier has no weight norm")
        self.image_encoder = HGFilter(depth=depth, in_ch=6,
                                      last_ch=feat_channels,
                                      down_type=down_type, n_stack=n_stack)
        self.image_decoder = SurfaceClassifier(
            (feat_channels + 1,) + widths + (1,), leaky_slope)

    def get_feat_maps(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 6) NHWC -> the last stack's (B, H/4, W/4, C) NHWC."""
        with f32_convolutions():
            feats, _ = self.image_encoder(
                image.permute(0, 3, 1, 2).contiguous())
        return feats[-1].permute(0, 2, 3, 1).contiguous()

    def decode_points(self, feat_map: torch.Tensor, cano_pts: torch.Tensor,
                      cano_smpl_center: torch.Tensor) -> torch.Tensor:
        """(B, Hf, Wf, C), (B, N, 3), (B, 3) -> (B, N) occupancy."""
        pts_c = cano_pts - cano_smpl_center[:, None, :]
        pix_feat = sample_feature_map_at_points(
            feat_map.permute(0, 3, 1, 2), pts_c)
        h = torch.cat([pix_feat, pts_c[..., 2:3]], dim=-1)
        return self.image_decoder(h)[..., 0]

    def forward(self, image, cano_pts, cano_smpl_center):
        return self.decode_points(self.get_feat_maps(image), cano_pts,
                                  cano_smpl_center)
