"""Frozen copy of avatarcap_tpu_torch/models/hourglass.py at commit 2621afd, the f32 reference path of the benchmark.

Stacked-hourglass image encoder (counterpart of
avatarcap_tpu/models/hourglass.py): GroupNorm(32), ``down_type``
"no_down" (ReconNet's) or "ave_pool", one stack or more, an optional tanh
output (``use_sigmoid``).

Module names are the reference torch names (``conv1``/``bn1`` ..., the
ConvBlock residual ``downsample.0`` GroupNorm and ``downsample.2`` conv,
the hourglass ``b1_/b2_/b3_{level}`` and ``b2_plus_1``, and per stack
``m{i}``, ``top_m_{i}``, ``conv_last{i}``, ``bn_end{i}``, ``l{i}`` and
between stacks ``bl{i}`` / ``al{i}``), the names
avatarcap_tpu/tools/convert_torch_ckpt.py:convert_hgfilter reads (it has
no ``bl`` / ``al`` keys; weights.hgfilter_state_dict_from_jax writes
them).
Layout is NCHW inside; ReconNetwork converts at its NHWC boundary.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import group_norm, upsample_bicubic_x2


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=1, padding=1, bias=False)


class ConvBlock(nn.Module):
    """3-way split residual block: GN -> ReLU -> 3x3 conv three times
    (widths out/2, out/4, out/4), concatenated, plus the input, or
    GN -> ReLU -> 1x1 conv of it when the widths differ."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn1 = group_norm(in_planes)
        self.conv1 = _conv3x3(in_planes, out_planes // 2)
        self.bn2 = group_norm(out_planes // 2)
        self.conv2 = _conv3x3(out_planes // 2, out_planes // 4)
        self.bn3 = group_norm(out_planes // 4)
        self.conv3 = _conv3x3(out_planes // 4, out_planes // 4)
        self.downsample = (nn.Sequential(
            group_norm(in_planes), nn.ReLU(),
            nn.Conv2d(in_planes, out_planes, 1, stride=1, bias=False))
            if in_planes != out_planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        residual = x if self.downsample is None else self.downsample(x)
        return out + residual


class HourGlass(nn.Module):
    """Recursive depth-d hourglass with ×2 bicubic ``align_corners``
    upsampling."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for lvl in range(depth, 0, -1):
            self.add_module(f"b1_{lvl}", ConvBlock(features, features))
            self.add_module(f"b2_{lvl}", ConvBlock(features, features))
            if lvl == 1:
                self.add_module("b2_plus_1", ConvBlock(features, features))
            self.add_module(f"b3_{lvl}", ConvBlock(features, features))

    def _level(self, lvl: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"b1_{lvl}")(inp)
        low1 = getattr(self, f"b2_{lvl}")(F.avg_pool2d(inp, 2, stride=2))
        low2 = (self._level(lvl - 1, low1) if lvl > 1
                else self.b2_plus_1(low1))
        low3 = getattr(self, f"b3_{lvl}")(low2)
        return up1 + upsample_bicubic_x2(low3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class HGFilter(nn.Module):
    """Hourglass image filter: (B, C_in, H, W) -> ([n_stack feature maps
    (B, last_ch, H/2, W/2), or H/4 with ``down_type="ave_pool"``], normx).
    ReconNet's is one stack, ``no_down``, no sigmoid. ``ave_pool`` pools
    2x after ``conv2``; each stack but the last feeds the next through the
    1x1 convs ``bl{i}`` (of its features) and ``al{i}`` (of its output),
    summed with its input; ``use_sigmoid`` puts a tanh on every output
    (the reference's name for it)."""

    def __init__(self, depth: int = 4, in_ch: int = 6, last_ch: int = 32,
                 down_type: str = "no_down", n_stack: int = 1,
                 use_sigmoid: bool = False):
        super().__init__()
        if down_type not in ("no_down", "ave_pool"):
            raise ValueError(f"down_type={down_type!r}: 'no_down' or "
                             "'ave_pool'")
        self.down_type = down_type
        self.n_stack = n_stack
        self.use_sigmoid = use_sigmoid
        self.conv1 = nn.Conv2d(in_ch, 64, 7, stride=2, padding=3)
        self.bn1 = group_norm(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(n_stack):
            self.add_module(f"m{i}", HourGlass(depth, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", group_norm(256))
            self.add_module(f"l{i}", nn.Conv2d(256, last_ch, 1))
            if i < n_stack - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(last_ch, 256, 1))

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        if self.down_type == "ave_pool":
            x = F.avg_pool2d(x, 2, stride=2)
        normx = x
        previous = self.conv4(self.conv3(normx))
        outputs = []
        for i in range(self.n_stack):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            outputs.append(torch.tanh(out) if self.use_sigmoid else out)
            if i < self.n_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(out))
        return outputs, normx
