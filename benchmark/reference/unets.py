"""Frozen copy of avatarcap_tpu_torch/models/unets.py at commit 2621afd, the f32 reference path of the benchmark.

POP-style U-Nets (counterpart of avatarcap_tpu/models/unets.py): the
warp field's UnetNoCond7DS and the 5- and 6-downsample variants
UnetNoCond5DS and UnetNoCond6DS (exported; nothing in either package
calls them).

Kept reference quirk: ``upconv3`` is applied twice with shared parameters
and ``upconv4`` is never applied (the released checkpoints were trained
with that wiring; ``upconvC5`` expects 4*nf*3 inputs because of it). The
dead ``upconv4`` parameters are not created here; weights.py lists them as
the keys to drop when loading a reference checkpoint.

Tensors are NCHW inside; the public pipeline functions keep the JAX
package's NHWC layout. In training mode every BatchNorm updates its
running statistics as flax does (models/layers.BatchNorm2d), ``upconv3``'s
twice per forward, in order. A 64^2 input map leaves conv7 with nothing
to convolve; the blocks then give what XLA's convolutions give (an empty
bottleneck, then zeros), where torch's would raise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import BatchNorm2d


class Conv2DBlock(nn.Module):
    """[LeakyReLU(0.2)] -> Conv(k4 s2 p1, no bias) -> [BN (non-affine)]."""

    def __init__(self, in_nc: int, out_nc: int, use_bn: bool = True,
                 use_relu: bool = True):
        super().__init__()
        self.use_relu = use_relu
        self.conv = nn.Conv2d(in_nc, out_nc, 4, 2, 1, bias=False)
        self.bn = BatchNorm2d(out_nc, affine=False) if use_bn else None

    def forward(self, x):
        if self.use_relu:
            x = F.leaky_relu(x, 0.2)
        if min(x.shape[-2:]) + 2 < 4:
            # the padded input is smaller than the kernel: XLA's
            # convolution gives an empty output (the JAX U-Net on a 64^2
            # map reaches conv7 at 1 x 1), where torch's raises
            return x.new_zeros(x.shape[:1] + (self.conv.out_channels, 0, 0))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return x


class UpConv2DBlock(nn.Module):
    """ReLU -> (ConvTranspose k4 s2 p1 | bilinear x2 + Conv 3x3) -> [BN]
    -> concat skip."""

    def __init__(self, in_nc: int, out_nc: int, use_bn: bool = True,
                 use_bias: bool = False, up_mode: str = "upconv"):
        super().__init__()
        if up_mode == "upconv":
            self.up = nn.ConvTranspose2d(in_nc, out_nc, 4, 2, 1,
                                         bias=use_bias)
        else:
            self.up = nn.Sequential(
                nn.Upsample(scale_factor=2, mode="bilinear",
                            align_corners=False),
                nn.Conv2d(in_nc, out_nc, 3, 1, 1, bias=True))
        self.bn = BatchNorm2d(out_nc, affine=False) if use_bn else None

    def forward(self, x, skip=None):
        if x.shape[-1] == 0:
            # XLA's transposed convolution of an empty input is one pixel
            # of padding only: the bias, or 0
            conv = self.up if isinstance(self.up, nn.ConvTranspose2d) \
                else self.up[1]
            x = x.new_zeros(x.shape[:1] + (conv.out_channels, 1, 1))
            if conv.bias is not None:
                x = x + conv.bias[None, :, None, None]
        else:
            x = self.up(F.relu(x))
        if self.bn is not None:
            x = self.bn(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return x


class UnetNoCond5DS(nn.Module):
    """5 downsamples; ``up_mode`` ("upconv" or "upsample") for all five
    up blocks."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, nf: int = 64,
                 up_mode: str = "upconv"):
        super().__init__()
        self.conv1 = Conv2DBlock(input_nc, nf, use_bn=False, use_relu=False)
        self.conv2 = Conv2DBlock(nf, 2 * nf)
        self.conv3 = Conv2DBlock(2 * nf, 4 * nf)
        self.conv4 = Conv2DBlock(4 * nf, 8 * nf)
        self.conv5 = Conv2DBlock(8 * nf, 8 * nf, use_bn=False)
        self.upconv1 = UpConv2DBlock(8 * nf, 8 * nf, up_mode=up_mode)
        self.upconv2 = UpConv2DBlock(16 * nf, 4 * nf, up_mode=up_mode)
        self.upconv3 = UpConv2DBlock(8 * nf, 2 * nf, up_mode=up_mode)
        self.upconv4 = UpConv2DBlock(4 * nf, nf, up_mode=up_mode)
        self.upconv5 = UpConv2DBlock(2 * nf, output_nc, use_bn=False,
                                     use_bias=True, up_mode=up_mode)

    def forward(self, x):
        d1 = self.conv1(x)
        d2 = self.conv2(d1)
        d3 = self.conv3(d2)
        d4 = self.conv4(d3)
        d5 = self.conv5(d4)
        u1 = self.upconv1(d5, d4)
        u2 = self.upconv2(u1, d3)
        u3 = self.upconv3(u2, d2)
        u4 = self.upconv4(u3, d1)
        return self.upconv5(u4)


class UnetNoCond6DS(nn.Module):
    """6 downsamples; ``up_mode`` for upconv1-4, upconvC5 and upconvC6
    always "upsample"."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, nf: int = 64,
                 up_mode: str = "upconv"):
        super().__init__()
        self.conv1 = Conv2DBlock(input_nc, nf, use_bn=False, use_relu=False)
        self.conv2 = Conv2DBlock(nf, 2 * nf)
        self.conv3 = Conv2DBlock(2 * nf, 4 * nf)
        self.conv4 = Conv2DBlock(4 * nf, 8 * nf)
        self.conv5 = Conv2DBlock(8 * nf, 8 * nf)
        self.conv6 = Conv2DBlock(8 * nf, 8 * nf, use_bn=False)
        self.upconv1 = UpConv2DBlock(8 * nf, 8 * nf, up_mode=up_mode)
        self.upconv2 = UpConv2DBlock(16 * nf, 8 * nf, up_mode=up_mode)
        self.upconv3 = UpConv2DBlock(16 * nf, 8 * nf, up_mode=up_mode)
        self.upconv4 = UpConv2DBlock(12 * nf, 4 * nf, up_mode=up_mode)
        self.upconvC5 = UpConv2DBlock(6 * nf, 2 * nf, up_mode="upsample")
        self.upconvC6 = UpConv2DBlock(3 * nf, output_nc, use_bn=False,
                                      use_bias=True, up_mode="upsample")

    def forward(self, x):
        d1 = self.conv1(x)
        d2 = self.conv2(d1)
        d3 = self.conv3(d2)
        d4 = self.conv4(d3)
        d5 = self.conv5(d4)
        d6 = self.conv6(d5)
        u1 = self.upconv1(d6, d5)
        u2 = self.upconv2(u1, d4)
        u3 = self.upconv3(u2, d3)
        u4 = self.upconv4(u3, d2)
        uc5 = self.upconvC5(u4, d1)
        return self.upconvC6(uc5)


class UnetNoCond7DS(nn.Module):
    """256x256 input -> 2x2 bottleneck -> 256x256 x output_nc features."""

    def __init__(self, input_nc: int = 6, output_nc: int = 64, nf: int = 32):
        super().__init__()
        self.conv1 = Conv2DBlock(input_nc, nf, use_bn=False, use_relu=False)
        self.conv2 = Conv2DBlock(nf, 2 * nf)
        self.conv3 = Conv2DBlock(2 * nf, 4 * nf)
        self.conv4 = Conv2DBlock(4 * nf, 8 * nf)
        self.conv5 = Conv2DBlock(8 * nf, 8 * nf)
        self.conv6 = Conv2DBlock(8 * nf, 8 * nf)
        self.conv7 = Conv2DBlock(8 * nf, 8 * nf, use_bn=False)
        self.upconv1 = UpConv2DBlock(8 * nf, 8 * nf)
        self.upconv2 = UpConv2DBlock(16 * nf, 8 * nf)
        self.upconv3 = UpConv2DBlock(16 * nf, 8 * nf)
        self.upconvC5 = UpConv2DBlock(12 * nf, 2 * nf, up_mode="upsample")
        self.upconvC6 = UpConv2DBlock(4 * nf, nf, up_mode="upsample")
        self.upconvC7 = UpConv2DBlock(2 * nf, output_nc, use_bn=False,
                                      use_bias=True, up_mode="upsample")

    def forward(self, x):
        d1 = self.conv1(x)
        d2 = self.conv2(d1)
        d3 = self.conv3(d2)
        d4 = self.conv4(d3)
        d5 = self.conv5(d4)
        d6 = self.conv6(d5)
        d7 = self.conv7(d6)
        u1 = self.upconv1(d7, d6)
        u2 = self.upconv2(u1, d5)
        u3 = self.upconv3(u2, d4)
        u4 = self.upconv3(u3, d3)      # reference quirk: upconv3 again
        uc5 = self.upconvC5(u4, d2)
        uc6 = self.upconvC6(uc5, d1)
        return self.upconvC7(uc6)
