"""pix2pixHD generators for normal-map inference (counterpart of
avatarcap_tpu/models/pix2pix.py: ``ResnetBlock``, ``GlobalGenerator``,
``LocalEnhancer``, ``Encoder``, ``ConvTransposeOutPad1``).

The modules are the reference's own torch layout (network/networks.py:
48-242), so their state-dict keys are the names that
avatarcap_tpu/tools/convert_torch_ckpt.py reads (``model.1``,
``model.{4 + 3 i}``, ``model.{idx}.conv_block.{1,5}``, ``model{n}_1.*``,
``model{n}_2.*``) and a reference checkpoint loads unchanged. The norm is
``InstanceNorm2d(affine=False, eps=1e-5)`` (biased variance, as the JAX
``InstanceNorm``). Every forward pass runs its convolutions under
``layers.f32_convolutions``: full float32 and deterministic cuDNN
algorithms (cuDNN's defaults are TF32 and, for the transposed
convolutions, an algorithm that is not repeatable).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from avatarcap_tpu_torch.models.layers import f32_convolutions


def _norm(channels: int) -> nn.InstanceNorm2d:
    return nn.InstanceNorm2d(channels, affine=False, eps=1e-5)


def conv_transpose_out_pad1(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1): out = 2 x in (the
    JAX package's ConvTransposeOutPad1)."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel_size=3, stride=2,
                              padding=1, output_padding=1)


def _down_layers(in_nc: int, ngf: int, n_downsampling: int) -> list:
    """ReflectionPad 7x7 conv, norm, ReLU, then n stride-2 3x3 convs."""
    layers = [nn.ReflectionPad2d(3), nn.Conv2d(in_nc, ngf, 7, padding=0),
              _norm(ngf), nn.ReLU(True)]
    for i in range(n_downsampling):
        mult = 2 ** i
        layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                             padding=1),
                   _norm(ngf * mult * 2), nn.ReLU(True)]
    return layers


def _up_layers(ngf: int, n_downsampling: int) -> list:
    layers = []
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        layers += [conv_transpose_out_pad1(ngf * mult, ngf * mult // 2),
                   _norm(ngf * mult // 2), nn.ReLU(True)]
    return layers


def _out_layers(ngf: int, output_nc: int) -> list:
    return [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7, padding=0),
            nn.Tanh()]


class ResnetBlock(nn.Module):
    """Reflect-padded residual block (reference network/networks.py:
    166-205): x + [pad, conv, norm, ReLU, pad, conv, norm](x)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, padding=0),
            _norm(dim), nn.ReLU(True),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, padding=0),
            _norm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class GlobalGenerator(nn.Module):
    """ReflectionPad 7x7 -> n down -> n_blocks resnet -> n up -> 7x7, tanh
    (reference network/networks.py:133-163). NCHW in and out.
    ``include_out=False`` drops the final pad / conv / tanh (the
    LocalEnhancer's trunk)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 include_out: bool = True):
        super().__init__()
        layers = _down_layers(input_nc, ngf, n_downsampling)
        mult = 2 ** n_downsampling
        layers += [ResnetBlock(ngf * mult) for _ in range(n_blocks)]
        layers += _up_layers(ngf, n_downsampling)
        if include_out:
            layers += _out_layers(ngf, output_nc)
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with f32_convolutions():
            return self.model(x)


class LocalEnhancer(nn.Module):
    """A coarse GlobalGenerator trunk on a downsampled input plus local
    enhancer branches (reference network/networks.py:79-131); the pyramid
    is AvgPool2d(3, 2, 1, count_include_pad=False)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsample_global: int = 3, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3):
        super().__init__()
        self.n_local_enhancers = n_local_enhancers
        self.model = GlobalGenerator(
            input_nc, output_nc, ngf * 2 ** n_local_enhancers,
            n_downsample_global, n_blocks_global, include_out=False).model
        for n in range(1, n_local_enhancers + 1):
            ngf_g = ngf * 2 ** (n_local_enhancers - n)
            down = _down_layers(input_nc, ngf_g, 1)
            up = [ResnetBlock(ngf_g * 2) for _ in range(n_blocks_local)]
            up += _up_layers(ngf_g, 1)
            if n == n_local_enhancers:
                up += _out_layers(ngf, output_nc)
            setattr(self, f"model{n}_1", nn.Sequential(*down))
            setattr(self, f"model{n}_2", nn.Sequential(*up))
        self.downsample = nn.AvgPool2d(3, stride=2, padding=1,
                                       count_include_pad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with f32_convolutions():
            pyramid = [x]
            for _ in range(self.n_local_enhancers):
                pyramid.append(self.downsample(pyramid[-1]))
            h = self.model(pyramid[-1])
            for n in range(1, self.n_local_enhancers + 1):
                xin = pyramid[self.n_local_enhancers - n]
                h = getattr(self, f"model{n}_2")(
                    getattr(self, f"model{n}_1")(xin) + h)
            return h


class Encoder(nn.Module):
    """Feature encoder with instance-wise average pooling (reference
    network/networks.py:207-242): every pixel's output is the mean of its
    instance region (per item and channel). Instance ids are clipped to
    [0, max_instances - 1], as the JAX module's static segment capacity
    does; the means are one-hot products, so they are repeatable."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsampling: int = 4, max_instances: int = 64):
        super().__init__()
        self.max_instances = max_instances
        layers = _down_layers(input_nc, ngf, n_downsampling)
        layers += _up_layers(ngf, n_downsampling)
        layers += _out_layers(ngf, output_nc)
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, inst: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W); inst (B, H, W) or (B, 1, H, W) integer ids."""
        with f32_convolutions():
            h = self.model(x)
        B, C, H, W = h.shape
        ids = inst.reshape(B, H * W).long().clamp(0, self.max_instances - 1)
        onehot = F.one_hot(ids, self.max_instances).to(h.dtype)  # (B, HW, S)
        flat = h.reshape(B, C, H * W).transpose(1, 2)            # (B, HW, C)
        sums = onehot.transpose(1, 2) @ flat                      # (B, S, C)
        mean = sums / onehot.sum(1).clamp_min(1.0)[..., None]
        return (onehot @ mean).transpose(1, 2).reshape(B, C, H, W)
