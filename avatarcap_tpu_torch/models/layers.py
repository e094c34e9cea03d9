"""NN primitives of the port (counterpart of avatarcap_tpu/models/layers.py).

The reference networks are PyTorch already, so the layers are the stock
``torch.nn`` modules with the reference's constructor arguments. Added
here:

- ``PointConv1d``: the reference's kernel-size-1 ``Conv1d`` used as a
  pointwise linear layer. It keeps the Conv1d parameter layout
  ``(O, I, 1)`` (so reference state_dicts load unchanged) and applies to
  channels-last ``(..., N, C)`` point batches;
- ``WeightNormPointConv1d``: the same layer under the reference's
  ``torch.nn.utils.weight_norm`` (dim 0), with the reference's parameter
  names ``weight_g`` (O, 1, 1) and ``weight_v`` (O, I, 1);
- ``group_norm`` and ``upsample_bicubic_x2``: GroupNorm(32, C) and the
  x2 bicubic ``align_corners=True`` upsample of the hourglass;
- ``f32_convolutions``: cuDNN convolutions in full float32, with
  deterministic algorithms.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F


class PointConv1d(nn.Conv1d):
    """Conv1d(in, out, 1) applied over the last axis of (..., C) tensors."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class WeightNormPointConv1d(nn.Module):
    """Weight-normed pointwise conv: w = g v / max(|v|, 1e-12) per output
    channel (the fold of avatarcap_tpu/models/layers.py:Dense). Not
    ``torch.nn.utils.parametrizations.weight_norm``: that renames the
    parameters, and reference checkpoints would no longer load."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        ref = nn.Conv1d(in_channels, out_channels, kernel_size=1)
        self.weight_v = nn.Parameter(ref.weight.detach().clone())
        self.weight_g = nn.Parameter(
            ref.weight.detach().norm(dim=(1, 2), keepdim=True))
        self.bias = nn.Parameter(ref.bias.detach().clone())

    def folded_weight(self) -> torch.Tensor:
        """(O, I) effective weight, the norm taken as sqrt(sum v^2) like
        the JAX Dense and pack_recon_weights."""
        v = self.weight_v[:, :, 0]
        norm = torch.sqrt((v * v).sum(1, keepdim=True)).clamp_min(1e-12)
        return v * (self.weight_g[:, :, 0] / norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.folded_weight(), self.bias)


def group_norm(channels: int) -> nn.GroupNorm:
    """GroupNorm(32, C) with torch defaults (affine, eps 1e-5)."""
    return nn.GroupNorm(32, channels, eps=1e-5)


def upsample_bicubic_x2(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), bicubic A = -0.75 with clamped taps
    and ``align_corners=True`` (the reference's own call)."""
    return F.interpolate(x, scale_factor=2, mode="bicubic",
                         align_corners=True)


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions in full float32 (cuDNN's default is TF32) and
    with deterministic algorithms, as the JAX package's one program is:
    cuDNN's default pick for the U-Net's transposed convolutions is not,
    and made the pose features, and through them the avatar mesh, differ
    from run to run on the card. The other cuDNN flags stay as the caller
    set them."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=True, allow_tf32=False):
        yield
