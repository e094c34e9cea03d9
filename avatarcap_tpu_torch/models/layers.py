"""NN primitives of the port (counterpart of avatarcap_tpu/models/layers.py).

The reference networks are PyTorch already, so the layers are the stock
``torch.nn`` modules with the reference's constructor arguments. The one
piece added here is ``PointConv1d``: the reference's kernel-size-1
``Conv1d`` used as a pointwise linear layer. It keeps the Conv1d parameter
layout ``(O, I, 1)`` (so reference state_dicts load unchanged) and applies
to channels-last ``(..., N, C)`` point batches.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class PointConv1d(nn.Conv1d):
    """Conv1d(in, out, 1) applied over the last axis of (..., C) tensors."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)
