"""Point MLPs (counterpart of avatarcap_tpu/models/mlp.py).

Module and parameter names follow the reference torch networks
(``fc_list.{i}.0`` hidden convs, ``fc_list.{n}`` output conv;
``conv{i}``/``bn{i}`` in the OffsetDecoder), which is what
avatarcap_tpu/tools/convert_torch_ckpt.py reads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from avatarcap_tpu_torch.models.layers import (BatchNorm1d, PointConv1d,
                                               WeightNormPointConv1d)


class MLP(nn.Module):
    """Residual-concat MLP: layer i in ``res_layers`` (the output conv is
    layer ``len(inter_channels)``) consumes concat([h, input]); hidden
    layers use ReLU, or LeakyReLU(``leaky_slope``, 0.02 by default) with
    ``nlactv="leaky_relu"``; the output conv has no activation, then a
    sigmoid with ``last_op="sigmoid"``. ``weight_norm`` applies to the
    hidden layers only (the reference never weight-norms the output
    conv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 inter_channels: Sequence[int], res_layers: Sequence[int] = (),
                 nlactv: str = "relu", last_op: Optional[str] = None,
                 weight_norm: bool = False, leaky_slope: float = 0.02):
        super().__init__()
        if last_op not in (None, "sigmoid"):
            raise ValueError(f"unsupported last_op {last_op!r}")
        self.res_layers = tuple(res_layers)
        self.last_op = last_op
        self.fc_list = nn.ModuleList()
        hidden = WeightNormPointConv1d if weight_norm else PointConv1d
        prev = in_channels
        for i, ch in enumerate(inter_channels):
            cin = prev + (in_channels if i in self.res_layers else 0)
            act = (nn.LeakyReLU(leaky_slope) if nlactv == "leaky_relu"
                   else nn.ReLU())
            self.fc_list.append(nn.Sequential(hidden(cin, ch), act))
            prev = ch
        n = len(inter_channels)
        cin = prev + (in_channels if n in self.res_layers else 0)
        self.fc_list.append(PointConv1d(cin, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        n = len(self.fc_list) - 1
        for i in range(n):
            if i in self.res_layers:
                x = torch.cat([x, x0], dim=-1)
            x = self.fc_list[i](x)
        if n in self.res_layers:
            x = torch.cat([x, x0], dim=-1)
        x = self.fc_list[n](x)
        return torch.sigmoid(x) if self.last_op == "sigmoid" else x


class OffsetDecoder(nn.Module):
    """POP-style ShapeDecoder: 7 pointwise convs + affine BatchNorm +
    softplus, input skip-concat at layer 5. Returns the 256-d feature."""

    def __init__(self, in_channels: int = 67, hsize: int = 256):
        super().__init__()
        for i in range(1, 8):
            cin = in_channels if i == 1 else hsize
            if i == 5:
                cin = in_channels + hsize
            setattr(self, f"conv{i}", PointConv1d(cin, hsize))
            setattr(self, f"bn{i}", BatchNorm1d(hsize, eps=1e-5))

    def _block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"conv{i}")(h)
        shape = h.shape
        h = getattr(self, f"bn{i}")(h.reshape(-1, shape[-1])).reshape(shape)
        return F.softplus(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(1, 5):
            h = self._block(i, h)
        h = torch.cat([x, h], dim=-1)
        for i in range(5, 8):
            h = self._block(i, h)
        return h
