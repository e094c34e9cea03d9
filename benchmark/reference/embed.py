"""Frozen copy of avatarcap_tpu_torch/ops/embed.py at commit 2621afd, the f32 reference path of the benchmark.

NeRF-style positional encoding (port of avatarcap_tpu/ops/embed.py).

Channel order: [x, sin(x f0), cos(x f0), sin(x f1), cos(x f1), ...] with
f_k = 2^k, each sin/cos block keeping the full input width.
"""

from __future__ import annotations

import torch


def embed_dim(num_freqs: int, input_dims: int = 3) -> int:
    """Output width of positional_encoding."""
    return input_dims * (1 + 2 * num_freqs)


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Encode (..., D) -> (..., D * (1 + 2 * num_freqs)); identity at 0."""
    if num_freqs == 0:
        return x
    blocks = [x]
    for k in range(num_freqs):
        xf = x * (2.0 ** k)
        blocks.append(torch.sin(xf))
        blocks.append(torch.cos(xf))
    return torch.cat(blocks, dim=-1)
