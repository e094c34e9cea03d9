"""Frozen copy of avatarcap_tpu_torch/ops/compaction.py at commit 2621afd, the f32 reference path of the benchmark.

Static-capacity stream compaction (the contract of
avatarcap_tpu/ops/compaction.py:compact_mask_indices).

The JAX package needs a popcount/forward-fill algorithm because scatters
and searchsorted are slow on the TPU; the port keeps only its contract.
A prefix sum gives every set entry its output slot and one scatter puts it
there, so nothing is read back to the host and the frame never waits for
the card here.
"""

from __future__ import annotations

import torch


def compact_mask_indices(mask: torch.Tensor, max_out: int):
    """Indices of set entries of a (N,) bool mask, padded to max_out.

    Returns:
      idx: (max_out,) int32, ascending; padded entries are 0. Set indices
        past the capacity are dropped.
      count: () int32 number of set entries (overflow when > max_out), on
        the mask's device.
      valid: (max_out,) bool.
    """
    m = mask.reshape(-1)
    # int32 positions: N < 2^31 (the masks are at most a grid's nodes)
    pos = torch.cumsum(m, 0, dtype=torch.int32)
    # a copy, so the count does not keep the (N,) prefix sum alive
    count = pos[-1].clone() if m.numel() else pos.new_zeros(())
    # set entries go to slot pos - 1; unset ones and the set ones past the
    # capacity to the dump slot max_out, cut off below before any read
    slot = torch.where(m & (pos <= max_out), pos - 1,
                       torch.full_like(pos, max_out))
    idx = torch.zeros(max_out + 1, dtype=torch.int32, device=m.device)
    idx.scatter_(0, slot.long(),
                 torch.arange(m.numel(), dtype=torch.int32, device=m.device))
    valid = torch.arange(max_out, device=m.device) < count
    return idx[:max_out], count, valid
