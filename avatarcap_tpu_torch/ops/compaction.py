"""Static-capacity stream compaction (the contract of
avatarcap_tpu/ops/compaction.py:compact_mask_indices).

The JAX package needs a popcount/forward-fill algorithm because scatters
and searchsorted are slow on the TPU; the port keeps only its contract.
``torch.nonzero`` returns the set indices in ascending order already.
"""

from __future__ import annotations

import torch


def compact_mask_indices(mask: torch.Tensor, max_out: int):
    """Indices of set entries of a (N,) bool mask, padded to max_out.

    Returns:
      idx: (max_out,) int32, ascending; padded entries are 0. Set indices
        past the capacity are dropped.
      count: () int32 number of set entries (overflow when > max_out).
      valid: (max_out,) bool.
    """
    found = torch.nonzero(mask.reshape(-1), as_tuple=False)[:, 0]
    count = found.numel()
    k = min(count, max_out)
    idx = torch.zeros(max_out, dtype=torch.int32, device=mask.device)
    idx[:k] = found[:k].to(torch.int32)
    valid = torch.arange(max_out, device=mask.device) < k
    return idx, torch.tensor(count, dtype=torch.int32,
                             device=mask.device), valid
