"""Frozen copy of avatarcap_tpu_torch/device.py at commit 2621afd, the f32 reference path of the benchmark.

Device selection for the port's entry points, and host-to-device copies
that do not make the host wait for the card.

Entry points run on the card unless the caller asks for the CPU. Nothing
falls back to the CPU on its own: without a card, ``device=None`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is present); otherwise the
    device the caller named (``"cpu"`` for the plain-PyTorch path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def to_device(data, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """Host data (numpy array, list or host tensor) on ``device``. A card
    gets it from pinned memory with ``non_blocking=True``: the copy is
    queued on the current stream, and the host does not wait for it (a
    copy from pageable memory would wait for the card)."""
    t = torch.as_tensor(data, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(data, device, dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """``to_device(data, device, dtype)``, copied once per value, dtype and
    device: the host constants a frame uses every time (tables, index
    vectors, matrices of fixed cameras). Callers must not write to it."""
    arr = np.ascontiguousarray(data)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype,
           str(torch.device(device)))
    hit = _CONSTANTS.get(key)
    if hit is None:
        # a normal tensor, so autograd may save it also when the first
        # call runs under inference_mode
        with torch.inference_mode(False):
            hit = _CONSTANTS[key] = to_device(arr, device, dtype)
    return hit
