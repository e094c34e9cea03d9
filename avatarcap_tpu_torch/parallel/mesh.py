"""Device meshes and placement (counterpart of
avatarcap_tpu/parallel/mesh.py).

A mesh is an ordered tuple of ``torch.device``s with one axis, "data",
driven by one process and one Python thread, as JAX's single-controller
``Mesh`` over ``jax.devices()``. Two axes scale the capture over it:

- **data**: video frames, contiguous blocks of a batch per device
  (pipeline/streaming.py: ``StreamingCapture.run``);
- **points**: the compacted grid points of one frame's implicit queries,
  one slab per device (``AvatarCapture(shard_mesh=...)``,
  parallel/grid_query.py). The slabs are gathered in order onto the
  first device, a device-to-device copy; there is no other communication.

A placement here is a list of per-device tensors: ``shard_batch`` and
``shard_points`` split along the sharded dimension, ``replicate`` copies
whole. The tests build meshes of ``["cpu"] * n``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

AXIS = "data"


def canonical_device(device) -> torch.device:
    """``device`` with a CUDA index filled in ("cuda" -> "cuda:k" of the
    current card), so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Iterable] = None, axis: str = AXIS
              ) -> Tuple[torch.device, ...]:
    """1-D mesh over every CUDA device (raises without one) or over the
    given devices, in order; a device may repeat."""
    if axis != AXIS:
        raise ValueError(f"the port's meshes have the one axis {AXIS!r}, "
                         f"got {axis!r}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name the devices, e.g. "
                "make_mesh(['cpu'] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(canonical_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _split(x: torch.Tensor, mesh: Sequence[torch.device], dim: int
           ) -> List[torch.Tensor]:
    n = x.shape[dim] // len(mesh)
    return [x.narrow(dim, i * n, n).to(d) for i, d in enumerate(mesh)]


def shard_batch(mesh: Sequence[torch.device], tree, axis: str = AXIS,
                dim: int = 0):
    """Each tensor of ``tree`` (a tensor, or a list, tuple or dict of them)
    split along ``dim`` into one block per device when that dimension
    divides by the mesh size, else copied whole to every device (JAX's
    rule: such a leaf is replicated)."""
    def put(x):
        if x.dim() > dim and x.shape[dim] % len(mesh) == 0:
            return _split(x, mesh, dim)
        return [x.to(d) for d in mesh]
    return _map(put, tree, axis)


def shard_points(mesh: Sequence[torch.device], pts, axis: str = AXIS):
    """(B, N, ...) point tensors split over N, one slab per device (N must
    divide by the mesh size)."""
    def put(x):
        if x.shape[1] % len(mesh):
            raise ValueError(f"{x.shape[1]} points do not divide over "
                             f"{len(mesh)} devices")
        return _split(x, mesh, 1)
    return _map(put, pts, axis)


def replicate(mesh: Sequence[torch.device], tree):
    """Every tensor of ``tree`` copied whole to every device."""
    return _map(lambda x: [x.to(d) for d in mesh], tree, AXIS)


def _map(fn, tree, axis: str):
    if axis != AXIS:
        raise ValueError(f"the port's meshes have the one axis {AXIS!r}, "
                         f"got {axis!r}")
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, v, axis) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    raise TypeError(f"cannot place a {type(tree).__name__}")
