"""Device meshes, placement and reductions (counterpart of
avatarcap_tpu/parallel/mesh.py).

A mesh is an ordered tuple of ``torch.device``s with one axis, "data",
driven by one process, as JAX's single-controller ``Mesh`` over
``jax.devices()``. Two axes scale the work over it:

- **data**: training batches and video frames, contiguous blocks of a
  batch per device. A train step over a mesh (train/trainer.py:
  ``make_train_step(mesh=)``) is the whole-batch step, as JAX's sharded
  step is under GSPMD: the replicas' BatchNorm statistics, losses and
  gradients are sums over the mesh (``all_reduce``). Frames:
  pipeline/streaming.py ``StreamingCapture.run``;
- **points**: the compacted grid points of one frame's implicit queries,
  one slab per device (``AvatarCapture(shard_mesh=...)``,
  parallel/grid_query.py). The slabs are gathered in order onto the
  first device, a device-to-device copy.

A placement here is a list of per-device tensors: ``shard_batch`` and
``shard_points`` split along the sharded dimension, ``replicate`` copies
whole. A reduction sums such a list onto the first device in device order
(a fixed order, so a step repeats) and copies the sum back; it is made of
``.to(device)`` copies and additions, which autograd differentiates and
which run alike on cards and on the CPU. ``ReplicaWorkers.run`` runs the
replicas stage by stage: each runs up to its next reduction
(``ReplicaGroup.all_reduce``), one after another in device order, and
then the reduction is made, so a layer that needs the whole mesh's
statistics (models/layers.py: BatchNorm) reduces in the middle of the
replicas' forwards. Each replica keeps its place between reductions in a
host thread of its own; one runs at a time. The tests
build meshes of ``["cpu"] * n``.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

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


def sum_to_first(mesh: Sequence[torch.device],
                 tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of one tensor per mesh device, taken onto the first device
    and added in device order."""
    if len(tensors) != len(mesh):
        raise ValueError(f"{len(tensors)} tensors for a mesh of "
                         f"{len(mesh)} devices")
    out = tensors[0].to(mesh[0])
    for t in tensors[1:]:
        out = out + t.to(mesh[0])
    return out


def all_reduce(mesh: Sequence[torch.device],
               tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``sum_to_first``, copied back to every device of the mesh."""
    total = sum_to_first(mesh, tensors)
    return [total.to(d) for d in mesh]


class ReplicaAborted(RuntimeError):
    """Raised in a replica whose group another replica broke."""


class ReplicaGroup:
    """The replicas of one ``ReplicaWorkers.run`` call, which take turns:
    one runs at a time, in device order, from one reduction to the next,
    and the last to reach a reduction computes it. That is a stage-major
    loop over the replicas (every replica's work up to the next
    reduction, then the reduction) in which each replica keeps its place
    in a host thread of its own. Every replica meets each reduction in the
    same order; one that cannot be met (a replica raised, or ended while
    others wait) raises in every replica instead of leaving them
    waiting."""

    def __init__(self, mesh: Sequence[torch.device]):
        self.mesh = tuple(mesh)
        self._cv = threading.Condition()
        self._turn = 0
        self._operands = {}
        self._results = None
        self._finished = 0
        self._error: Optional[BaseException] = None

    def all_reduce(self, rank: int, tensor: torch.Tensor, count=None):
        """Every replica's ``tensor`` summed (``all_reduce``), returned on
        replica ``rank``'s device, with the tuple of every replica's
        ``count`` (a host value, such as an element count) in device
        order. The other replicas run up to this reduction meanwhile."""
        n = len(self.mesh)
        with self._cv:
            if self._finished:
                err = RuntimeError("a replica ended before this mesh "
                                   "reduction: the replicas made different "
                                   "numbers of reductions")
                self._break(err)
                raise err
            self._operands[rank] = (tensor, count)
            if rank == n - 1:
                ops = [self._operands.pop(r) for r in range(n)]
                try:
                    shapes = {tuple(t.shape) for t, _ in ops}
                    if len(shapes) != 1:
                        raise ValueError(f"replicas reduce tensors of "
                                         f"shapes {sorted(shapes)}")
                    self._results = (all_reduce(self.mesh,
                                                [t for t, _ in ops]),
                                     tuple(c for _, c in ops))
                except BaseException as e:
                    self._break(e)
                    raise
            self._pass_turn(rank)
            self._wait_turn(rank)
            sums, counts = self._results
            return sums[rank], counts

    def _wait_turn(self, rank: int) -> None:
        with self._cv:
            while self._turn != rank and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise ReplicaAborted("another replica failed") \
                    from self._error

    def _pass_turn(self, rank: int) -> None:
        with self._cv:
            self._turn = (rank + 1) % len(self.mesh)
            self._cv.notify_all()

    def _break(self, error: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = error
            self._cv.notify_all()

    def _finish(self, rank: int) -> None:
        with self._cv:
            self._finished += 1
            if self._operands:
                self._break(RuntimeError(
                    "a replica ended while others wait in a mesh "
                    "reduction: the replicas made different numbers of "
                    "reductions"))
            elif rank < len(self.mesh) - 1:
                self._pass_turn(rank)


_local = threading.local()


def replica_group():
    """(group, rank) inside a replica of ``ReplicaWorkers.run``, else
    None."""
    return getattr(_local, "current", None)


class ReplicaWorkers:
    """One host thread per mesh device, kept for the life of the object
    (a new thread pays cuDNN's per-thread set-up at its first
    convolutions, so a step reuses its threads instead of starting new
    ones; they end with ``close`` or when the object is collected).
    ``run(fn)`` runs ``fn(rank)`` on each, under the caller's grad mode,
    with the rank's card current, taking turns as ``ReplicaGroup`` says
    (so the replicas' work is queued in the same order every time), and
    returns the results in device order. Inside ``fn``,
    ``replica_group()`` gives the group and the rank. An exception in one
    replica breaks the group's reductions in the others and is raised by
    ``run``. ``close`` ends the threads."""

    def __init__(self, mesh: Sequence[torch.device]):
        self.mesh = tuple(mesh)
        self._pools = [ThreadPoolExecutor(1, f"mesh-replica-{r}")
                       for r in range(len(self.mesh))]

    def run(self, fn: Callable[[int], object]) -> list:
        group = ReplicaGroup(self.mesh)
        results = [None] * len(self.mesh)
        errors: List[Optional[BaseException]] = [None] * len(self.mesh)
        grad = torch.is_grad_enabled()

        def work(rank):
            dev = self.mesh[rank]
            _local.current = (group, rank)
            try:
                group._wait_turn(rank)
                with torch.set_grad_enabled(grad), (
                        torch.cuda.device(dev) if dev.type == "cuda"
                        else contextlib.nullcontext()):
                    results[rank] = fn(rank)
                group._finish(rank)
            except BaseException as e:  # re-raised by the caller's thread
                errors[rank] = e
                group._break(e)
            finally:
                _local.current = None

        for f in [pool.submit(work, r) for r, pool in enumerate(self._pools)]:
            f.result()
        if any(e is not None for e in errors):
            raise group._error      # the first failure; the others follow
        return results

    def close(self) -> None:
        for pool in self._pools:
            pool.shutdown()

    def __enter__(self) -> "ReplicaWorkers":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

