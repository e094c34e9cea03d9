"""Brute-force K nearest neighbors (counterpart of avatarcap_tpu/ops/knn.py:
``knn``, ``knn_gather``, ``approx_lbs_weights`` and the near-body distance
volume), and ``knn_chunk``, the query chunk that bounds a distance tile.
Distances are squared L2, computed as |q|^2 - 2 q.v + |v|^2 with one f32
matmul per query chunk; on float32 CUDA tensors the nearest one (k = 1)
comes from one launch of csrc/nearest_vertex.cu instead, which writes no
tile and repeats that arithmetic's rounding (``nearest_vertex``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from avatarcap_tpu_torch.ops.volume_render import linspace01
from avatarcap_tpu_torch.utils.timers import count, live_rows, span


# Entries of the (rows, M) float32 distance tile that callers of knn size
# their query chunks to with knn_chunk: 2^28 (1 GiB); knn holds a few such
# temporaries at once.
KNN_TILE = 1 << 28


def knn_chunk(m: int, cap: int = 65536) -> int:
    """Query rows per knn chunk against ``m`` database points: at most
    ``cap``, and a (rows, m) tile of at most KNN_TILE entries. The chunk
    changes no result."""
    return max(1, min(cap, KNN_TILE // max(1, m)))


def nearest_vertex(queries: torch.Tensor, database: torch.Tensor):
    """The nearest database point of each query, in one launch of
    ``csrc/nearest_vertex.cu``: knn's k = 1 on float32 CUDA tensors.

    The database goes to the kernel as (x, y, z, |v|^2) rows and each
    query with its |q|^2, both computed here as knn's plain path computes
    them; the kernel repeats that path's rounding of the product and the
    sums, so the distances are its bits and the index is its index (the
    first of equal minima). Nothing synchronises; no gradient flows (the
    JAX package's knn stops them too). Counted in
    ``nearest_vertex.launches``; under a tracer the launch is a span
    ``knn_kernel`` whose ``rows`` are the N queries.

    Args:
      queries: (N, 3) float32, contiguous, on a CUDA device.
      database: (M, 3), the same, M >= 1, on the same device.
    Returns:
      d2 (N, 1) float32 squared distances, clamped at 0; idx (N, 1) int64.
    """
    from avatarcap_tpu_torch import kernels
    named = (("queries", queries), ("database", database))
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes float32")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (rows, 3), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the kernel takes CUDA "
                             "tensors")
    if database.device != queries.device:
        raise ValueError(f"database on {database.device}, queries on "
                         f"{queries.device}")
    n, m = queries.shape[0], database.shape[0]
    if m == 0 or m >= 2 ** 31:
        raise ValueError(f"database of {m} points out of the kernel's range")
    dev = queries.device
    d2 = torch.empty((n, 1), dtype=torch.float32, device=dev)
    idx = torch.empty((n, 1), dtype=torch.int64, device=dev)
    if n == 0:
        return d2, idx
    q, db = queries.detach(), database.detach()
    q_sq = (q * q).sum(-1)
    rows = torch.cat([db, (db * db).sum(-1)[:, None]], 1)
    launch, err_str = kernels.c_functions(
        "nearest_vertex", "nearest_vertex",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p])
    # every row is live; a scope of its own leaves an outer scope's rows
    # to the kernels they count
    with live_rows(n), span("knn_kernel"):
        count("rows", n)
        with torch.cuda.device(dev):
            err = launch(q.data_ptr(), q_sq.data_ptr(), n, rows.data_ptr(), m,
                         d2.data_ptr(), idx.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    kernels.raise_on(err, err_str, "nearest_vertex")
    nearest_vertex.launches += 1
    return d2, idx


nearest_vertex.launches = 0


def knn(queries: torch.Tensor, database: torch.Tensor, k: int = 1,
        chunk: int = 16384):
    """K nearest database points of each query.

    Args:
      queries: (N, 3); database: (M, 3).
    Returns:
      dists (N, k) squared distances, ascending; idx (N, k) int64.
    Under a tracer (utils/timers) the call is a span ``knn``. With k = 1
    on float32 CUDA tensors the answer is one launch of
    ``nearest_vertex`` (knn_plain's bits; ``chunk`` then has no effect);
    otherwise knn_plain.
    """
    with span("knn"):
        if (k == 1 and queries.is_cuda and database.is_cuda
                and queries.dtype == database.dtype == torch.float32):
            return nearest_vertex(queries.contiguous(),
                                  database.contiguous())
        return knn_plain(queries, database, k, chunk)


def knn_plain(queries: torch.Tensor, database: torch.Tensor, k: int = 1,
              chunk: int = 16384):
    """knn in PyTorch on any device: every ``chunk`` queries make a
    (chunk, M) distance tile, one product and three elementwise passes,
    then its min (k = 1) or top-k. The chunk changes no result."""
    db_sq = (database * database).sum(-1)
    dists, idxs = [], []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        d2 = ((q * q).sum(-1, keepdim=True) - 2.0 * (q @ database.T)
              + db_sq[None, :])
        if k == 1:
            d, i = d2.min(dim=-1, keepdim=True)
        else:
            neg, i = torch.topk(-d2, k, dim=-1)
            d = -neg
        dists.append(d.clamp_min(0.0))
        idxs.append(i)
    return torch.cat(dists), torch.cat(idxs)


def knn_gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (M, C) values at (N, K) indices -> (N, K, C)."""
    return values[idx]


def approx_lbs_weights(points: torch.Tensor, smpl_vertices: torch.Tensor,
                       skinning_weights: torch.Tensor, k: int = 4,
                       radius: float = 0.05, chunk: int = 65536
                       ) -> torch.Tensor:
    """Gaussian-weighted KNN blend weights near the body: K=4 neighbors,
    weights exp(-d^2 / (2 r^2)), normalized with a 1e-16 floor. (N, J)."""
    d2, idx = knn(points, smpl_vertices, k=k, chunk=chunk)
    w = torch.exp(-d2 / (2.0 * radius * radius))
    w = w / (w.sum(-1, keepdim=True) + 1e-16)
    return (skinning_weights[idx] * w[..., None]).sum(-2)


def near_distance_volume(smpl_vertices: torch.Tensor, bounds: torch.Tensor,
                         voxel: float = 0.025):
    """Distance to the nearest body vertex on a regular canonical grid:
    node (i, j, k) sits at lo + [i, j, k] / (n - 1) * (hi - lo), with
    n = max(2, ceil((hi - lo) / voxel)) + 1 per axis (the layout
    ``sample_distance_volume`` reads). One host readback of the bounds
    sizes the grid. Returns (vol (X, Y, Z) f32 metres, res)."""
    b = bounds.detach().cpu().double().numpy()
    lo, hi = b[0], b[1]
    res = tuple(int(max(2, np.ceil((hi[a] - lo[a]) / voxel)) + 1)
                for a in range(3))
    dev = smpl_vertices.device
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lin = []
    for a in range(3):
        t = linspace01(res[a], device=dev)
        lin.append(float(lo32[a]) * (1.0 - t) + float(hi32[a]) * t)
    pts = torch.stack(torch.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    d2, _ = knn(pts, smpl_vertices, k=1, chunk=65536)
    return torch.sqrt(d2[:, 0]).reshape(res), res


def sample_distance_volume(vol: torch.Tensor, pts: torch.Tensor,
                           bounds: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a ``near_distance_volume`` at (N, 3) points.

    Outside the bounds the trilinear value at the box projection c of p is
    not a distance bound by itself; with |p - c| the distance to the box,
    max(d(c) - |p - c|, |p - c|) is (every vertex lies inside the box, and
    the distance field is 1-Lipschitz), and it reduces to the trilinear
    sample inside the box.
    """
    lo, hi = bounds[0], bounds[1]
    n = torch.tensor(vol.shape, dtype=pts.dtype, device=pts.device)
    f = (pts - lo) / (hi - lo) * (n - 1.0)             # node coordinates
    f = torch.minimum(torch.maximum(f, torch.zeros_like(f)), n - 1.0)
    f0 = torch.floor(torch.minimum(f, n - 2.0))
    w = f - f0
    i0 = f0.long()
    _, Y, Z = vol.shape
    flat = vol.reshape(-1)

    def at(dx, dy, dz):
        return flat[((i0[:, 0] + dx) * Y + (i0[:, 1] + dy)) * Z
                    + (i0[:, 2] + dz)]

    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    c00 = at(0, 0, 0) * (1 - wz) + at(0, 0, 1) * wz
    c01 = at(0, 1, 0) * (1 - wz) + at(0, 1, 1) * wz
    c10 = at(1, 0, 0) * (1 - wz) + at(1, 0, 1) * wz
    c11 = at(1, 1, 0) * (1 - wz) + at(1, 1, 1) * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    d_clamped = c0 * (1 - wx) + c1 * wx
    d_box = torch.clamp(torch.maximum(lo - pts, pts - hi), min=0.0).norm(
        dim=-1)
    return torch.maximum(d_clamped - d_box, d_box)
