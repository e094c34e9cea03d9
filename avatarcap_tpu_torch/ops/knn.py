"""Brute-force K nearest neighbors (counterpart of avatarcap_tpu/ops/knn.py:
``knn``, ``knn_gather``, ``approx_lbs_weights`` and the near-body distance
volume), and ``knn_chunk``, the query chunk that bounds a distance tile.
Distances are squared L2, computed as |q|^2 - 2 q.v + |v|^2 with one f32
matmul per query chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from avatarcap_tpu_torch.ops.volume_render import linspace01


# Entries of the (rows, M) float32 distance tile that callers of knn size
# their query chunks to with knn_chunk: 2^28 (1 GiB); knn holds a few such
# temporaries at once.
KNN_TILE = 1 << 28


def knn_chunk(m: int, cap: int = 65536) -> int:
    """Query rows per knn chunk against ``m`` database points: at most
    ``cap``, and a (rows, m) tile of at most KNN_TILE entries. The chunk
    changes no result."""
    return max(1, min(cap, KNN_TILE // max(1, m)))


def knn(queries: torch.Tensor, database: torch.Tensor, k: int = 1,
        chunk: int = 16384):
    """K nearest database points of each query.

    Args:
      queries: (N, 3); database: (M, 3).
    Returns:
      dists (N, k) squared distances, ascending; idx (N, k) int64.
    """
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
