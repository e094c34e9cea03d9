"""Brute-force K nearest neighbors (counterpart of avatarcap_tpu/ops/knn.py:
``knn`` and ``approx_lbs_weights``). Distances are squared L2, computed
as |q|^2 - 2 q.v + |v|^2 with one f32 matmul per query chunk.
"""

from __future__ import annotations

import torch


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
