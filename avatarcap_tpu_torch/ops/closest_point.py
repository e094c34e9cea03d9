"""Exact closest point / signed distance to a triangle mesh (counterpart of
avatarcap_tpu/ops/closest_point.py: ``ClosestPoint``,
``_point_triangle_closest``, ``closest_point_on_mesh``,
``signed_distance``).

Per query point, a KNN over the face centroids proposes k candidate faces
and the exact point-triangle projection picks the closest, one chunk of
queries at a time, on the queries' device. The candidate search takes no
gradient (the JAX package's ``stop_gradient`` of an integer search); the
projection does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avatarcap_tpu_torch.ops.inside import points_inside_mesh
from avatarcap_tpu_torch.ops.knn import knn, knn_chunk


class ClosestPoint(NamedTuple):
    points: torch.Tensor     # (N, 3) closest surface points
    face_idx: torch.Tensor   # (N,) int32 face indices
    bary: torch.Tensor       # (N, 3) barycentric coords
    dist: torch.Tensor       # (N,) unsigned distances


def _point_triangle_closest(p, a, b, c):
    """Exact closest point on triangle (abc) to p; all (..., 3).
    Ericson, Real-Time Collision Detection 5.1.5, branch-free: the region
    tests are applied in the JAX order, the later ones winning."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    one = torch.ones_like(va)
    zero = torch.zeros_like(va)

    def safe(den):
        return torch.where(den.abs() < 1e-20, one, den)

    denom = safe(va + vb + vc)
    v = vb / denom
    w = vc / denom
    bary = torch.stack([1.0 - v - w, v, w], -1)        # interior

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    v_ab = d1 / safe(d1 - d3)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    w_ac = d2 / safe(d2 - d6)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    for region, value in (
            (in_bc, (zero, 1 - t_bc, t_bc)),
            (in_ac, (1 - w_ac, zero, w_ac)),
            (in_ab, (1 - v_ab, v_ab, zero)),
            (in_c, (zero, zero, one)),
            (in_b, (zero, one, zero)),
            (in_a, (one, zero, zero))):
        bary = torch.where(region[..., None], torch.stack(value, -1), bary)
    bary = bary.clamp(0.0, 1.0)
    bary = bary / bary.sum(-1, keepdim=True).clamp_min(1e-12)
    out = bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c
    return out, bary


def closest_point_on_mesh(pts: torch.Tensor, verts: torch.Tensor,
                          faces: torch.Tensor, k: int = 32,
                          chunk: int = 8192) -> ClosestPoint:
    """Closest surface point for each query (KNN candidates + exact test).

    Args:
      pts: (N, 3); verts: (V, 3); faces: (F, 3) integer.
      k: candidate faces per point, by centroid distance (exact when the
        true closest face is among the k nearest centroids).
      chunk: queries per candidate search, lowered where a (chunk, F)
        distance tile would pass ``knn.KNN_TILE`` entries.
    """
    tri = verts[faces.long()]                          # (F, 3, 3)
    centroids = tri.mean(dim=1)
    k = min(k, tri.shape[0])
    chunk = knn_chunk(tri.shape[0], chunk)
    outs = []
    for s in range(0, pts.shape[0], chunk):
        q = pts[s:s + chunk]
        with torch.no_grad():
            _, cand = knn(q, centroids, k=k, chunk=q.shape[0])   # (C, k)
        t = tri[cand]                                            # (C, k, 3, 3)
        cp_pts, bary = _point_triangle_closest(
            q[:, None], t[..., 0, :], t[..., 1, :], t[..., 2, :])
        d2 = ((cp_pts - q[:, None]) ** 2).sum(-1)                # (C, k)
        best = d2.argmin(dim=-1, keepdim=True)
        outs.append((
            cp_pts.gather(1, best[..., None].expand(-1, 1, 3))[:, 0],
            cand.gather(1, best)[:, 0].to(torch.int32),
            bary.gather(1, best[..., None].expand(-1, 1, 3))[:, 0],
            torch.sqrt(d2.gather(1, best)[:, 0])))
    return ClosestPoint(*(torch.cat(x) for x in zip(*outs)))


def signed_distance(pts: torch.Tensor, verts: torch.Tensor,
                    faces: torch.Tensor, inside_positive: bool = True):
    """igl.signed_distance's counterpart, the sign from the ray-crossing
    parity. Returns (sdf (N,), ClosestPoint)."""
    cp = closest_point_on_mesh(pts, verts, faces)
    with torch.no_grad():
        inside = points_inside_mesh(pts, verts[faces.long()])
    sign = torch.where(inside, 1.0, -1.0).to(pts.dtype)
    if not inside_positive:
        sign = -sign
    return sign * cp.dist, cp
