"""Point-in-mesh test by the parity of +z ray crossings (counterpart of
avatarcap_tpu/ops/inside.py: ``points_inside_mesh``).

It runs once per subject, to give the grid nodes outside the near-body
band their inside / outside prior (the reference's trimesh ``contains``),
and on the presampled points of a synthetic subject. The +z ray's hit
heights depend only on a point's (x, y), and a canonical grid has 128
nodes per (x, y) column: the heights are computed once per distinct
column, one tile of columns against all triangles at a time, and each
point counts the heights of its column above it. The arithmetic of a
point-triangle pair is the JAX package's, in its order.
"""

from __future__ import annotations

import torch


def _edge(p0, p1, q):
    return ((p1[..., 0] - p0[..., 0]) * (q[..., 1] - p0[..., 1])
            - (p1[..., 1] - p0[..., 1]) * (q[..., 0] - p0[..., 0]))


def _hit_heights(xy: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """xy: (C, 2); tris: (F, 3, 3) -> (C, F) z at which the +z ray of each
    column crosses each triangle, -inf where it does not."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    p = xy[:, None, :]
    a2, b2, c2 = a[None, :, :2], b[None, :, :2], c[None, :, :2]
    e0 = _edge(a2, b2, p)
    e1 = _edge(b2, c2, p)
    e2 = _edge(c2, a2, p)
    inside_2d = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                 | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    area = _edge(a2, b2, c2)                                   # (1, F)
    den = torch.where(area.abs() < 1e-12, torch.ones_like(area), area)
    w0 = e1 / den
    w1 = e2 / den
    w2 = 1.0 - w0 - w1
    z_hit = w0 * a[None, :, 2] + w1 * b[None, :, 2] + w2 * c[None, :, 2]
    hit = inside_2d & (area.abs() > 1e-12)
    return torch.where(hit, z_hit, torch.full_like(z_hit, float("-inf")))


def points_inside_mesh(pts: torch.Tensor, tris: torch.Tensor,
                       tile_elems: int = 1 << 25,
                       point_chunk: int = 1 << 21) -> torch.Tensor:
    """(N, 3) points, (F, 3, 3) closed mesh -> (N,) bool inside flags, on
    the points' device.

    ``tile_elems`` bounds a (columns x triangles) tile (a few such f32
    tiles are alive at once: ~1.5 GB at the default); ``point_chunk``
    bounds the (points x hits) comparison."""
    n = pts.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=pts.device)
    tris = tris.to(pts.dtype)
    # one key per distinct (x, y) bit pattern
    bits = pts[:, :2].contiguous().view(torch.int32).to(torch.int64)
    key = (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)
    uniq, col_of = torch.unique(key, return_inverse=True)
    xy = torch.empty((uniq.shape[0], 2), dtype=pts.dtype, device=pts.device)
    xy[col_of] = pts[:, :2]
    del bits, key, uniq

    cols = max(1, tile_elems // max(1, tris.shape[0]))
    heights = []
    for s in range(0, xy.shape[0], cols):
        z = _hit_heights(xy[s:s + cols], tris)
        k = max(1, int((z > float("-inf")).sum(1).max()))
        heights.append(z.topk(k, dim=1).values)       # descending, -inf pad
        del z
    k_max = max(h.shape[1] for h in heights)
    heights = torch.cat([torch.nn.functional.pad(
        h, (0, k_max - h.shape[1]), value=float("-inf")) for h in heights])

    counts = torch.empty(n, dtype=torch.int64, device=pts.device)
    for s in range(0, n, point_chunk):
        counts[s:s + point_chunk] = (
            heights[col_of[s:s + point_chunk]]
            > pts[s:s + point_chunk, 2:3]).sum(-1)
    return (counts % 2) == 1
