"""Iso-surface extraction (counterpart of avatarcap_tpu/ops/marching_cubes.py:
``marching_tets`` with ``method="mc256"`` or ``"tets"``, its normals from
the cube's trilinear gradient (``gradient_normals``) or from a Sobel
gradient volume (``normal_volume``), and ``mesh_grid_coords``).

The case tables are derived from the 6-tetrahedra cube split at import
time, exactly as the JAX module derives them (no hand-typed LUT): the tet
tables first, then the 256-case marching-cubes tables from the tet patches
by boundary-loop simplification. The output contract is the JAX one: a
triangle soup at static capacity ``max_tris`` (triangle j = vertices
3j..3j+2), active cubes in ascending flat order, each emitting its case's
triangles in table order, plus an ``overflow`` flag when either the
triangle or the active-cube capacity is exceeded. ``method="tets"``
triangulates each cube's 6 tetrahedra instead (about 3x the triangles of
the same surface, kept for cross-validation), with the same capacities
and slot order: cubes ascending, tets in order, each tet's triangles in
table order. The 8 corner values
(and a normal volume's 8 corner gradients) steer the within-edge
interpolation as bf16 (as the JAX kernel carries them), while
inside/outside decisions use the f32 values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from avatarcap_tpu_torch.device import device_constant
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.utils.timers import span

# Cube corner offsets, indexed 0..7 (x, y, z).
_CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)

# 6-tetrahedra decomposition sharing the main diagonal c0-c6.
_TETS = np.array([
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
    [0, 5, 1, 6],
], np.int32)


def _build_tet_tables():
    """Per-(tet, case) triangle tables: ntris (6, 16) and edges
    (6, 16, 2, 3, 2) cube-corner endpoint pairs, -1 padded."""
    ntris = np.zeros((6, 16), np.int32)
    edges = np.full((6, 16, 2, 3, 2), -1, np.int32)
    corner_pos = _CUBE_CORNERS.astype(np.float64)

    def orient(tri_pts, away_from):
        a, b, c = tri_pts
        n = np.cross(b - a, c - a)
        centroid = (a + b + c) / 3.0
        return np.dot(n, centroid - away_from) >= 0

    for t in range(6):
        tet = _TETS[t]
        pos = corner_pos[tet]
        for case in range(16):
            inside = [i for i in range(4) if case & (1 << i)]
            outside = [i for i in range(4) if not case & (1 << i)]
            tris = []
            if len(inside) == 1:
                a = inside[0]
                es = [(a, x) for x in outside]
                mids = [(pos[e[0]] + pos[e[1]]) / 2 for e in es]
                if not orient(mids, pos[a]):
                    es = [es[0], es[2], es[1]]
                tris.append(es)
            elif len(inside) == 2:
                a, b = inside
                c, d = outside
                quad = [(a, c), (a, d), (b, d), (b, c)]
                mids = [(pos[e0] + pos[e1]) / 2 for e0, e1 in quad]
                mid_in = (pos[a] + pos[b]) / 2
                t1 = [quad[0], quad[1], quad[2]]
                if not orient([mids[0], mids[1], mids[2]], mid_in):
                    t1 = [quad[0], quad[2], quad[1]]
                    t2 = [quad[0], quad[3], quad[2]]
                else:
                    t2 = [quad[0], quad[2], quad[3]]
                tris.append(t1)
                tris.append(t2)
            elif len(inside) == 3:
                a = outside[0]
                es = [(x, a) for x in inside]
                mids = [(pos[e[0]] + pos[e[1]]) / 2 for e in es]
                if orient(mids, pos[a]):
                    es = [es[0], es[2], es[1]]
                tris.append(es)
            ntris[t, case] = len(tris)
            for k, tri in enumerate(tris):
                for v, (e0, e1) in enumerate(tri):
                    edges[t, case, k, v, 0] = tet[e0]
                    edges[t, case, k, v, 1] = tet[e1]
    return ntris, edges


_NTRIS_TABLE, _EDGES_TABLE = _build_tet_tables()


def _build_mc256_tables():
    """256-case marching-cubes tables derived from the tet patches: per
    case, group the tet triangles into connected components, walk each
    boundary loop, drop the diagonal-edge vertices, orient the loop along
    -grad of the canonical (+-1) trilinear field and emit a fan.

    Returns ntris (256,) int32 and edges (256, E, 3, 2) int32 (-1 padded).
    """
    pos = _CUBE_CORNERS.astype(np.float64)

    def is_cube_edge(a, b):
        return int(np.sum(pos[a] != pos[b])) == 1

    all_tris_per_case = []
    for case in range(256):
        tris = []
        for t in range(6):
            tet = _TETS[t]
            tcase = sum(((case >> int(tet[i])) & 1) << i for i in range(4))
            for k in range(int(_NTRIS_TABLE[t, tcase])):
                tri = []
                for v in range(3):
                    e0, e1 = _EDGES_TABLE[t, tcase, k, v]
                    tri.append((min(int(e0), int(e1)),
                                max(int(e0), int(e1))))
                tris.append(tri)
        if not tris:
            all_tris_per_case.append([])
            continue

        vpos = {key: 0.5 * (pos[key[0]] + pos[key[1]])
                for tri in tris for key in tri}

        parent = list(range(len(tris)))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        side_map = {}
        for i, tri in enumerate(tris):
            for v in range(3):
                s = frozenset((tri[v], tri[(v + 1) % 3]))
                if len(s) < 2:
                    continue
                if s in side_map:
                    a, b = find(side_map[s]), find(i)
                    parent[a] = b
                else:
                    side_map[s] = i

        comps = {}
        for i in range(len(tris)):
            comps.setdefault(find(i), []).append(i)

        case_tris = []
        for members in comps.values():
            count = {}
            for i in members:
                tri = tris[i]
                for v in range(3):
                    s = frozenset((tri[v], tri[(v + 1) % 3]))
                    if len(s) == 2:
                        count[s] = count.get(s, 0) + 1
            nbr = {}
            for s, c in count.items():
                if c == 1:
                    a, b = tuple(s)
                    nbr.setdefault(a, []).append(b)
                    nbr.setdefault(b, []).append(a)
            assert all(len(v) == 2 for v in nbr.values()), \
                f"case {case}: non-manifold patch boundary"
            unvisited = set(nbr)
            loops = []
            while unvisited:
                start = next(iter(unvisited))
                loop = [start]
                prev, cur = None, start
                while True:
                    a, b = nbr[cur]
                    nxt = b if a == prev else a
                    if nxt == start:
                        break
                    loop.append(nxt)
                    prev, cur = cur, nxt
                unvisited -= set(loop)
                loops.append(loop)

            def grad_at(p):
                g = np.zeros(3)
                for c8 in range(8):
                    v = 1.0 if (case >> c8) & 1 else -1.0
                    w = [(pos[c8][d] * p[d] + (1 - pos[c8][d]) * (1 - p[d]))
                         for d in range(3)]
                    for d in range(3):
                        o = [w[0], w[1], w[2]]
                        o[d] = 2.0 * pos[c8][d] - 1.0
                        g[d] += v * o[0] * o[1] * o[2]
                return g

            for loop in loops:
                kept = [k for k in loop if is_cube_edge(*k)]
                assert len(kept) >= 3, f"case {case}: degenerate loop"
                centroid = np.mean([vpos[k] for k in kept], axis=0)
                ref = -grad_at(centroid)
                fan_n = np.zeros(3)
                for i in range(1, len(kept) - 1):
                    a, b, c = (vpos[kept[0]], vpos[kept[i]],
                               vpos[kept[i + 1]])
                    fan_n += np.cross(b - a, c - a)
                if np.dot(fan_n, ref) < 0:
                    kept.reverse()
                for i in range(1, len(kept) - 1):
                    case_tris.append([kept[0], kept[i], kept[i + 1]])
        all_tris_per_case.append(case_tris)

    E = max(len(t) for t in all_tris_per_case)
    ntris = np.array([len(t) for t in all_tris_per_case], np.int32)
    edges = np.full((256, E, 3, 2), -1, np.int32)
    for c, case_tris in enumerate(all_tris_per_case):
        for k, tri in enumerate(case_tris):
            for v, (e0, e1) in enumerate(tri):
                edges[c, k, v] = (e0, e1)
    return ntris, edges


_NTRIS256, _EDGES256 = _build_mc256_tables()
MC256_MAX_TRIS = int(_EDGES256.shape[1])


class Mesh(NamedTuple):
    """Fixed-capacity triangle soup; triangle i uses vertices 3i..3i+2."""

    vertices: torch.Tensor      # (3 * max_tris, 3) f32; padding = 0
    normals: torch.Tensor       # (3 * max_tris, 3) unit; padding = 0; None
    # without gradient_normals or a normal_volume
    num_tris: torch.Tensor      # () int32
    overflow: torch.Tensor      # () bool
    edge_ids: torch.Tensor = None  # (3 * max_tris,) int32 volume-edge keys


def marching_tets(volume: torch.Tensor, iso: float,
                  bounds_min: torch.Tensor, voxel_size: torch.Tensor,
                  max_tris: int = 1 << 20, max_active: int = 1 << 18,
                  normal_volume: torch.Tensor = None,
                  gradient_normals: bool = False,
                  with_edge_ids: bool = False,
                  method: str = "mc256") -> Mesh:
    """Extract the iso-surface of a dense (X, Y, Z) volume ("inside" is
    value > iso) with the 256-case tables (``method="mc256"``) or the
    6-tet split (``"tets"``). World vertex = index * voxel + bounds_min +
    0.5 voxel.

    normal_volume: optional (X, Y, Z, 3) gradient volume
      (ops/sobel.extract_normal_volume); Mesh.normals are then the outward
      unit interpolations of the two edge-node gradients of each emitted
      vertex, the gradients gathered for the active cubes only.
    gradient_normals: without a normal volume, Mesh.normals are the
      outward unit gradients of each cube's own trilinear interpolant at
      the emitted vertex; False (the default, as in the JAX function)
      leaves Mesh.normals None.

    with_edge_ids: also emit Mesh.edge_ids, the volume edge each soup
    vertex interpolates, (flat index of its lower node << 3) | axis code
    (4 x + 2 y + z of the edge's direction); -1 on slots past num_tris.
    Every slot on the same edge carries the same key.

    Under a tracer (utils/timers) the call is a span ``marching_tets``.
    """
    with span("marching_tets"):
        return _marching_tets(volume, iso, bounds_min, voxel_size, max_tris,
                              max_active, normal_volume, gradient_normals,
                              with_edge_ids, method)


def _marching_tets(volume, iso, bounds_min, voxel_size, max_tris, max_active,
                   normal_volume, gradient_normals, with_edge_ids,
                   method) -> Mesh:
    if method not in ("mc256", "tets"):
        raise ValueError(f"method={method!r}: 'mc256' or 'tets'")
    dev = volume.device
    X, Y, Z = volume.shape
    nx, ny, nz = X - 1, Y - 1, Z - 1

    v5 = volume[None, None]
    max8 = F.max_pool3d(v5, 2, stride=1)[0, 0]
    min8 = -F.max_pool3d(-v5, 2, stride=1)[0, 0]
    is_active = ((max8 > iso) & ~(min8 > iso)).reshape(-1)
    active_ids, n_active, active_valid = compact_mask_indices(is_active,
                                                              max_active)
    aid = active_ids.long()
    aix = aid // (ny * nz)
    aiy = (aid // nz) % ny
    aiz = aid % nz
    corners = device_constant(_CUBE_CORNERS, dev, torch.long)
    av = volume[aix[:, None] + corners[:, 0], aiy[:, None] + corners[:, 1],
                aiz[:, None] + corners[:, 2]]                     # (A, 8)
    inside = (av > iso).long()
    if method == "mc256":
        bits = device_constant([1 << i for i in range(8)], dev, torch.long)
        case8 = (inside * bits).sum(-1)                           # (A,)
        cube_counts = device_constant(_NTRIS256, dev, torch.long)[case8]
        cube_counts = torch.where(active_valid, cube_counts,
                                  torch.zeros_like(cube_counts))
    else:
        # per-tet case: bit i = the tet's corner i inside
        tets = device_constant(_TETS, dev, torch.long)            # (6, 4)
        bits4 = device_constant([1, 2, 4, 8], dev, torch.long)
        cases = (inside[:, tets] * bits4).sum(-1)                 # (A, 6)
        tcounts = device_constant(_NTRIS_TABLE, dev, torch.long)[
            torch.arange(6, device=dev), cases]                   # (A, 6)
        tcounts = torch.where(active_valid[:, None], tcounts,
                              torch.zeros_like(tcounts))
        cube_counts = tcounts.sum(-1)

    cube_cum = torch.cumsum(cube_counts, 0)
    total = cube_cum[-1]
    overflow = (total > max_tris) | (n_active > max_active)

    # source cube of every output slot: first cube whose cumulative count
    # passes the slot; r = the slot's triangle within that cube
    tri_j = torch.arange(max_tris, device=dev)
    cube_of = torch.searchsorted(cube_cum, tri_j, right=True).clamp_max(
        max_active - 1)
    r = tri_j - (cube_cum[cube_of] - cube_counts[cube_of])
    if method == "mc256":
        r = r.clamp(0, MC256_MAX_TRIS - 1)
        edges = device_constant(_EDGES256, dev, torch.long)[case8[cube_of],
                                                             r]
    else:
        # the slot's tet: the tets whose cumulative count it has passed;
        # k = its triangle within that tet
        pref = torch.cumsum(tcounts, -1)[cube_of]                 # (T, 6)
        tet_of = (r[:, None] >= pref).sum(-1).clamp_max(5)
        prev = torch.where(
            tet_of > 0,
            pref.gather(1, (tet_of - 1).clamp_min(0)[:, None])[:, 0],
            torch.zeros_like(tet_of))
        k_of = (r - prev).clamp(0, 1)
        case_t = cases[cube_of].gather(1, tet_of[:, None])[:, 0]
        edges = device_constant(_EDGES_TABLE, dev, torch.long)[
            tet_of, case_t, k_of]                                 # (T, 3, 2)
    ea = edges[..., 0].clamp_min(0)                               # (T, 3)
    eb = edges[..., 1].clamp_min(0)

    av_t = av.to(torch.bfloat16).float()[cube_of]                 # (T, 8)
    base = torch.stack([aix, aiy, aiz], -1).to(volume.dtype)[cube_of]
    cf = corners.to(volume.dtype)
    va = av_t.gather(1, ea)
    vb = av_t.gather(1, eb)
    pa = cf[ea]                                                   # (T, 3, 3)
    pb = cf[eb]
    denom = vb - va
    tt = (iso - va) / torch.where(denom.abs() < 1e-12,
                                  torch.ones_like(denom), denom)
    tt = tt.clamp(0.0, 1.0)
    q = pa + (pb - pa) * tt[..., None]
    p = base[:, None, :] + q
    world = p * voxel_size + bounds_min + 0.5 * voxel_size
    tri_valid = tri_j < total
    verts = torch.where(tri_valid[:, None, None], world,
                        torch.zeros_like(world))

    n = None
    if normal_volume is not None:
        # the 8 corner gradients of each active cube, as bf16 (their
        # direction error vanishes in the normalisation), then the two
        # edge nodes' of each emitted vertex, interpolated along the edge
        gv = normal_volume[aix[:, None] + corners[:, 0],
                           aiy[:, None] + corners[:, 1],
                           aiz[:, None] + corners[:, 2]]          # (A, 8, 3)
        gv_t = gv.to(torch.bfloat16).float()[cube_of]             # (T, 8, 3)
        na = gv_t.gather(1, ea[..., None].expand(-1, -1, 3))     # (T, 3, 3)
        nb = gv_t.gather(1, eb[..., None].expand(-1, -1, 3))
        n = na + (nb - na) * tt[..., None]
    elif gradient_normals:
        c000, c100, c110, c010, c001, c101, c111, c011 = (
            av_t[:, i:i + 1] for i in range(8))
        x, y, z = q[..., 0], q[..., 1], q[..., 2]
        gx = ((1 - y) * (1 - z) * (c100 - c000) + y * (1 - z) * (c110 - c010)
              + (1 - y) * z * (c101 - c001) + y * z * (c111 - c011))
        gy = ((1 - x) * (1 - z) * (c010 - c000) + x * (1 - z) * (c110 - c100)
              + (1 - x) * z * (c011 - c001) + x * z * (c111 - c101))
        gz = ((1 - x) * (1 - y) * (c001 - c000) + x * (1 - y) * (c101 - c100)
              + (1 - x) * y * (c011 - c010) + x * y * (c111 - c110))
        n = torch.stack([gx, gy, gz], -1) / voxel_size
    if n is not None:
        n = -n / n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        n = torch.where(tri_valid[:, None, None], n,
                        torch.zeros_like(n)).reshape(max_tris * 3, 3)

    edge_ids = None
    if with_edge_ids:
        na = (base[:, None, :] + pa).long()                      # (T, 3, 3)
        nb = (base[:, None, :] + pb).long()
        nmin = torch.minimum(na, nb)
        d = (nb != na).long()
        flat = (nmin[..., 0] * Y + nmin[..., 1]) * Z + nmin[..., 2]
        key = (flat << 3) | (d[..., 0] * 4 + d[..., 1] * 2 + d[..., 2])
        edge_ids = torch.where(tri_valid[:, None], key,
                               torch.full_like(key, -1)).reshape(
                                   max_tris * 3).to(torch.int32)

    return Mesh(vertices=verts.reshape(max_tris * 3, 3), normals=n,
                num_tris=torch.clamp(total, max=max_tris).to(torch.int32),
                overflow=overflow, edge_ids=edge_ids)


def mesh_grid_coords(vertices: torch.Tensor,
                     bounds: torch.Tensor) -> torch.Tensor:
    """World vertices -> [-1, 1] normalised volume coordinates (x, y, z)
    over ``bounds`` (2, 3) (reference utils/recon_util.py:66)."""
    return 2.0 * (vertices - bounds[0]) / (bounds[1] - bounds[0]) - 1.0
