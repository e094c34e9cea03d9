"""Frozen copy, the reference's rasterizer and lift, at commit 2621afd:
avatarcap_tpu_torch/render/raster.py (whole), render/camera.py
(``_rot_y``, ``gl_orthographic_projection_matrix``,
``cano_front_back_mvp``, ``gl_perspective_projection_matrix``),
render/visualize.py (``transform_tris``, ``cano_index_passes``) and
fusion/normal_fusion.py (``lift_image_normals``).

Static-capacity software rasterizer: a K x K candidate window anchored at
the ceil of each triangle's pixel-space bbox min; edge-function coverage
with a -1e-6 barycentric slack; z-resolve by scatter-min of depth, then
of the candidate id among depth winners (ties go to the lowest id);
triangles larger than the window take an exact per-pixel pass. Image row
0 is the top (y_ndc = +1), column 0 the left; counter-clockwise in GL
window space is front-facing.
"""


from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.compaction import compact_mask_indices
from benchmark.reference.skinning import mats16_inv_rotate

_INT_MAX = torch.iinfo(torch.int32).max


class RasterOutput(NamedTuple):
    attrs: torch.Tensor     # (H, W, A) interpolated attributes (bg 0)
    depth: torch.Tensor     # (H, W) NDC depth, +inf where empty
    mask: torch.Tensor      # (H, W) bool coverage
    overflow: torch.Tensor  # () bool: candidates or big tris were dropped


class RasterIndex(NamedTuple):
    """Visibility buffer: per-pixel winning triangle + weights."""

    tri: torch.Tensor       # (H*W,) int64 winner triangle (0 where empty)
    bw: torch.Tensor        # (H*W, 3) vertex weights
    depth: torch.Tensor     # (H, W) NDC depth, +inf where empty
    mask: torch.Tensor      # (H, W) bool coverage
    overflow: torch.Tensor  # () bool
    n_candidates: torch.Tensor = None  # () covered candidates before the cut
    n_big: torch.Tensor = None         # () triangles routed to the big pass


def interpolate(ri: RasterIndex, attrs: torch.Tensor,
                covered_capacity: int = 0):
    """Interpolate per-vertex attrs (T, 3, A) at a RasterIndex's pixels
    (background 0). covered_capacity > 0 gathers only at covered pixels,
    compacted to that capacity. Returns (image (H, W, A), () overflow of
    that capacity) -- the JAX ``with_overflow=True`` form.
    """
    H, W = ri.mask.shape
    A = attrs.shape[-1]
    if covered_capacity > 0:
        P = H * W
        pix, n_cov, live = compact_mask_indices(ri.mask.reshape(-1),
                                                covered_capacity)
        pix = pix.long()
        at = attrs[ri.tri[pix]]                              # (C, 3, A)
        out_c = (at * ri.bw[pix][..., None]).sum(1)
        out = out_c.new_zeros((P + 1, A))
        out[torch.where(live, pix, torch.full_like(pix, P))] = out_c
        return out[:P].reshape(H, W, A), n_cov > covered_capacity
    out = (attrs[ri.tri] * ri.bw[..., None]).sum(1)
    out = torch.where(ri.mask.reshape(-1)[:, None], out,
                      torch.zeros_like(out))
    return (out.reshape(H, W, A),
            torch.zeros((), dtype=torch.bool, device=out.device))


def _perspective_weights(w0, w1, iw_tri):
    w2 = 1.0 - w0 - w1
    bw = torch.stack([w0 * iw_tri[..., 0], w1 * iw_tri[..., 1],
                      w2 * iw_tri[..., 2]], dim=-1)
    denom = bw.sum(-1, keepdim=True)
    return bw / torch.where(denom.abs() < 1e-12, torch.ones_like(denom),
                            denom)


def _safe_div_den(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a.abs() < 1e-12, torch.ones_like(a), a)


def _big_triangle_pass(px, py, pz, iw, area2, is_big, capacity, height,
                       width):
    """Exact coverage for <= capacity oversized triangles: every pixel
    tests each of them and keeps the min-depth winner (first on ties).
    Returns flat (P,) winner tri ids, (P, 3) weights, (P,) depth (+inf
    empty), (P,) mask and the () capacity overflow."""
    dev = px.device
    idx, n_big, live = compact_mask_indices(is_big, capacity)
    idx = idx.long()
    bpx, bpy, bpz = px[idx], py[idx], pz[idx]                # (C, 3)
    biw = iw[idx]
    barea = area2[idx]

    fy, fx = torch.meshgrid(torch.arange(height, dtype=px.dtype, device=dev),
                            torch.arange(width, dtype=px.dtype, device=dev),
                            indexing="ij")
    fx = fx.reshape(-1)
    fy = fy.reshape(-1)
    eps = -1e-6

    def cover_z(w0, w1, z0, z1, z2, alive):
        w2 = 1.0 - w0 - w1
        covered = (w0 >= eps) & (w1 >= eps) & (w2 >= eps) & alive
        z = w0 * z0 + w1 * z1 + w2 * z2
        covered = covered & (z >= -1.0) & (z <= 1.0)
        return covered, z

    ax, ay = bpx[:, 0:1], bpy[:, 0:1]
    bx, by = bpx[:, 1:2], bpy[:, 1:2]
    cx, cy = bpx[:, 2:3], bpy[:, 2:3]
    inv_area = 1.0 / _safe_div_den(barea)[:, None]
    w0 = ((cx - bx) * (fy[None] - by) - (cy - by) * (fx[None] - bx)) \
        * inv_area                                           # (C, P)
    w1 = ((ax - cx) * (fy[None] - cy) - (ay - cy) * (fx[None] - cx)) \
        * inv_area
    covered, z = cover_z(w0, w1, bpz[:, 0:1], bpz[:, 1:2], bpz[:, 2:3],
                         live[:, None])
    zm = torch.where(covered, z, torch.full_like(z, float("inf")))
    best = torch.argmin(zm, dim=0)                           # (P,)

    table = torch.cat([bpx, bpy, bpz, biw, barea[:, None],
                       idx.to(px.dtype)[:, None],
                       live.to(px.dtype)[:, None]], dim=-1)   # (C, 16)
    rows = table[best]
    rax, ray = rows[:, 0], rows[:, 3]
    rbx, rby = rows[:, 1], rows[:, 4]
    rcx, rcy = rows[:, 2], rows[:, 5]
    rz = rows[:, 6:9]
    riw = rows[:, 9:12]
    rinv = 1.0 / _safe_div_den(rows[:, 12])
    rtri = rows[:, 13]
    rlive = rows[:, 14] > 0.5
    w0b = ((rcx - rbx) * (fy - rby) - (rcy - rby) * (fx - rbx)) * rinv
    w1b = ((rax - rcx) * (fy - rcy) - (ray - rcy) * (fx - rcx)) * rinv
    mask, zbest = cover_z(w0b, w1b, rz[:, 0], rz[:, 1], rz[:, 2], rlive)
    bw = _perspective_weights(w0b, w1b, riw)
    tri = torch.where(mask, rtri.long(), torch.zeros_like(rtri.long()))
    return (tri, bw, torch.where(mask, zbest, torch.full_like(zbest,
                                                              float("inf"))),
            mask, n_big > capacity)


def _screen_setup(clip: torch.Tensor, valid_tris: torch.Tensor,
                  height: int, width: int):
    """Per-triangle set-up shared by the single and the pair pass: pad to
    a power-of-two triangle count Tp (a candidate id is slot * Tp + tri,
    so its triangle is an AND), divide by w, map to pixel space and take
    the signed pixel-space area (counter-clockwise in GL window space is
    negative here). Returns (Tp, w_safe, px, py, pz, area2, w_ok)."""
    T = clip.shape[0]
    Tp = 1 << max(T - 1, 1).bit_length()
    if Tp != T:
        clip = torch.cat([clip, clip.new_zeros((Tp - T, 3, 4))])
        valid_tris = torch.cat([valid_tris,
                                valid_tris.new_zeros((Tp - T,))])
    w = clip[..., 3]
    w_ok = (w > 1e-8).all(-1) & valid_tris
    w_safe = torch.where(w.abs() < 1e-8, torch.ones_like(w), w)
    ndc = clip[..., :3] / w_safe[..., None]
    px = (ndc[..., 0] + 1.0) * (0.5 * width) - 0.5           # (Tp, 3)
    py = (1.0 - ndc[..., 1]) * (0.5 * height) - 0.5
    pz = ndc[..., 2]
    ax, ay = px[:, 0], py[:, 0]
    bx, by = px[:, 1], py[:, 1]
    cx, cy = px[:, 2], py[:, 2]
    area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    return Tp, w_safe, px, py, pz, area2, w_ok


def _candidates(px, py, pz_sel, area2, tri_ok, K: int, big_tri_capacity: int,
                height: int, width: int):
    """Dense (K*K, Tp) candidate window anchored at the ceil of each
    triangle's bbox min: edge-function coverage with the -1e-6 slack and
    depth interpolated from the per-vertex ``pz_sel``. Triangles larger
    than the window are ``is_big`` (and leave this pass when the big pass
    is on). Returns (is_big, cx_d, cy_d, w0_d, w1_d, z_d, ok_d)."""
    dev = px.device
    ax, ay = px[:, 0], py[:, 0]
    bx, by = px[:, 1], py[:, 1]
    cx, cy = px[:, 2], py[:, 2]
    min_x = torch.ceil(px.min(-1).values).long()
    min_y = torch.ceil(py.min(-1).values).long()
    too_big = ((px.max(-1).values > min_x.to(px.dtype) + (K - 1))
               | (py.max(-1).values > min_y.to(py.dtype) + (K - 1)))
    is_big = tri_ok & too_big
    tri_main = tri_ok & ~is_big if big_tri_capacity > 0 else tri_ok

    slot = torch.arange(K * K, device=dev)
    cy_d = min_y[None, :] + (slot // K)[:, None]             # (K*K, Tp)
    cx_d = min_x[None, :] + (slot % K)[:, None]
    in_img = (cx_d >= 0) & (cx_d < width) & (cy_d >= 0) & (cy_d < height)
    fx_d = cx_d.to(px.dtype)
    fy_d = cy_d.to(py.dtype)
    eps = -1e-6
    inv_area = 1.0 / _safe_div_den(area2)
    w0_d = ((cx - bx)[None, :] * (fy_d - by[None, :])
            - (cy - by)[None, :] * (fx_d - bx[None, :])) * inv_area[None, :]
    w1_d = ((ax - cx)[None, :] * (fy_d - cy[None, :])
            - (ay - cy)[None, :] * (fx_d - cx[None, :])) * inv_area[None, :]
    w2_d = 1.0 - w0_d - w1_d
    z_d = (w0_d * pz_sel[None, :, 0] + w1_d * pz_sel[None, :, 1]
           + w2_d * pz_sel[None, :, 2])
    ok_d = ((w0_d >= eps) & (w1_d >= eps) & (w2_d >= eps) & in_img
            & (z_d >= -1.0) & (z_d <= 1.0) & tri_main[None, :])
    return is_big, cx_d, cy_d, w0_d, w1_d, z_d, ok_d


def _resolve(pix: torch.Tensor, valid: torch.Tensor, z: torch.Tensor,
             n_slots: int, max_c: int):
    """Compact the covered candidates to ``max_c`` and z-resolve them into
    ``n_slots`` pixels: scatter-min of depth, then scatter-min of the
    candidate id among the depth winners. Returns (winner ids (n_slots
    + 1,), INT_MAX where empty; depth buffer; overflow; covered count)."""
    dev = pix.device
    cand_of, n_covered, c_live = compact_mask_indices(valid, max_c)
    cand_of = cand_of.long()
    pix_c = torch.where(c_live, pix[cand_of],
                        torch.full_like(cand_of, n_slots))
    inf = float("inf")
    z_c = torch.where(c_live, z[cand_of], torch.full_like(z[cand_of], inf))
    zbuf = torch.full((n_slots + 1,), inf, dtype=z_c.dtype, device=dev)
    zbuf = zbuf.scatter_reduce(0, pix_c, z_c, reduce="amin")
    is_winner = (z_c == zbuf[pix_c]) & (z_c < inf)
    win_ids = torch.where(is_winner, cand_of,
                          torch.full_like(cand_of, _INT_MAX))
    winner = torch.full((n_slots + 1,), _INT_MAX, dtype=torch.int64,
                        device=dev)
    winner = winner.scatter_reduce(0, pix_c, win_ids, reduce="amin")
    return winner, zbuf, n_covered > max_c, n_covered


def _merge_big(tri_of, bw, depth, mask, px, py, pz, iw, area2, is_big,
               capacity, height, width):
    """Run the exact big-triangle pass and merge it by depth (the windowed
    pass wins exact ties). Returns (tri, bw, depth, mask, big overflow)."""
    (big_tri, big_bw, big_depth, big_mask,
     big_over) = _big_triangle_pass(px, py, pz, iw, area2, is_big, capacity,
                                    height, width)
    take_big = big_mask & (big_depth < depth)
    return (torch.where(take_big, big_tri, tri_of),
            torch.where(take_big[:, None], big_bw, bw),
            torch.where(take_big, big_depth, depth), mask | big_mask,
            big_over)


def rasterize_index(clip_verts: torch.Tensor, valid_tris: torch.Tensor,
                    height: int, width: int, window: int = 4,
                    max_candidates: int = 0,
                    big_tri_capacity: int = 0) -> RasterIndex:
    """One index pass with perspective-correct weights and back faces
    culled (the live position pass of normal fusion).

    Args:
      clip_verts: (T, 3, 4) clip-space vertices (x, y, z, w); vertices
        with w <= 1e-8 drop their triangle.
      valid_tris: (T,) bool.
      max_candidates: covered-candidate capacity (default max(T, 65536)).
      big_tri_capacity: exact-pass slots for triangles larger than the
        window; 0 disables the big pass.
    """
    T = clip_verts.shape[0]
    Tp, w_safe, px, py, pz, area2, w_ok = _screen_setup(
        clip_verts, valid_tris, height, width)
    tri_ok = w_ok & (area2 < -1e-12)      # counter-clockwise: front
    iw = 1.0 / w_safe
    is_big, cx_d, cy_d, w0_d, w1_d, z_d, ok_d = _candidates(
        px, py, pz, area2, tri_ok, window, big_tri_capacity, height, width)

    npix = height * width
    max_c = max_candidates if max_candidates > 0 else max(T, 1 << 16)
    winner, zbuf, overflow, n_covered = _resolve(
        (cy_d * width + cx_d).reshape(-1), ok_d.reshape(-1),
        z_d.reshape(-1), npix, max_c)
    wv = winner[:npix]
    mask = wv != _INT_MAX
    safe_winner = torch.where(mask, wv, torch.zeros_like(wv))
    tri_of = safe_winner & (Tp - 1)
    bw = _perspective_weights(w0_d.reshape(-1)[safe_winner],
                              w1_d.reshape(-1)[safe_winner], iw[tri_of])
    if 0 < max_c < npix:
        bw = torch.where(mask[:, None], bw, torch.zeros_like(bw))
    depth = torch.where(mask, zbuf[:npix],
                        torch.full_like(zbuf[:npix], float("inf")))
    if big_tri_capacity > 0:
        tri_of, bw, depth, mask, big_over = _merge_big(
            tri_of, bw, depth, mask, px, py, pz, iw, area2, is_big,
            big_tri_capacity, height, width)
        overflow = overflow | big_over
    else:
        overflow = overflow | is_big.any()
    return RasterIndex(tri=tri_of, bw=bw, depth=depth.reshape(height, width),
                       mask=mask.reshape(height, width), overflow=overflow,
                       n_candidates=n_covered,
                       n_big=is_big.sum().to(torch.int32))


def rasterize(clip_verts: torch.Tensor, attrs: torch.Tensor,
              valid_tris: torch.Tensor, height: int, width: int,
              window: int = 4, max_candidates: int = 0,
              big_tri_capacity: int = 0) -> RasterOutput:
    """Index pass + one interpolation of per-vertex attrs (T, 3, A),
    background 0; the masked interpolation runs at the candidate capacity
    and its overflow joins the pass's."""
    ri = rasterize_index(clip_verts, valid_tris, height, width,
                         window=window, max_candidates=max_candidates,
                         big_tri_capacity=big_tri_capacity)
    img, iovf = interpolate(ri, attrs, covered_capacity=max_candidates)
    return RasterOutput(attrs=img, depth=ri.depth, mask=ri.mask,
                        overflow=ri.overflow | iovf)


def rasterize_index_pair(clip_front: torch.Tensor, clip_back: torch.Tensor,
                         valid_tris: torch.Tensor, height: int, width: int,
                         window: int = 4, max_candidates: int = 0,
                         big_tri_capacity: int = 0):
    """Front + back index passes of a mirror-pair camera in one candidate
    sweep (the canonical ortho front/back views).

    Precondition (camera.cano_front_back_mvp): back NDC = (-x_f, y_f, z_b)
    with the same ortho projection, so the back pixel grid is the
    x-mirror of the front's and back-face culling routes every
    non-degenerate triangle to exactly one view. Back-routed candidates
    scatter at the mirrored column of a second buffer; outputs keep the
    convention of two separate passes (back buffer in back-view pixel
    coordinates, not pre-flipped).

    Args:
      clip_front, clip_back: (T, 3, 4) clip-space vertices (w == 1).
      valid_tris: (T,) bool.
    Returns:
      (front RasterIndex, back RasterIndex), both with the shared overflow.
    """
    T = clip_front.shape[0]
    Tp, w_safe, px, py, pz, area2, w_ok = _screen_setup(
        clip_front, valid_tris, height, width)
    if Tp != T:
        clip_back = torch.cat([clip_back,
                               clip_back.new_zeros((Tp - T, 3, 4))])
    pz_b = clip_back[..., 2] / w_safe
    side = area2 > 0.0                  # CW in the front view -> back
    tri_ok = w_ok & (area2.abs() > 1e-12)
    iw = 1.0 / w_safe
    pz_sel = torch.where(side[:, None], pz_b, pz)
    is_big, cx_d, cy_d, w0_d, w1_d, z_d, ok_d = _candidates(
        px, py, pz_sel, area2, tri_ok, window, big_tri_capacity, height,
        width)

    npix = height * width
    col_sel = torch.where(side[None, :], (width - 1) - cx_d, cx_d)
    pix_d = torch.where(side[None, :], npix, 0) + cy_d * width + col_sel
    max_c = max_candidates if max_candidates > 0 else max(2 * T, 1 << 17)
    winner, zbuf, overflow, n_covered = _resolve(
        pix_d.reshape(-1), ok_d.reshape(-1), z_d.reshape(-1), 2 * npix,
        max_c)
    w0_flat = w0_d.reshape(-1)
    w1_flat = w1_d.reshape(-1)

    outs = []
    for s in range(2):
        wv = winner[s * npix:(s + 1) * npix]
        mask = wv != _INT_MAX
        safe_winner = torch.where(mask, wv, torch.zeros_like(wv))
        tri_of = safe_winner & (Tp - 1)
        # ortho pair: w == 1, so the weights are the screen barycentrics
        w0_w = w0_flat[safe_winner]
        w1_w = w1_flat[safe_winner]
        bw = torch.stack([w0_w, w1_w, 1.0 - w0_w - w1_w], dim=-1)
        if 0 < max_c < npix:
            bw = torch.where(mask[:, None], bw, torch.zeros_like(bw))
        depth = torch.where(mask, zbuf[s * npix:(s + 1) * npix],
                            torch.full_like(mask, float("inf"),
                                            dtype=zbuf.dtype))
        if big_tri_capacity > 0:
            if s == 0:
                bpx, bpy, bpz = px, py, pz
                barea, bbig = area2, is_big & ~side
            else:
                bpx = (width - 1.0) - px
                bpy, bpz = py, pz_b
                barea, bbig = -area2, is_big & side
            tri_of, bw, depth, mask, big_over = _merge_big(
                tri_of, bw, depth, mask, bpx, bpy, bpz, iw, barea, bbig,
                big_tri_capacity, height, width)
            overflow = overflow | big_over
        else:
            overflow = overflow | is_big.any()

        outs.append(RasterIndex(
            tri=tri_of, bw=bw, depth=depth.reshape(height, width),
            mask=mask.reshape(height, width), overflow=overflow,
            n_candidates=n_covered,
            n_big=(is_big & (side if s else ~side)).sum().to(torch.int32)))
    return outs[0]._replace(overflow=overflow), \
        outs[1]._replace(overflow=overflow)


def transform_to_clip(vertices: torch.Tensor, mvp: torch.Tensor
                      ) -> torch.Tensor:
    """(N, 3) world vertices x a (4, 4) row-major MVP -> (N, 4) clip
    coordinates."""
    vh = torch.cat([vertices, torch.ones_like(vertices[..., :1])], -1)
    return torch.einsum("ij,nj->ni", mvp, vh)


def soup_to_tris(vertices: torch.Tensor, num_tris: torch.Tensor,
                 max_tris: int):
    """A marching-cubes soup (3T, 3) -> ((T, 3, 3) vertices, (T,) valid:
    the first ``num_tris``)."""
    valid = torch.arange(max_tris, device=vertices.device) < num_tris
    return vertices.reshape(max_tris, 3, 3), valid


def indexed_to_soup(vertices: torch.Tensor, faces: torch.Tensor
                    ) -> torch.Tensor:
    """Indexed mesh -> per-triangle vertices (F, 3, 3)."""
    return vertices[faces.long()]


# -- render/camera.py --------------------------------------------------

def _rot_y(angle):
    c, s = math.cos(angle), math.sin(angle)
    m = np.identity(4, np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def gl_orthographic_projection_matrix(far=-100.0, near=-0.1):
    """Unit-scale x/y ortho window."""
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0
    proj[1, 1] = 1.0
    proj[2, 2] = 2 / (far - near)
    proj[2, 3] = -(far + near) / (far - near)
    proj[3, 3] = 1.0
    return proj


def cano_front_back_mvp(mesh_center: np.ndarray):
    """Front/back orthographic canonical (mvp, mv) pairs:
    returns (front_mvp, front_mv, back_mvp, back_mv)."""
    proj = gl_orthographic_projection_matrix()
    front_mv = np.identity(4, np.float32)
    front_mv[:3, 3] = -mesh_center
    front_mv[2, 3] -= 10

    trans_cen = np.identity(4, np.float32)
    trans_cen[:3, 3] = -mesh_center
    trans_z = np.identity(4, np.float32)
    trans_z[2, 3] = -10
    back_mv = trans_z @ _rot_y(math.pi) @ trans_cen
    return proj @ front_mv, front_mv, proj @ back_mv, back_mv


def gl_perspective_projection_matrix(fx, fy, cx, cy, img_w, img_h,
                                     far=100.0, near=0.1, gl_space=False):
    """Perspective projection of a pinhole camera; by default the model is
    in real camera space (+z forward, y down)."""
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 2 * fx / img_w
    proj[0, 2] = (2 * cx - img_w) / img_w
    proj[1, 1] = -2 * fy / img_h
    proj[1, 2] = (img_h - 2 * cy) / img_h
    proj[2, 2] = (far + near) / (far - near)
    proj[2, 3] = 2 * near * far / (near - far)
    proj[3, 2] = 1.0
    if gl_space:
        real2gl = np.identity(4, np.float32)
        real2gl[1, 1] = -1
        real2gl[2, 2] = -1
        proj = proj @ real2gl
    return proj


# -- render/visualize.py -----------------------------------------------

def transform_tris(tris: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) world triangle vertices x row-major (4, 4) -> (T, 3, 4)."""
    vh = torch.cat([tris, torch.ones_like(tris[..., :1])], dim=-1)
    return torch.einsum("ij,tvj->tvi", mvp, vh)


def cano_index_passes(tris: torch.Tensor, valid: torch.Tensor,
                      front_mvp: torch.Tensor, back_mvp: torch.Tensor,
                      res: int = 512, window: int = 4, big_tris: int = 0,
                      max_candidates: int = 0
                      ) -> Tuple[RasterIndex, RasterIndex]:
    """Front + back orthographic visibility buffers of the canonical mesh
    in one merged candidate pass (the matrices must be the mirror pair of
    camera.cano_front_back_mvp)."""
    return rasterize_index_pair(
        transform_tris(tris, front_mvp), transform_tris(tris, back_mvp),
        valid, res, res, window=window, big_tri_capacity=big_tris,
        max_candidates=max_candidates)


# -- fusion/normal_fusion.py -------------------------------------------

def lift_image_normals(live_tris: torch.Tensor, valid_tris: torch.Tensor,
                       normal_map: torch.Tensor, vert_mats16: torch.Tensor,
                       mv: torch.Tensor, proj: torch.Tensor,
                       fx: float, fy: float, cx: float, cy: float,
                       img_h: int, img_w: int, window: int = 4,
                       big_tris: int = 0, max_candidates: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image-space normals -> per-soup-vertex canonical normals.

    Args:
      live_tris: (T, 3, 3) live-space triangle soup; valid_tris: (T,).
      normal_map: (img_h, img_w, 3) image normals (camera convention).
      vert_mats16: (3T, 16) flat per-vertex cano->live skinning mats.
      mv: (4, 4) world -> camera; proj: (4, 4) perspective projection.
    Returns:
      ((T, 3, 3) canonical normals, 0 where invisible or invalid; () bool
      overflow of the position pass).
    """
    T = live_tris.shape[0]
    verts = live_tris.reshape(-1, 3)

    # live position pass
    mvp = proj @ mv
    vh = torch.cat([live_tris, torch.ones_like(live_tris[..., :1])], dim=-1)
    clip = torch.einsum("ij,tvj->tvi", mvp, vh)
    pos_pass = rasterize(clip, live_tris, valid_tris, img_h, img_w,
                         window=window, big_tri_capacity=big_tris,
                         max_candidates=max_candidates)

    # project the vertices; visible where the position buffer agrees.
    # Nearest sample (align_corners=True, border clamp) of both maps in one
    # 6-channel row gather.
    cam = torch.einsum("ij,nj->ni", mv[:3, :3], verts) + mv[:3, 3]
    gx = 2.0 * ((cam[:, 0] / cam[:, 2] * fx + cx) / img_w) - 1.0
    gy = 2.0 * ((cam[:, 1] / cam[:, 2] * fy + cy) / img_h) - 1.0
    xpix = torch.round((gx + 1.0) * 0.5 * (img_w - 1)).to(torch.int64)
    ypix = torch.round((gy + 1.0) * 0.5 * (img_h - 1)).to(torch.int64)
    xpix = xpix.clamp(0, img_w - 1)
    ypix = ypix.clamp(0, img_h - 1)
    both = torch.cat([pos_pass.attrs, normal_map], dim=-1).reshape(-1, 6)
    rows = both[ypix * img_w + xpix]                       # (3T, 6)
    proj_v, proj_n = rows[:, :3], rows[:, 3:]
    vis = (verts - proj_v).norm(dim=-1) < 0.05
    valid = vis & (proj_n.norm(dim=-1) > 1e-6)

    # canonicalize: flip y/z, undo the view rotation, then each vertex's
    # skinning rotation (closed-form inverse on the flat mats)
    proj_n = torch.stack([proj_n[:, 0], -proj_n[:, 1], -proj_n[:, 2]], -1)
    # inv_ex: inv would read its error flag back to the host
    inv_mv_r = torch.linalg.inv_ex(mv)[0][:3, :3]
    proj_n = torch.einsum("ij,nj->ni", inv_mv_r, proj_n)
    proj_n = mats16_inv_rotate(vert_mats16, proj_n)
    proj_n = torch.where(valid[:, None], proj_n, torch.zeros_like(proj_n))
    return proj_n.reshape(T, 3, 3), pos_pass.overflow
