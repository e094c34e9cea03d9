"""Capture frame (counterpart of avatarcap_tpu/pipeline/capture.py), in
the order of its ``frame_body``.

Per frame: U-Net pose features -> coarse-to-fine canonical occupancy
through kernel K1 (or the f32 module path) -> marching cubes with
trilinear-gradient normals (or Sobel normals: ``normal_mode`` "mc_edge"
or "sobel_sample") -> volume-LBS skinning to live space. With
``w_recon`` (the production frame): the image normals are lifted onto the
mesh from the capture camera, the canonical front/back index passes
interpolate them with the avatar normals and the Phong preview from one
18-channel table, the front normals are merged by the two-phase
optimisation, ReconNet (HGFilter features + coarse-to-fine pixel-aligned
occupancy through kernel K2, or the f32 decoder) gives a second mesh, and
that mesh is skinned too. With ``w_nerf``: NeRF vertex colors, one
64-sample color ray along -normal per unique vertex of the avatar soup
(kernel K3, or the f32 module path), and for the ReconNet mesh either its
own rays (``recon_color_mode="direct"``) or a nearest-neighbour transfer
from the avatar's colors. The stage functions keep the JAX stages' static
capacities, ascending compaction order and the aggregate ``overflow``
bit, so meshes and colors compare slot for slot with the JAX frame.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avatarcap_tpu_torch.body.skinning import (
    blend_joint_mats16, build_skin_weight_volume, mats16_apply_points,
    mats16_rotate, skin_points_by_volume)
from avatarcap_tpu_torch.device import (device_constant, resolve_device,
                                        to_device)
from avatarcap_tpu_torch.fusion.normal_fusion import (
    lift_image_normals, merge_normal_images, merge_normal_images_cover)
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.recon import ReconNetwork
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.ops.fused_query import (pack_recon_weights,
                                                 ray_color_query,
                                                 recon_decode,
                                                 warp_template_query)
from avatarcap_tpu_torch.ops.grid_sample import sample_feature_map_at_points
from avatarcap_tpu_torch.ops.knn import (approx_lbs_weights, knn,
                                         near_distance_volume,
                                         sample_distance_volume)
from avatarcap_tpu_torch.ops.marching_cubes import (marching_tets,
                                                    mesh_grid_coords)
from avatarcap_tpu_torch.ops.sobel import (extract_normal_volume,
                                           sample_volume_normals)
from avatarcap_tpu_torch.ops.volume_render import linspace01
from avatarcap_tpu_torch.parallel.mesh import AXIS, canonical_device
from avatarcap_tpu_torch.pipeline.avatar import (
    NEAR_SMPL_DIST, AvatarStatics, FrameInputs, compute_pose_features,
    fused_occupancy, grid_pose_features, pack_fused_query_weights,
    query_occupancy, render_rays, stage)
from avatarcap_tpu_torch.render.camera import (
    cano_front_back_mvp, gl_perspective_projection_matrix, real2gl_matrix)
from avatarcap_tpu_torch.render.raster import interpolate
from avatarcap_tpu_torch.render.visualize import (cano_index_passes,
                                                  phong_shade,
                                                  render_live_mesh)
from avatarcap_tpu_torch.utils.timers import frame_span, live_rows


class CaptureGrid(NamedTuple):
    """Static per-subject canonical query grid; the optional tail fields
    hold the coarse level of the hierarchical query
    (``build_grid_hierarchy``)."""

    valid_pts: torch.Tensor      # (Nv_pad, 3) compacted near-body points
    valid_idx: torch.Tensor      # (Nv_pad,) flat grid indices (OOB = pad)
    prior_volume: torch.Tensor   # (X*Y*Z,) prior occupancy elsewhere
    vol_res: tuple               # (X, Y, Z)
    valid_mask: torch.Tensor = None  # (X*Y*Z,) bool near-body band
    c_pts: torch.Tensor = None       # (Nc_pad, 3) coarse band points
    c_idx: torch.Tensor = None       # (Nc_pad,) coarse flat indices
    c_fine_idx: torch.Tensor = None  # (Nc_pad,) same nodes' fine indices
    c_prior: torch.Tensor = None     # (Xc*Yc*Zc,) coarse prior
    c_res: tuple = None              # (Xc, Yc, Zc)
    c_count: int = None              # coarse band nodes (live rows of c_pts)

    def to(self, device) -> "CaptureGrid":
        return self._replace(**{
            k: torch.as_tensor(getattr(self, k)).to(device)
            for k in ("valid_pts", "valid_idx", "prior_volume", "valid_mask",
                      "c_pts", "c_idx", "c_fine_idx", "c_prior")
            if getattr(self, k) is not None})


class CaptureMesh(NamedTuple):
    vertices: torch.Tensor       # (3*max_tris, 3) triangle soup
    normals: torch.Tensor        # (3*max_tris, 3)
    num_tris: torch.Tensor       # ()
    valid: torch.Tensor          # (max_tris,) bool
    overflow: torch.Tensor = None  # () bool
    edge_ids: torch.Tensor = None  # (3*max_tris,) volume-edge keys
    # (ops/marching_cubes.Mesh.edge_ids), present on w_nerf frames whose
    # soup is deduped


@dataclasses.dataclass(frozen=True)
class CaptureOptions:
    """The JAX package's CaptureOptions, field for field (see
    avatarcap_tpu/pipeline/capture.py for each field's rationale).
    use_fused_query runs K1 and K2 for the grid queries, and K1 or K3 for
    the NeRF colors (K3 for nerf_feat_mode="lerp" with
    near_flag_mode="ray"); the kernels take avatars of the (10, 0)
    positional encodings only, and AvatarCapture raises for others."""

    iso_value: float = 0.0
    max_tris: int = 1 << 20
    max_active: int = (1 << 18) + (1 << 17)
    recon_max_tris: int = 0
    recon_max_active: int = 0
    render_res: int = 512
    raster_window: int = 4
    cano_window: int = 3
    cano_big_tris: int = 64
    live_big_tris: int = 128
    raster_max_candidates: int = 0
    fusion_iters: int = 100
    integrate_manner: str = "merge"
    n_samples: int = 64
    nerf_chunk: int = 16384
    nerf_unique_capacity: int = 0
    nerf_feat_mode: str = "lerp"
    near_flag_mode: str = "ray"
    near_flag_voxel: float = 0.025
    near_flag_anchors: int = 4
    recon_unique_capacity: int = 0
    recon_color_mode: str = "nn"
    use_fused_query: bool = True
    skinning_mode: str = "volume"
    skin_voxel: float = 0.01
    skin_row_group: int = 1
    normal_mode: str = "trilinear"
    hierarchical_query: bool = True
    hier_alpha: float = 1.0
    refine_capacity: int = 1 << 21
    recon_refine_capacity: int = 0


def build_grid_hierarchy(grid: CaptureGrid, cano_bounds: torch.Tensor,
                         pad_to: int = 8192) -> CaptureGrid:
    """Derive the coarse level of the hierarchical query: coarse node
    (i, j, k) is fine node (2i, 2j, 2k). One host readback (the coarse
    band count) sizes the static compaction, padded to ``pad_to``."""
    X, Y, Z = grid.vol_res
    Xc, Yc, Zc = (X + 1) // 2, (Y + 1) // 2, (Z + 1) // 2
    dev = grid.prior_volume.device
    vidx = grid.valid_idx.long()
    valid_mask = torch.zeros(X * Y * Z + 1, dtype=torch.bool, device=dev)
    valid_mask[vidx.clamp(0, X * Y * Z)] = True      # pad slot is dropped
    valid_mask = valid_mask[:X * Y * Z]
    cmask = valid_mask.reshape(X, Y, Z)[::2, ::2, ::2]
    c_prior = grid.prior_volume.reshape(X, Y, Z)[::2, ::2, ::2].reshape(-1)

    n_c = int(cmask.sum())
    cap = n_c + ((-n_c) % pad_to)
    cidx, _, live = compact_mask_indices(cmask.reshape(-1), cap)
    cidx = cidx.long()
    ci = cidx // (Yc * Zc)
    cj = (cidx // Zc) % Yc
    ck = cidx % Zc
    lo, hi = cano_bounds[0], cano_bounds[1]
    frac = torch.stack([(2 * ci) / (X - 1), (2 * cj) / (Y - 1),
                        (2 * ck) / (Z - 1)], dim=-1).to(torch.float32)
    c_pts = torch.where(live[:, None], lo + frac * (hi - lo),
                        torch.zeros((), device=dev))
    c_idx = torch.where(live, cidx, Xc * Yc * Zc).to(torch.int32)
    c_fine_idx = torch.where(live, ((2 * ci) * Y + 2 * cj) * Z + 2 * ck,
                             0).to(torch.int32)
    return grid._replace(valid_mask=valid_mask, c_pts=c_pts, c_idx=c_idx,
                         c_fine_idx=c_fine_idx, c_prior=c_prior,
                         c_res=(Xc, Yc, Zc), c_count=n_c)


def _upsample2(c: torch.Tensor, fine_res) -> torch.Tensor:
    """(Xc, Yc, Zc) -> (X, Y, Z) linear upsampling where coarse node i sits
    at fine node 2i (edge-clamped)."""
    out = c
    for axis, n_fine in enumerate(fine_res):
        a = out.movedim(axis, 0)
        b = torch.cat([a[1:], a[-1:]], dim=0)
        mid = 0.5 * (a + b)
        inter = torch.stack([a, mid], dim=1).reshape(
            (-1,) + tuple(a.shape[1:]))[:n_fine]
        out = inter.movedim(0, axis)
    return out


def _scatter_set(base: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """base.at[idx].set(values, mode="drop"): out-of-range indices drop."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,))])
    idx = idx.long()
    out[torch.where((idx >= 0) & (idx < n), idx,
                    torch.full_like(idx, n))] = values
    return out[:n]


def hierarchical_volume(value_fn, grid: CaptureGrid, cano_bounds, c_prior,
                        prior, iso: float, alpha: float,
                        refine_capacity: int, with_stats: bool = False):
    """Coarse-to-fine occupancy volume: evaluate the field on the 2x
    coarse lattice, then only at fine nodes of coarse cells whose
    saturation-clamped corner range comes within ``alpha`` x (local
    range) of the iso level.

    Args:
      value_fn: (pts (N, 3), fine_flat_idx (N,)) -> (N,) field values.
    Returns (vol_flat (X*Y*Z,), query_overflow ()[, n_refined]).

    Under a tracer (utils/timers), the kernel launches of each level count
    its live points (the coarse band's nodes, the refined nodes up to the
    capacity) through ``live_rows``.
    """
    g = grid
    X, Y, Z = g.vol_res
    dev = prior.device
    with live_rows(g.c_count):
        c_occ = value_fn(g.c_pts, g.c_fine_idx)
    cvol = _scatter_set(c_prior, g.c_idx, c_occ).reshape(g.c_res)
    c_band = g.c_idx < int(np.prod(g.c_res))
    sat = torch.where(c_band, (c_occ - iso).abs(),
                      torch.zeros_like(c_occ)).max()
    cact = torch.minimum(torch.maximum(cvol, iso - sat), iso + sat)
    mx = F.max_pool3d(cact[None, None], 2, stride=1)[0, 0]
    mn = -F.max_pool3d(-cact[None, None], 2, stride=1)[0, 0]
    rng8 = mx - mn
    act = (mx >= iso - alpha * rng8) & (mn <= iso + alpha * rng8)
    # coarse cell ci covers fine cells [2ci, 2ci+1]; edge cells beyond
    # the coarse lattice are conservatively active
    fa = act
    for axis in range(3):
        fa = fa.repeat_interleave(2, dim=axis)
    fa = F.pad(fa, (0, max(0, (Z - 1) - fa.shape[2]),
                    0, max(0, (Y - 1) - fa.shape[1]),
                    0, max(0, (X - 1) - fa.shape[0])),
               value=True)[:X - 1, :Y - 1, :Z - 1]
    # a node is refined iff it touches an active cell
    node = fa
    for axis in range(3):
        lo_pad = [0, 0, 0, 0, 0, 0]
        hi_pad = [0, 0, 0, 0, 0, 0]
        lo_pad[2 * (2 - axis)] = 1       # F.pad counts from the last dim
        hi_pad[2 * (2 - axis) + 1] = 1
        node = F.pad(node, lo_pad) | F.pad(node, hi_pad)
    node = node & g.valid_mask.reshape(X, Y, Z)

    r_cap = min(refine_capacity, X * Y * Z)
    ridx, n_r, live = compact_mask_indices(node.reshape(-1), r_cap)
    q_overflow = n_r > r_cap
    ridx = ridx.long()
    zi = ridx % Z
    col = ridx // Z
    yi = col % Y
    xi = col // Y
    lo, hi = cano_bounds[0], cano_bounds[1]
    frac = torch.stack([xi / (X - 1), yi / (Y - 1), zi / (Z - 1)],
                       dim=-1).to(torch.float32)
    rpts = torch.where(live[:, None], lo + frac * (hi - lo),
                       torch.zeros((), device=dev))
    with live_rows(n_r):
        r_occ = value_fn(rpts, torch.where(live, ridx,
                                           torch.zeros_like(ridx)))
    vol = _upsample2(cvol, (X, Y, Z)).reshape(-1)
    vol = _scatter_set(vol, torch.where(live, ridx,
                                        torch.full_like(ridx, X * Y * Z)),
                       r_occ)
    vol = torch.where(g.valid_mask, vol, prior)
    if with_stats:
        return vol, q_overflow, n_r
    return vol, q_overflow


def _knn_chunk(database: torch.Tensor) -> int:
    """Query chunk of a KNN against ``database`` that keeps its (chunk, M)
    distance tile at 2^26 floats."""
    return max(1, min(16384, (1 << 26) // max(1, database.shape[0])))


NORMAL_MODES = ("trilinear", "mc_edge", "sobel_sample")


def _extract_mesh(volume_flat, grid: CaptureGrid, bounds, iso, max_tris,
                  max_active, normal_mode: str = "trilinear",
                  with_edge_ids: bool = False):
    """Volume -> mesh and its normals (and the soup's volume-edge keys with
    ``with_edge_ids``; reference main.py:357-375). ``normal_mode``:
    "trilinear", the gradient of each cube's trilinear interpolant;
    "mc_edge", the Sobel node gradients interpolated along each emitted
    vertex's edge inside the extraction; "sobel_sample", the Sobel volume
    resampled trilinearly at every soup vertex, as the reference does
    (utils/recon_util.py:32-48)."""
    X, Y, Z = grid.vol_res
    vol = volume_flat.reshape(X, Y, Z)
    voxel = (bounds[1] - bounds[0]) / device_constant(
        [X, Y, Z], bounds.device, bounds.dtype)
    kw = dict(max_tris=max_tris, max_active=max_active,
              with_edge_ids=with_edge_ids)
    if normal_mode == "trilinear":
        mesh = marching_tets(vol, iso, bounds[0], voxel,
                             gradient_normals=True, **kw)
        normals = mesh.normals
    elif normal_mode == "mc_edge":
        mesh = marching_tets(vol, iso, bounds[0], voxel,
                             normal_volume=extract_normal_volume(vol, voxel),
                             **kw)
        normals = mesh.normals
    elif normal_mode == "sobel_sample":
        mesh = marching_tets(vol, iso, bounds[0], voxel, **kw)
        normals = sample_volume_normals(
            vol, voxel, mesh_grid_coords(mesh.vertices, bounds))
    else:
        raise ValueError(f"normal_mode={normal_mode!r}: one of "
                         f"{NORMAL_MODES}")
    valid = torch.arange(max_tris, device=vol.device) < mesh.num_tris
    return CaptureMesh(mesh.vertices, normals, mesh.num_tris, valid,
                       mesh.overflow, mesh.edge_ids)


def anchor_distances(ro: torch.Tensor, rd: torch.Tensor, near: float,
                     far: float, smpl_vertices: torch.Tensor,
                     n_anchors: int = 4) -> torch.Tensor:
    """Distance to the nearest body vertex at A uniform depth anchors,
    linspace(near, far, A), per ray: (R, 3) rays -> (R, A). The masking
    data of near_flag_mode="ray" (K3 interpolates it per sample)."""
    za = device_constant(np.linspace(near, far, n_anchors).astype(np.float32),
                         ro.device)
    pts = ro[:, None, :] + rd[:, None, :] * za[None, :, None]   # (R, A, 3)
    d2, _ = knn(pts.reshape(-1, 3), smpl_vertices, k=1, chunk=65536)
    return torch.sqrt(d2[:, 0]).reshape(ro.shape[0], n_anchors)


def anchored_near_flags(ro: torch.Tensor, rd: torch.Tensor, near: float,
                        far: float, n_samples: int,
                        smpl_vertices: torch.Tensor,
                        threshold: float = NEAR_SMPL_DIST,
                        n_anchors: int = 4) -> torch.Tensor:
    """Near-body flags of every sample (depths linspace(near, far, S)) of
    every ray, from the anchor distances interpolated linearly between the
    two bracketing anchors (the distance field is 1-Lipschitz, so the
    interpolation is within half an anchor gap). Returns (R, S) bool."""
    za = np.linspace(near, far, n_anchors).astype(np.float32)
    zs = np.linspace(near, far, n_samples).astype(np.float32)
    seg = np.clip(np.searchsorted(za, zs) - 1, 0, n_anchors - 2)
    w1 = (zs - za[seg]) / (za[seg + 1] - za[seg])
    W = np.zeros((n_samples, n_anchors), np.float32)
    W[np.arange(n_samples), seg] = 1.0 - w1
    W[np.arange(n_samples), seg + 1] = w1
    d = anchor_distances(ro, rd, near, far, smpl_vertices,
                         n_anchors=n_anchors)
    return d @ device_constant(W.T, d.device) < threshold


def _dedupe_soup(tri_valid: torch.Tensor, edge_ids: torch.Tensor,
                 capacity: int):
    """Group triangle-soup slots by their shared volume-edge vertex: a
    stable sort of the keys and a segment scan give each slot a dense
    unique index (first-seen order of the sorted keys), with no host
    readback.

    Args:
      tri_valid: (T,) bool; edge_ids: (3T,) keys (>= 0 where valid);
      capacity: the unique-vertex capacity U.
    Returns:
      rep (U,) one representative slot per unique vertex (the first of its
        group in sorted order; 0 past the populated ones), uo (3T,) each
        slot's unique index clamped into [0, U), valid_v (3T,) bool,
        valid_u (U,) bool, overflow () bool (more unique vertices than U),
        n_u () the populated unique vertices (min(unique, U)).
    """
    imax = torch.iinfo(torch.int32).max
    valid_v = tri_valid.repeat_interleave(3) & (edge_ids >= 0)
    ids = torch.where(valid_v, edge_ids.to(torch.int32),
                      torch.full_like(edge_ids, imax, dtype=torch.int32))
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    newf = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                      sid[1:] != sid[:-1]])
    seg = torch.cumsum(newf.long(), 0) - 1
    vsort = sid != imax
    n_unique = torch.where(vsort, seg + 1, torch.zeros_like(seg)).max()
    overflow = n_unique > capacity
    # out-of-range unique indices drop, as mode="drop" does
    first = newf & vsort & (seg < capacity)
    rep = torch.zeros(capacity + 1, dtype=torch.long, device=ids.device)
    rep[torch.where(first, seg, torch.full_like(seg, capacity))] = order
    uo = torch.empty_like(order)
    uo[order] = seg.clamp(max=capacity - 1)
    n_u = n_unique.clamp(max=capacity)
    valid_u = torch.arange(capacity, device=ids.device) < n_u
    return rep[:capacity], uo, valid_v, valid_u, overflow, n_u


class _Shard(NamedTuple):
    """What one mesh device needs to evaluate its slab of query points:
    the networks (f32 path) or packed weights (kernels) and the statics,
    on that device."""

    device: torch.device
    avatar: GeoTexAvatar
    recon: Optional[ReconNetwork]
    statics: AvatarStatics
    packed_query: Optional[dict]
    packed_recon: Optional[tuple]


def _on(device: torch.device):
    """Make ``device`` the current card (its current stream takes the
    kernels' launches); nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class AvatarCapture:
    """Per-frame capture orchestrator over plain stage functions.

    Args:
      avatar: the port's GeoTexAvatar (weights loaded; put in eval mode),
        SDF or occupancy (``options.iso_value`` is its level); with
        ``use_fused_query`` its encodings (and tex_avatar's) must be
        (10, 0), or the packing raises a ValueError: nothing falls back
        to the f32 path on its own.
      statics: AvatarStatics; grid: CaptureGrid (tensors or arrays).
      recon: the port's ReconNetwork, needed by ``w_recon=True`` frames.
      tex_avatar: an optional texture-finetuned GeoTexAvatar for the NeRF
        colors; None = the geometry avatar.
      device: None = the card (raises without one), or the first device of
        ``shard_mesh``; "cpu" runs the plain PyTorch path everywhere, with
        the kernels' plain versions.
      shard_mesh: optional mesh (parallel.mesh.make_mesh) whose devices
        each evaluate one slab of the points of the frame's two implicit
        grid queries (the avatar's and ReconNet's, coarse and refine
        levels): one frame's latency, not throughput, over several
        devices. Needs ``hierarchical_query``; every capacity the slabs
        split must divide by the mesh size. The capture lives on the first
        device, which gathers the slabs in order. Networks or packed
        weights (and their weight images) are copied to the other devices
        here; per frame, only the pose-feature columns (or feature maps)
        are. A device may repeat, e.g. ``[cuda:0, cuda:0]``.
      shard_axis: the mesh axis of the slabs; the port's meshes have the
        one axis "data".
    """

    def __init__(self, avatar: GeoTexAvatar, statics: AvatarStatics,
                 grid: CaptureGrid, recon: Optional[ReconNetwork] = None,
                 tex_avatar: Optional[GeoTexAvatar] = None,
                 options: CaptureOptions = CaptureOptions(), device=None,
                 shard_mesh=None, shard_axis: str = AXIS):
        o = options
        if o.normal_mode not in NORMAL_MODES:
            raise ValueError(f"normal_mode={o.normal_mode!r}: one of "
                             f"{NORMAL_MODES}")
        if shard_mesh is not None and device is None:
            device = shard_mesh[0]
        self.device = canonical_device(resolve_device(device))
        self.opt = o
        self.avatar = avatar.to(self.device).eval()
        self.tex_avatar = (tex_avatar.to(self.device).eval()
                           if tex_avatar is not None else self.avatar)
        self.recon = (recon.to(self.device).eval() if recon is not None
                      else None)
        self.statics = statics.to(self.device)
        grid = grid.to(self.device)
        if o.hierarchical_query and grid.c_idx is None:
            grid = build_grid_hierarchy(grid, self.statics.cano_bounds)
        self.grid = grid

        center = self.statics.cano_smpl_center.detach().cpu().numpy()
        fmvp, fmv, bmvp, bmv = cano_front_back_mvp(center)
        self._fmvp, self._fmv, self._bmvp, self._bmv = (
            torch.as_tensor(m, device=self.device)
            for m in (fmvp, fmv, bmvp, bmv))

        with torch.inference_mode():
            self.packed_query = (pack_fused_query_weights(self.avatar)
                                 if o.use_fused_query else None)
            # the color stages take packed_tex, falling back to
            # packed_query without a texture avatar
            self.packed_tex = (pack_fused_query_weights(self.tex_avatar)
                               if o.use_fused_query
                               and tex_avatar is not None else None)
            self.packed_recon = (
                pack_recon_weights(self.recon.image_decoder)
                if o.use_fused_query and self.recon is not None else None)
            if o.skinning_mode == "volume":
                self.skin_wvol = build_skin_weight_volume(
                    self.statics.cano_smpl_vertices,
                    self.statics.smpl_skinning_weights,
                    self.statics.cano_bounds, voxel=o.skin_voxel)
            else:
                self.skin_wvol = None
            # read only by the fused NeRF colors' chunked body
            self.near_d_vol = (
                near_distance_volume(self.statics.cano_smpl_vertices,
                                     self.statics.cano_bounds,
                                     voxel=o.near_flag_voxel)[0]
                if o.near_flag_mode == "volume" and o.use_fused_query
                else None)
        if o.skinning_mode == "volume" and o.skin_row_group > 1:
            # triangle-grouped rows are a bounded approximation only when
            # an extraction triangle fits within about one skinning cell
            span = (self.statics.cano_bounds[1]
                    - self.statics.cano_bounds[0]).detach().cpu().numpy()
            voxel = float(np.max(span.astype(np.float64)
                                 / (np.asarray(grid.vol_res) - 1)))
            if voxel > 1.5 * o.skin_voxel:
                raise ValueError(
                    f"skin_row_group={o.skin_row_group} needs the "
                    f"query-grid voxel ({voxel * 1000:.1f} mm) to be "
                    f"<= 1.5x skin_voxel ({o.skin_voxel * 1000:.1f} mm); "
                    "use skin_row_group=1 or a finer grid")
        self._neck_xys: Dict[int, tuple] = {}
        self._local = _Shard(self.device, self.avatar, self.recon,
                             self.statics, self.packed_query,
                             self.packed_recon)
        self.shard_mesh = None
        self._shards = None
        if shard_mesh is not None:
            self._init_shards(shard_mesh, shard_axis)

    def _init_shards(self, shard_mesh, shard_axis: str):
        """Check the mesh against the capacities the slabs split (JAX's
        three divisibility checks) and copy what each device needs."""
        o, g = self.opt, self.grid
        if shard_axis != AXIS:
            raise ValueError(f"the port's meshes have the one axis {AXIS!r}, "
                             f"got {shard_axis!r}")
        if not o.hierarchical_query:
            raise ValueError("point sharding wraps the hierarchical query's "
                             "value functions: it needs "
                             "hierarchical_query=True")
        mesh = tuple(canonical_device(d) for d in shard_mesh)
        if mesh[0] != self.device:
            raise ValueError(f"the capture lives on the mesh's first device "
                             f"{mesh[0]}, not on {self.device}")
        n_cells = int(np.prod(g.vol_res))
        for name, cap in (
                ("coarse capacity", g.c_pts.shape[0]),
                ("refine_capacity", min(o.refine_capacity, n_cells)),
                ("recon_refine_capacity",
                 min(o.recon_refine_capacity or o.refine_capacity,
                     n_cells))):
            if cap % len(mesh):
                raise ValueError(f"{name}={cap} must divide the "
                                 f"{len(mesh)}-way point shard")
        self.shard_mesh = mesh
        self._shards = [self._local if d == self.device else self._shard_on(d)
                        for d in mesh]

    def _shard_on(self, device: torch.device) -> _Shard:
        """Copies of the query networks (f32 path) or of their packed
        weights and weight images (kernels) on another mesh device."""
        from avatarcap_tpu_torch.ops import fused_query as fq
        fused = self.opt.use_fused_query

        def packed_copy(packed):
            return tuple(t.to(device) for t in packed)

        avatar = None if fused else copy.deepcopy(self.avatar).to(device)
        recon = (copy.deepcopy(self.recon).to(device)
                 if self.recon is not None and not fused else None)
        with torch.inference_mode(), _on(device):
            pq = ({**self.packed_query,
                   **{k: packed_copy(self.packed_query[k])
                      for k in ("offset", "template")}}
                  if fused else None)
            pr = (packed_copy(self.packed_recon)
                  if fused and self.packed_recon is not None else None)
            if device.type == "cuda" and fused:
                # the wrappers find these images in their cache
                fq._cached_weight_image(pq["offset"], pq["template"])
                if pr is not None:
                    fq._cached_recon_image(pr)
        return _Shard(device, avatar, recon, self.statics.to(device), pq, pr)

    def _sharded(self, make_vf, *frame_tensors):
        """A ``(pts (N, 3), fine_flat_idx (N,)) -> (N,)`` value function
        of the hierarchical query: ``make_vf(shard, *tensors)`` builds it on
        one device. Without a shard mesh, on the capture's device; with
        one, the points split into one contiguous slab per mesh device
        (each launched under that device, its frame tensors copied there
        once), and the slabs' values are gathered in order onto the first
        device."""
        if self._shards is None:
            return make_vf(self._local, *frame_tensors)
        parts = [(s.device, make_vf(s, *(t.to(s.device, non_blocking=True)
                                         for t in frame_tensors)))
                 for s in self._shards]

        def vf(pts, fidx):
            n = pts.shape[0] // len(parts)
            outs = []
            for i, (dev, f) in enumerate(parts):
                with _on(dev):
                    outs.append(f(pts[i * n:(i + 1) * n].to(
                        dev, non_blocking=True),
                        fidx[i * n:(i + 1) * n].to(dev, non_blocking=True)))
            return torch.cat([o.to(self.device, non_blocking=True)
                              for o in outs])
        return vf

    # -- stages --------------------------------------------------------

    def avatar_value_fn(self, feat: torch.Tensor):
        """The avatar's field on the pose features ``feat`` as the
        hierarchical query's ``(pts (N, 3), fine_flat_idx (N,)) -> (N,)``
        value function: K1 on the grid's bf16 pose-feature columns (an
        occupancy avatar's sigmoid after it), or the f32 module path; one
        slab per mesh device with a shard mesh."""
        o, g, st = self.opt, self.grid, self.statics
        Z = g.vol_res[2]
        if o.use_fused_query:
            pf_cols = grid_pose_features(feat, st, g.vol_res,
                                         dtype=torch.bfloat16, columns=True)

            def make_vf(shard, cols):
                spk = shard.packed_query

                def vf(pts, fidx):
                    return fused_occupancy(spk, warp_template_query(
                        spk["offset"], spk["template"], pts,
                        cols[fidx.long() // Z])["occ"][:, 0])
                return vf
            return self._sharded(make_vf, pf_cols)

        def make_vf_f32(shard, shard_feat):
            def vf(pts, fidx):
                out = query_occupancy(shard.avatar, pts[None], shard_feat,
                                      shard.statics)
                return out["cano_pts_ov"][0, :, 0]
            return vf
        return self._sharded(make_vf_f32, feat)

    def avatar_volume(self, feat: torch.Tensor):
        """The avatar's canonical occupancy over the grid on the pose
        features ``feat`` (1, H, W, C): coarse-to-fine through
        avatar_value_fn, or every near-body node at once. Returns (vol_flat
        (X*Y*Z,), query overflow () or None)."""
        o, g, st = self.opt, self.grid, self.statics
        if o.hierarchical_query:
            return hierarchical_volume(
                self.avatar_value_fn(feat), g, st.cano_bounds, g.c_prior,
                g.prior_volume, o.iso_value, o.hier_alpha, o.refine_capacity)
        if o.use_fused_query:
            pk = self.packed_query
            pf = grid_pose_features(feat, st, g.vol_res, g.valid_idx,
                                    dtype=torch.bfloat16)
            occ = fused_occupancy(pk, warp_template_query(
                pk["offset"], pk["template"], g.valid_pts, pf)["occ"][:, 0])
        else:
            occ = query_occupancy(self.avatar, g.valid_pts[None], feat,
                                  st)["cano_pts_ov"][0, :, 0]
        return _scatter_set(g.prior_volume, g.valid_idx, occ), None

    def avatar_geometry_stage(self, frame: FrameInputs,
                              want_edge_ids: bool = False):
        """Pose features -> canonical occupancy volume -> mesh (with its
        volume-edge keys when ``want_edge_ids`` and the NeRF colors are
        deduped). Returns (CaptureMesh, pose feature map (1, H, W, C))."""
        o = self.opt
        g = self.grid
        st = self.statics
        feat = compute_pose_features(self.avatar, frame.smpl_pos_map)
        vol, q_ovf = self.avatar_volume(feat)
        mesh = _extract_mesh(vol, g, st.cano_bounds, o.iso_value, o.max_tris,
                             o.max_active, o.normal_mode,
                             with_edge_ids=want_edge_ids
                             and o.nerf_unique_capacity > 0)
        if q_ovf is not None:
            mesh = mesh._replace(overflow=mesh.overflow | q_ovf)
        return mesh, feat

    def cano_layers_stage(self, mesh: CaptureMesh,
                          extra_tri_attrs: Optional[torch.Tensor] = None):
        """One front + one back index pass over the canonical mesh, then
        the avatar normals, the Phong preview of both sides and any extra
        per-triangle layer (the lifted image normals) from one 15- or
        18-channel attribute table. The back images are x-flipped.

        Returns (front RasterIndex, back RasterIndex, front normals,
        back normals, (front phong, back phong)), and with
        ``extra_tri_attrs`` (T, 3, 3) also its front and back images."""
        o = self.opt
        tris = mesh.vertices.reshape(-1, 3, 3)
        attr = mesh.normals.reshape(-1, 3, 3)
        fri, bri = cano_index_passes(
            tris, mesh.valid, self._fmvp, self._bmvp, res=o.render_res,
            window=o.cano_window, big_tris=o.cano_big_tris,
            max_candidates=o.raster_max_candidates)

        def cam_attrs(mv):
            cam_v = torch.einsum("ij,tvj->tvi", mv[:3, :3], tris) + mv[:3, 3]
            cam_n = torch.einsum("ij,tvj->tvi", mv[:3, :3], attr)
            cam_n = cam_n / cam_n.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            return cam_v, cam_n

        fv, fn = cam_attrs(self._fmv)
        bv, bn = cam_attrs(self._bmv)
        layers = [attr, fv, fn, bv, bn]
        if extra_tri_attrs is not None:
            layers.append(extra_tri_attrs)
        wide = torch.cat(layers, dim=-1)
        cc = o.raster_max_candidates
        f_out, f_iovf = interpolate(fri, wide, covered_capacity=cc)
        b_out, b_iovf = interpolate(bri, wide, covered_capacity=cc)
        b_out = b_out.flip(1)
        front_n = f_out[..., 0:3]
        back_n = b_out[..., 0:3]
        phong_f = torch.where(fri.mask[..., None],
                              phong_shade(f_out[..., 3:6], f_out[..., 6:9]),
                              torch.ones_like(f_out[..., 3:6]))
        phong_b = torch.where(bri.mask.flip(1)[..., None],
                              phong_shade(b_out[..., 9:12], b_out[..., 12:15]),
                              torch.ones_like(b_out[..., 9:12]))
        fri = fri._replace(overflow=fri.overflow | f_iovf | b_iovf)
        base = (fri, bri, front_n, back_n, (phong_f, phong_b))
        if extra_tri_attrs is not None:
            return base + (f_out[..., 15:18], b_out[..., 15:18])
        return base

    def skinning_stage(self, mesh: CaptureMesh, cano2live: torch.Tensor):
        """Canonical mesh -> live space. Returns (live CaptureMesh, flat
        (N, 16) per-vertex mats)."""
        o = self.opt
        st = self.statics
        if o.skinning_mode == "volume":
            live_v, pt_mats = skin_points_by_volume(
                mesh.vertices, self.skin_wvol, st.cano_bounds, cano2live,
                return_pt_mats=True, row_group=o.skin_row_group)
        else:
            lbs = approx_lbs_weights(mesh.vertices, st.cano_smpl_vertices,
                                     st.smpl_skinning_weights)
            pt_mats = blend_joint_mats16(lbs, cano2live)
            live_v = mats16_apply_points(pt_mats, mesh.vertices)
        live_n = mats16_rotate(pt_mats, mesh.normals)
        return CaptureMesh(live_v, live_n, mesh.num_tris, mesh.valid,
                           mesh.overflow), pt_mats

    def lift_normals_stage(self, live_mesh: CaptureMesh, valid: torch.Tensor,
                           pt_mats: torch.Tensor,
                           inferred_normal: torch.Tensor, w2c: torch.Tensor,
                           camera: Dict[str, float]):
        """Image normals lifted onto the canonical soup from the capture
        camera (intrinsics ``camera`` fx, fy, cx, cy; world -> camera
        ``w2c``). Returns ((T, 3, 3) canonical normals, () overflow)."""
        o = self.opt
        img_h, img_w = inferred_normal.shape[:2]
        fx, fy, cx, cy = (camera[k] for k in ("fx", "fy", "cx", "cy"))
        proj = self._projection(camera, img_h, img_w)
        return lift_image_normals(
            live_mesh.vertices.reshape(-1, 3, 3), valid, inferred_normal,
            pt_mats, w2c, proj, fx, fy, cx, cy, img_h, img_w,
            window=o.cano_window, big_tris=o.live_big_tris,
            max_candidates=o.raster_max_candidates)

    def recon_value_fn(self, feat_map: torch.Tensor, decode=recon_decode):
        """ReconNet's occupancy on the HGFilter feature map ``feat_map``
        (1, Hf, Wf, C) as the hierarchical query's value function: K2
        (``decode``, its wrapper; a caller may wrap it to see each launch's
        inputs) on [the grid's pose-feature columns, z], or the f32
        decoder; one slab per mesh device with a shard mesh."""
        o, g = self.opt, self.grid
        Z = g.vol_res[2]
        if o.use_fused_query:
            pf_cols = grid_pose_features(feat_map, self.statics, g.vol_res,
                                         columns=True)

            def make_vf(shard, cols):
                spk = shard.packed_recon
                sc = shard.statics.cano_smpl_center

                def vf(pts, fidx):
                    z = pts[:, 2:3] - sc[2]
                    return decode(spk, torch.cat([cols[fidx.long() // Z], z],
                                                 -1))
                return vf
            return self._sharded(make_vf, pf_cols)

        def make_vf_f32(shard, shard_feat_map):
            sc = shard.statics.cano_smpl_center

            def vf(pts, fidx):
                return shard.recon.decode_points(shard_feat_map, pts[None],
                                                 sc[None])[0]
            return vf
        return self._sharded(make_vf_f32, feat_map)

    def recon_volume(self, feat_map: torch.Tensor, decode=recon_decode):
        """ReconNet occupancy over the grid from the HGFilter feature map
        (1, Hf, Wf, C). The occupancy iso level is 0.5, so the [-1, 1]
        prior is rescaled to [0, 1].

        Args:
          decode: the fused path's (packed, feats (N, 33)) -> (N,) decoder,
            K2's wrapper (see recon_value_fn).
        Returns (vol_flat (X*Y*Z,), query overflow () or None).
        """
        o = self.opt
        g = self.grid
        st = self.statics
        prior01 = 0.5 * (g.prior_volume + 1.0)
        center = st.cano_smpl_center
        if not o.hierarchical_query:
            if o.use_fused_query:
                pf = grid_pose_features(feat_map, st, g.vol_res, g.valid_idx)
                z = g.valid_pts[:, 2:3] - center[2]
                occ = decode(self.packed_recon, torch.cat([pf, z], -1))
            else:
                occ = self.recon.decode_points(feat_map, g.valid_pts[None],
                                               center[None])[0]
            return _scatter_set(prior01, g.valid_idx, occ), None
        return hierarchical_volume(
            self.recon_value_fn(feat_map, decode), g, st.cano_bounds,
            0.5 * (g.c_prior + 1.0), prior01, 0.5, o.hier_alpha,
            o.recon_refine_capacity or o.refine_capacity)

    def recon_stage(self, front_normal: torch.Tensor,
                    back_normal: torch.Tensor, timer=None,
                    want_edge_ids: bool = False) -> CaptureMesh:
        """Fused front|back normals -> HGFilter features -> occupancy
        volume -> mesh (with its volume-edge keys when ``want_edge_ids``
        and the recon soup is deduped). ``timer`` (see process_frame) sees
        "hgfilter" and "recon_query_mc"."""
        o = self.opt
        with stage(timer, "hgfilter"):
            feat_map = self.recon.get_feat_maps(
                torch.cat([front_normal, back_normal], dim=-1)[None])
        with stage(timer, "recon_query_mc"):
            vol, q_ovf = self.recon_volume(feat_map)
            mesh = _extract_mesh(vol, self.grid, self.statics.cano_bounds,
                                 0.5, o.recon_max_tris or o.max_tris,
                                 o.recon_max_active or o.max_active,
                                 o.normal_mode, with_edge_ids=want_edge_ids
                                 and o.recon_unique_capacity > 0)
            if q_ovf is not None:
                mesh = mesh._replace(overflow=mesh.overflow | q_ovf)
        return mesh

    # -- NeRF vertex colors ----------------------------------------------

    def _nerf_ray_colors_chunked(self, feat: torch.Tensor, v: torch.Tensor,
                                 n: torch.Tensor) -> torch.Tensor:
        """One color ray per row of (v, n), origin v + n and direction -n
        over the depth band [0.98, 1.05], through render_rays (the f32
        module path of the texture avatar), nerf_chunk rays at a time.
        Returns (N, 3)."""
        o = self.opt
        out = []
        for c0 in range(0, v.shape[0], o.nerf_chunk):
            vv, nn_ = v[c0:c0 + o.nerf_chunk], n[c0:c0 + o.nerf_chunk]
            depth = torch.ones_like(vv[:, 0])[None]
            res = render_rays(self.tex_avatar, (vv + nn_)[None], -nn_[None],
                              depth - 0.05, depth + 0.05, depth, feat,
                              self.statics, n_samples=o.n_samples,
                              pts_space="cano", near_dist=0.02,
                              far_dist=0.05)
            out.append(res["rgb_map"][0])
        return torch.cat(out)

    def _nerf_ray_colors_fused(self, packed, feat: torch.Tensor,
                               v: torch.Tensor, n: torch.Tensor,
                               ray_query=ray_color_query,
                               live=None) -> torch.Tensor:
        """The same ray integral through the kernels. With
        nerf_feat_mode="lerp" and near_flag_mode="ray" the whole integral
        is one K3 launch (``ray_query``, K3's wrapper; a caller may wrap it
        to see the launch's inputs), whose leading ``live`` rays (a count,
        or None: all) a tracer counts live. Otherwise nerf_chunk rays at a time
        through K1 per sample, with the pose features lerped in bf16
        between the ray's ends ("lerp") or fetched per sample ("exact"),
        the near-body flag from the anchors ("ray"), the distance volume
        ("volume") or an exact KNN ("knn"), and the compositing written
        out. Returns (N, 3)."""
        o = self.opt
        st = self.statics
        U = v.shape[0]
        S = o.n_samples
        near, far = 1.0 - 0.02, 1.0 + 0.05               # depth-guided band
        t = linspace01(S, device=v.device)
        z = near * (1.0 - t) + far * t                     # (S,)
        dz = torch.cat([z[1:] - z[:-1], (z[-1] - z[-2])[None]])
        center = st.cano_smpl_center
        feat_nchw = feat.permute(0, 3, 1, 2)
        ro = v + n
        rd = -n
        lerp = o.nerf_feat_mode == "lerp"
        if lerp:
            ends = torch.cat([ro + rd * near, ro + rd * far])
            pf_ends = sample_feature_map_at_points(
                feat_nchw, (ends - center)[None])[0].to(torch.bfloat16)
            pf0, pf1 = pf_ends[:U], pf_ends[U:]
            if o.near_flag_mode == "ray":
                danch = anchor_distances(ro, rd, near, far,
                                         st.cano_smpl_vertices,
                                         n_anchors=o.near_flag_anchors)
                with live_rows(live):
                    return ray_query(packed["offset"], packed["template"],
                                     ro, rd, pf0, pf1, danch, st.cano_bounds,
                                     n_samples=S, near=near, far=far,
                                     threshold=NEAR_SMPL_DIST)
            w = ((z - near) / (far - near)).to(torch.bfloat16)
        out = []
        for c0 in range(0, U, o.nerf_chunk):
            roc, rdc = ro[c0:c0 + o.nerf_chunk], rd[c0:c0 + o.nerf_chunk]
            pts = (roc[:, None, :] + rdc[:, None, :] * z[None, :, None]
                   ).reshape(-1, 3)
            if lerp:
                p0c = pf0[c0:c0 + o.nerf_chunk]
                p1c = pf1[c0:c0 + o.nerf_chunk]
                pf = (p0c[:, None, :] * (1.0 - w)[None, :, None]
                      + p1c[:, None, :] * w[None, :, None]
                      ).reshape(-1, p0c.shape[-1])
            else:
                pf = sample_feature_map_at_points(
                    feat_nchw, (pts - center)[None])[0]
            q = warp_template_query(packed["offset"], packed["template"],
                                    pts, pf)
            # near flag on the pre-warp sample, bounds on the warped point
            if o.near_flag_mode == "ray":
                near_ok = anchored_near_flags(
                    roc, rdc, near, far, S, st.cano_smpl_vertices,
                    n_anchors=o.near_flag_anchors).reshape(-1)
            elif o.near_flag_mode == "volume" and self.near_d_vol is not None:
                near_ok = sample_distance_volume(
                    self.near_d_vol, pts, st.cano_bounds) < NEAR_SMPL_DIST
            else:
                near_ok = (knn(pts, st.cano_smpl_vertices, k=1)[0][:, 0]
                           < NEAR_SMPL_DIST * NEAR_SMPL_DIST)
            wpts = pts + q["offset"]
            inside = ((wpts > st.cano_bounds[0])
                      & (wpts < st.cano_bounds[1])).all(-1)
            sigma = torch.where(inside & near_ok, q["alpha"][:, 0],
                                torch.zeros_like(near_ok, dtype=torch.float32))
            alpha = 1.0 - torch.exp(-sigma.reshape(-1, S) * dz[None, :])
            # exclusive transmittance, as ops/volume_render.raw2outputs
            trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
            trans = torch.cat([torch.ones_like(trans[:, :1]),
                               trans[:, :-1]], dim=-1)
            out.append(torch.einsum("rs,rsc->rc", alpha * trans,
                                    q["rgb"].reshape(-1, S, 3)))
        return torch.cat(out)

    def _ray_colors(self, feat, v, n, ray_query=ray_color_query, live=None):
        """Colors of the rays at (v, n): the kernels with use_fused_query
        (the texture avatar's packed weights; ``live``: see
        _nerf_ray_colors_fused), else the f32 path."""
        if self.opt.use_fused_query:
            packed = (self.packed_tex if self.packed_tex is not None
                      else self.packed_query)
            return self._nerf_ray_colors_fused(packed, feat, v, n,
                                               ray_query=ray_query, live=live)
        return self._nerf_ray_colors_chunked(feat, v, n)

    def nerf_color_stage(self, feat: torch.Tensor, cano_mesh: CaptureMesh,
                         ray_query=ray_color_query):
        """Vertex colors of the avatar soup, integrated along -normal rays
        in canonical space. With nerf_unique_capacity > 0 (and the soup's
        edge keys) one ray per unique vertex, its color scattered back to
        every slot of that vertex; otherwise one ray per slot through the
        f32 path.

        Returns (colors (3*max_tris, 3) as integrated, BGR like the
        reference's network output; overflow (); uniq), uniq being None on
        the per-slot path or (v_u (U, 3), rgb_u (U, 3), valid_u (U,)).
        """
        v, n = cano_mesh.vertices, cano_mesh.normals
        U = self.opt.nerf_unique_capacity
        if not U or cano_mesh.edge_ids is None:
            return (self._nerf_ray_colors_chunked(feat, v, n),
                    torch.zeros((), dtype=torch.bool, device=v.device), None)
        rep, uo, valid_v, valid_u, overflow, n_u = _dedupe_soup(
            cano_mesh.valid, cano_mesh.edge_ids, U)
        v_u = v[rep]
        rgb_u = self._ray_colors(feat, v_u, n[rep], ray_query, live=n_u)
        rgb = torch.where(valid_v[:, None], rgb_u[uo],
                          torch.zeros_like(v))
        return rgb, overflow, (v_u, rgb_u, valid_u)

    def color_transfer_stage(self, feat: torch.Tensor, recon_mesh: CaptureMesh,
                             avatar_verts: torch.Tensor,
                             avatar_colors: torch.Tensor, uniq,
                             ray_query=ray_color_query):
        """Vertex colors of the ReconNet soup (RGB). Without a deduped
        recon soup: each slot takes the color of its nearest avatar soup
        slot. Deduped, per unique recon vertex: recon_color_mode="direct"
        integrates its own color ray; "nn" takes the nearest unique avatar
        vertex's color. Returns (colors (3*recon_max_tris, 3), overflow)."""
        o = self.opt
        Ur = o.recon_unique_capacity
        if not Ur or uniq is None or recon_mesh.edge_ids is None:
            _, idx = knn(recon_mesh.vertices, avatar_verts, k=1,
                         chunk=_knn_chunk(avatar_verts))
            return (avatar_colors[idx[:, 0]],
                    torch.zeros((), dtype=torch.bool,
                                device=avatar_verts.device))
        rep_r, uo_r, valid_r, _, overflow, n_ur = _dedupe_soup(
            recon_mesh.valid, recon_mesh.edge_ids, Ur)
        if o.recon_color_mode == "direct":
            rgb_u = self._ray_colors(feat, recon_mesh.vertices[rep_r],
                                     recon_mesh.normals[rep_r], ray_query,
                                     live=n_ur)
            rgb_r = rgb_u.flip(-1)[uo_r]                  # BGR -> RGB
        else:
            v_u, rgb_u, valid_u = uniq
            # unused capacity parks far away, so it never is the nearest
            db = torch.where(valid_u[:, None], v_u,
                             torch.full_like(v_u, 1e9))
            _, idx = knn(recon_mesh.vertices[rep_r], db, k=1,
                         chunk=_knn_chunk(db))
            rgb_r = rgb_u.flip(-1)[idx[:, 0]][uo_r]       # BGR -> RGB
        return (torch.where(valid_r[:, None], rgb_r, torch.zeros_like(rgb_r)),
                overflow)

    def _projection(self, camera: Dict[str, float], img_h: int,
                    img_w: int) -> torch.Tensor:
        """The capture camera's perspective projection on the device, copied
        once per camera and image size."""
        fx, fy, cx, cy = (camera[k] for k in ("fx", "fy", "cx", "cy"))
        return device_constant(gl_perspective_projection_matrix(
            fx, fy, cx, cy, img_w, img_h, gl_space=False), self.device)

    def _neck_xy(self, neck_vertex_idx: int):
        """(x, y) of the neck vertex on the canonical front image (host
        integers, numpy float32 arithmetic as in the JAX package), read
        from the device once per vertex."""
        hit = self._neck_xys.get(neck_vertex_idx)
        if hit is None:
            neck_v = (self.statics.cano_smpl_vertices[neck_vertex_idx]
                      .detach().cpu().numpy()
                      - self.statics.cano_smpl_center.detach().cpu().numpy())
            res = self.opt.render_res
            neck_y = int((1.0 - neck_v[1]) / 2.0 * res)
            neck_x = int((neck_v[0] - 1.0) / 2.0 * res) % res
            hit = self._neck_xys[neck_vertex_idx] = (neck_x, neck_y)
        return hit

    def replica(self, device) -> "AvatarCapture":
        """This capture on another device (itself on its own): copies of
        the networks, the statics and the grid (its coarse level included,
        so nothing is read back), with the same options."""
        device = canonical_device(device)
        if device == self.device:
            return self
        if self.shard_mesh is not None:
            raise ValueError("a point-sharded capture has no replicas; "
                             "shard frames or points, not both")
        tex = (copy.deepcopy(self.tex_avatar)
               if self.tex_avatar is not self.avatar else None)
        return AvatarCapture(
            copy.deepcopy(self.avatar), self.statics, self.grid,
            recon=copy.deepcopy(self.recon), tex_avatar=tex,
            options=self.opt, device=device)

    def upload(self, item: Dict[str, Any], inferred_normal=None):
        """The item's per-frame arrays on the device, each copied from
        pinned memory without waiting for the card: (FrameInputs, (J, 4, 4)
        joint mats, inferred normal (H, W, 3) or None, w2c (4, 4) or
        None)."""
        def tensor(value):
            if isinstance(value, torch.Tensor) and value.device.type != "cpu":
                return value.to(self.device, torch.float32)
            return to_device(value, self.device, torch.float32)

        frame = FrameInputs(
            live_smpl_v=tensor(item["live_smpl_v"])[None],
            cano2live_jnt_mats=tensor(item["cano2live_jnt_mats"])[None],
            smpl_pos_map=tensor(item["smpl_pos_map"])[None])
        return (frame, frame.cano2live_jnt_mats[0],
                None if inferred_normal is None else tensor(inferred_normal),
                tensor(item["w2c_RT"]) if "w2c_RT" in item else None)

    def process_frame(self, item: Dict[str, Any], w_recon: bool = True,
                      w_nerf: bool = False,
                      inferred_normal: Optional[np.ndarray] = None,
                      neck_vertex_idx: Optional[int] = None,
                      camera: Optional[Dict[str, float]] = None,
                      timer=None) -> Dict[str, Any]:
        """Run the capture stages for one dataset item: its upload, then
        ``frame_body``.

        Args:
          item: live_smpl_v, cano2live_jnt_mats, smpl_pos_map and, for
            ``w_recon``, w2c_RT (world -> camera).
          w_recon: fuse the image normals and reconstruct with ReconNet
            (needs ``recon`` at construction, ``inferred_normal`` (H, W,
            3), ``neck_vertex_idx`` and ``camera`` dict(fx, fy, cx, cy)).
          w_nerf: NeRF vertex colors of the avatar soup (and, with
            ``w_recon``, of the ReconNet soup).
          timer: optional callable, ``timer(stage_name)`` -> a context
            manager wrapped around each stage (for per-stage timing). A
            utils/timers.Tracer also gets the frame's root span and the
            spans of the layers below the stages.
        Returns dict(cano_mesh, live_mesh, cano_phong, front_avatar_normal,
        back_avatar_normal, overflow); with ``w_recon`` also
        front_merged_normal, front_image_normal, recon_mesh and
        live_recon_mesh; with ``w_nerf`` also avatar_colors (RGB per soup
        slot) and, with ``w_recon``, recon_colors; with a Tracer also
        frame_id, the id of the frame's root span.
        """
        if w_recon and (self.recon is None or inferred_normal is None
                        or neck_vertex_idx is None or camera is None):
            raise ValueError(
                "process_frame(w_recon=True) needs a ReconNetwork (recon=) "
                "and the inferred_normal, neck_vertex_idx and camera "
                "arguments")
        frame, jnt_mats, normal, w2c = self.upload(
            item, inferred_normal if w_recon else None)
        return self.frame_body(
            frame, jnt_mats, normal, w2c, camera,
            self._neck_xy(neck_vertex_idx) if w_recon else None,
            w_recon=w_recon, w_nerf=w_nerf, timer=timer)

    def frame_body(self, frame: FrameInputs, jnt_mats: torch.Tensor,
                   inferred_normal: Optional[torch.Tensor],
                   w2c: Optional[torch.Tensor],
                   camera: Optional[Dict[str, float]],
                   neck_xy: Optional[tuple], w_recon: bool = True,
                   w_nerf: bool = False, timer=None) -> Dict[str, Any]:
        """The per-frame pipeline on device tensors (the counterpart of the
        JAX ``frame_body``), shared by ``process_frame`` and
        pipeline/streaming.py. It reads nothing back to the host, so the
        host may queue the next frame behind it (a ``timer`` that
        synchronises, such as utils/timers.StageTimer, does; a Tracer does
        not).

        Args:
          frame: FrameInputs on the device; jnt_mats: (J, 4, 4).
          inferred_normal (H, W, 3), w2c (4, 4), camera dict(fx, fy, cx,
            cy) and neck_xy (host (x, y), ``_neck_xy``): for ``w_recon``.
        Returns process_frame's dict.
        """
        o = self.opt
        with frame_span(timer) as root, torch.inference_mode():
            with stage(timer, "geometry"):
                cano_mesh, feat = self.avatar_geometry_stage(
                    frame, want_edge_ids=w_nerf)
            with stage(timer, "skinning"):
                live_mesh, pt_mats = self.skinning_stage(cano_mesh, jnt_mats)
            if w_recon:
                # lift the image normals before the canonical layers, so
                # their interpolation joins the shared attribute table
                with stage(timer, "lift"):
                    proj_n_tris, lift_ovf = self.lift_normals_stage(
                        live_mesh, cano_mesh.valid, pt_mats, inferred_normal,
                        w2c, camera)
                with stage(timer, "cano_layers"):
                    (fri, bri, front_avatar_n, back_avatar_n, phong,
                     front_img_n, _) = self.cano_layers_stage(
                        cano_mesh, extra_tri_attrs=proj_n_tris)
            else:
                with stage(timer, "cano_layers"):
                    (fri, bri, front_avatar_n, back_avatar_n,
                     phong) = self.cano_layers_stage(cano_mesh)
            overflow = cano_mesh.overflow | fri.overflow | bri.overflow
            results = {"cano_mesh": cano_mesh, "live_mesh": live_mesh,
                       "cano_phong": phong,
                       "front_avatar_normal": front_avatar_n,
                       "back_avatar_normal": back_avatar_n}
            if w_recon:
                with stage(timer, "merge"):
                    if o.integrate_manner == "merge":
                        front_merged = merge_normal_images(
                            front_avatar_n, front_img_n, neck_xy,
                            iter_num=o.fusion_iters)
                    else:
                        front_merged = merge_normal_images_cover(
                            front_avatar_n, front_img_n)
                # the back keeps the avatar normals (as the reference)
                recon_mesh = self.recon_stage(front_merged, back_avatar_n,
                                              timer=timer,
                                              want_edge_ids=w_nerf)
                with stage(timer, "recon_skinning"):
                    live_recon, _ = self.skinning_stage(recon_mesh, jnt_mats)
                overflow = overflow | lift_ovf | recon_mesh.overflow
                results.update({"front_merged_normal": front_merged,
                                "front_image_normal": front_img_n,
                                "recon_mesh": recon_mesh,
                                "live_recon_mesh": live_recon})
            if w_nerf:
                with stage(timer, "nerf_colors"):
                    colors, nerf_ovf, uniq = self.nerf_color_stage(
                        feat, cano_mesh)
                # BGR -> RGB, as the reference's vertex colors
                results["avatar_colors"] = colors.flip(-1)
                overflow = overflow | nerf_ovf
                if w_recon:
                    with stage(timer, "color_transfer"):
                        recon_colors, xfer_ovf = self.color_transfer_stage(
                            feat, recon_mesh, cano_mesh.vertices,
                            results["avatar_colors"], uniq)
                    results["recon_colors"] = recon_colors
                    overflow = overflow | xfer_ovf
            results["overflow"] = overflow
        if root is not None:
            results["frame_id"] = root.id
        return results

    def render_live(self, live_mesh: CaptureMesh, front_mv, back_mv,
                    colors=None):
        """Perspective Phong preview of a live mesh, front and back (the
        reference's main.py:397-403): the fixed 5000 / 256 / 512
        projection, ``render_res`` and ``raster_window``. ``front_mv`` /
        ``back_mv`` come from render.camera.calc_front_mv / calc_back_mv;
        ``colors`` (3*T, 3) tint the shading."""
        proj = gl_perspective_projection_matrix(5000, 5000, 256, 256,
                                                512, 512, gl_space=True)
        color_tris = None if colors is None else colors.reshape(-1, 3, 3)
        with torch.inference_mode():
            return render_live_mesh(
                live_mesh.vertices.reshape(-1, 3, 3),
                live_mesh.normals.reshape(-1, 3, 3), live_mesh.valid,
                front_mv, back_mv, proj, real2gl_matrix(),
                res=self.opt.render_res, window=self.opt.raster_window,
                color_tris=color_tris)
