"""Capture frame (counterpart of avatarcap_tpu/pipeline/capture.py), in
the order of its ``frame_body``.

Per frame: U-Net pose features -> coarse-to-fine canonical occupancy
through kernel K1 (or the f32 module path) -> marching cubes with
trilinear-gradient normals -> volume-LBS skinning to live space. With
``w_recon`` (the production frame): the image normals are lifted onto the
mesh from the capture camera, the canonical front/back index passes
interpolate them with the avatar normals and the Phong preview from one
18-channel table, the front normals are merged by the two-phase
optimisation, ReconNet (HGFilter features + coarse-to-fine pixel-aligned
occupancy through kernel K2, or the f32 decoder) gives a second mesh, and
that mesh is skinned too. The stage functions keep the JAX stages' static
capacities, ascending compaction order and the aggregate ``overflow``
bit, so meshes compare slot for slot with the JAX frame.

Not ported yet (they raise ``NotImplementedError``): ``w_nerf=True`` (NeRF
vertex colors, kernel K3) and the ``mc_edge``/``sobel_sample`` normal
modes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avatarcap_tpu_torch.body.skinning import (
    blend_joint_mats16, build_skin_weight_volume, mats16_apply_points,
    mats16_rotate, skin_points_by_volume)
from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.fusion.normal_fusion import (
    lift_image_normals, merge_normal_images, merge_normal_images_cover)
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.recon import ReconNetwork
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.ops.fused_query import (pack_recon_weights,
                                                 recon_decode,
                                                 warp_template_query)
from avatarcap_tpu_torch.ops.knn import approx_lbs_weights
from avatarcap_tpu_torch.ops.marching_cubes import marching_tets
from avatarcap_tpu_torch.pipeline.avatar import (
    AvatarStatics, FrameInputs, compute_pose_features, grid_pose_features,
    pack_fused_query_weights, query_occupancy)
from avatarcap_tpu_torch.render.camera import (
    cano_front_back_mvp, gl_perspective_projection_matrix)
from avatarcap_tpu_torch.render.raster import interpolate
from avatarcap_tpu_torch.render.visualize import cano_index_passes, phong_shade


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


@dataclasses.dataclass(frozen=True)
class CaptureOptions:
    """The JAX package's CaptureOptions, field for field (see
    avatarcap_tpu/pipeline/capture.py for each field's rationale). Fields
    of the NeRF color path, which is not ported yet, are kept so
    configurations carry over; that path raises."""

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
    use_fused_query: bool = True     # K1 and K2 for the grid queries
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
                         c_res=(Xc, Yc, Zc))


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
    """
    g = grid
    X, Y, Z = g.vol_res
    dev = prior.device
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
    r_occ = value_fn(rpts, torch.where(live, ridx, torch.zeros_like(ridx)))
    vol = _upsample2(cvol, (X, Y, Z)).reshape(-1)
    vol = _scatter_set(vol, torch.where(live, ridx,
                                        torch.full_like(ridx, X * Y * Z)),
                       r_occ)
    vol = torch.where(g.valid_mask, vol, prior)
    if with_stats:
        return vol, q_overflow, n_r
    return vol, q_overflow


def _stage(timer, name: str):
    """``timer(name)``, a context manager around one stage, or nothing."""
    return timer(name) if timer is not None else contextlib.nullcontext()


def _extract_mesh(volume_flat, grid: CaptureGrid, bounds, iso, max_tris,
                  max_active):
    """Volume -> mesh with trilinear-gradient normals."""
    X, Y, Z = grid.vol_res
    vol = volume_flat.reshape(X, Y, Z)
    voxel = (bounds[1] - bounds[0]) / torch.tensor(
        [X, Y, Z], dtype=bounds.dtype, device=bounds.device)
    mesh = marching_tets(vol, iso, bounds[0], voxel, max_tris=max_tris,
                         max_active=max_active)
    valid = torch.arange(max_tris, device=vol.device) < mesh.num_tris
    return CaptureMesh(mesh.vertices, mesh.normals, mesh.num_tris, valid,
                       mesh.overflow)


class AvatarCapture:
    """Per-frame capture orchestrator over plain stage functions.

    Args:
      avatar: the port's GeoTexAvatar (weights loaded; put in eval mode).
      statics: AvatarStatics; grid: CaptureGrid (tensors or arrays).
      recon: the port's ReconNetwork, needed by ``w_recon=True`` frames.
      device: None = the card (raises without one); "cpu" runs the plain
        PyTorch path everywhere, with the kernels' plain versions.
    """

    def __init__(self, avatar: GeoTexAvatar, statics: AvatarStatics,
                 grid: CaptureGrid, recon: Optional[ReconNetwork] = None,
                 options: CaptureOptions = CaptureOptions(), device=None):
        o = options
        if o.normal_mode != "trilinear":
            raise NotImplementedError(
                f"normal_mode={o.normal_mode!r} is not ported yet; the port "
                "has 'trilinear' only")
        self.device = resolve_device(device)
        self.opt = o
        self.avatar = avatar.to(self.device).eval()
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

    # -- stages --------------------------------------------------------

    def avatar_geometry_stage(self, frame: FrameInputs):
        """Pose features -> canonical occupancy volume -> mesh.
        Returns (CaptureMesh, pose feature map (1, H, W, C))."""
        o = self.opt
        g = self.grid
        st = self.statics
        Z = g.vol_res[2]
        feat = compute_pose_features(self.avatar, frame.smpl_pos_map)
        q_ovf = None
        if o.use_fused_query:
            pk = self.packed_query
            if o.hierarchical_query:
                pf_cols = grid_pose_features(feat, st, g.vol_res,
                                             dtype=torch.bfloat16,
                                             columns=True)

                def vf(pts, fidx):
                    pf = pf_cols[fidx.long() // Z]
                    return warp_template_query(pk["offset"], pk["template"],
                                               pts, pf)["occ"][:, 0]

                vol, q_ovf = hierarchical_volume(
                    vf, g, st.cano_bounds, g.c_prior, g.prior_volume,
                    o.iso_value, o.hier_alpha, o.refine_capacity)
            else:
                pf = grid_pose_features(feat, st, g.vol_res, g.valid_idx,
                                        dtype=torch.bfloat16)
                qout = warp_template_query(pk["offset"], pk["template"],
                                           g.valid_pts, pf)
                vol = _scatter_set(g.prior_volume, g.valid_idx,
                                   qout["occ"][:, 0])
        else:
            def vf_f32(pts, fidx):
                out = query_occupancy(self.avatar, pts[None], feat, st)
                return out["cano_pts_ov"][0, :, 0]

            if o.hierarchical_query:
                vol, q_ovf = hierarchical_volume(
                    vf_f32, g, st.cano_bounds, g.c_prior, g.prior_volume,
                    o.iso_value, o.hier_alpha, o.refine_capacity)
            else:
                vol = _scatter_set(g.prior_volume, g.valid_idx,
                                   vf_f32(g.valid_pts, None))
        mesh = _extract_mesh(vol, g, st.cano_bounds, o.iso_value, o.max_tris,
                             o.max_active)
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
        proj = torch.as_tensor(gl_perspective_projection_matrix(
            fx, fy, cx, cy, img_w, img_h, gl_space=False), device=self.device)
        return lift_image_normals(
            live_mesh.vertices.reshape(-1, 3, 3), valid, inferred_normal,
            pt_mats, w2c, proj, fx, fy, cx, cy, img_h, img_w,
            window=o.cano_window, big_tris=o.live_big_tris,
            max_candidates=o.raster_max_candidates)

    def recon_volume(self, feat_map: torch.Tensor, decode=recon_decode):
        """ReconNet occupancy over the grid from the HGFilter feature map
        (1, Hf, Wf, C). The occupancy iso level is 0.5, so the [-1, 1]
        prior is rescaled to [0, 1].

        Args:
          decode: the fused path's (packed, feats (N, 33)) -> (N,) decoder,
            K2's wrapper (a caller may wrap it to see each launch's
            inputs).
        Returns (vol_flat (X*Y*Z,), query overflow () or None).
        """
        o = self.opt
        g = self.grid
        st = self.statics
        Z = g.vol_res[2]
        prior01 = 0.5 * (g.prior_volume + 1.0)
        c_prior01 = (0.5 * (g.c_prior + 1.0) if o.hierarchical_query
                     else None)
        capacity = o.recon_refine_capacity or o.refine_capacity
        center = st.cano_smpl_center
        if o.use_fused_query:
            pk = self.packed_recon
            if not o.hierarchical_query:
                pf = grid_pose_features(feat_map, st, g.vol_res, g.valid_idx)
                z = g.valid_pts[:, 2:3] - center[2]
                return _scatter_set(prior01, g.valid_idx,
                                    decode(pk, torch.cat([pf, z], -1))), None
            pf_cols = grid_pose_features(feat_map, st, g.vol_res,
                                         columns=True)

            def vf(pts, fidx):
                z = pts[:, 2:3] - center[2]
                return decode(pk, torch.cat([pf_cols[fidx.long() // Z], z],
                                            -1))
        else:
            def vf(pts, fidx):
                return self.recon.decode_points(feat_map, pts[None],
                                                center[None])[0]

            if not o.hierarchical_query:
                return _scatter_set(prior01, g.valid_idx,
                                    vf(g.valid_pts, None)), None
        return hierarchical_volume(vf, g, st.cano_bounds, c_prior01, prior01,
                                   0.5, o.hier_alpha, capacity)

    def recon_stage(self, front_normal: torch.Tensor,
                    back_normal: torch.Tensor, timer=None) -> CaptureMesh:
        """Fused front|back normals -> HGFilter features -> occupancy
        volume -> mesh. ``timer`` (see process_frame) sees "hgfilter" and
        "recon_query_mc"."""
        o = self.opt
        with _stage(timer, "hgfilter"):
            feat_map = self.recon.get_feat_maps(
                torch.cat([front_normal, back_normal], dim=-1)[None])
        with _stage(timer, "recon_query_mc"):
            vol, q_ovf = self.recon_volume(feat_map)
            mesh = _extract_mesh(vol, self.grid, self.statics.cano_bounds,
                                 0.5, o.recon_max_tris or o.max_tris,
                                 o.recon_max_active or o.max_active)
            if q_ovf is not None:
                mesh = mesh._replace(overflow=mesh.overflow | q_ovf)
        return mesh

    def _neck_xy(self, neck_vertex_idx: int):
        """(x, y) of the neck vertex on the canonical front image (host
        integers, numpy float32 arithmetic as in the JAX package)."""
        neck_v = (self.statics.cano_smpl_vertices[neck_vertex_idx]
                  .detach().cpu().numpy()
                  - self.statics.cano_smpl_center.detach().cpu().numpy())
        res = self.opt.render_res
        neck_y = int((1.0 - neck_v[1]) / 2.0 * res)
        neck_x = int((neck_v[0] - 1.0) / 2.0 * res) % res
        return neck_x, neck_y

    def process_frame(self, item: Dict[str, Any], w_recon: bool = True,
                      w_nerf: bool = False,
                      inferred_normal: Optional[np.ndarray] = None,
                      neck_vertex_idx: Optional[int] = None,
                      camera: Optional[Dict[str, float]] = None,
                      timer=None) -> Dict[str, Any]:
        """Run the capture stages for one dataset item.

        Args:
          item: live_smpl_v, cano2live_jnt_mats, smpl_pos_map and, for
            ``w_recon``, w2c_RT (world -> camera).
          w_recon: fuse the image normals and reconstruct with ReconNet
            (needs ``recon`` at construction, ``inferred_normal`` (H, W,
            3), ``neck_vertex_idx`` and ``camera`` dict(fx, fy, cx, cy)).
          timer: optional callable, ``timer(stage_name)`` -> a context
            manager wrapped around each stage (for per-stage timing).
        Returns dict(cano_mesh, live_mesh, cano_phong, front_avatar_normal,
        back_avatar_normal, overflow) and, with ``w_recon``,
        front_merged_normal, front_image_normal, recon_mesh and
        live_recon_mesh.
        """
        if w_nerf:
            raise NotImplementedError(
                "process_frame(w_nerf=True) needs the NeRF color path and "
                "kernel K3 (ray_color_query_fused), which come with a later "
                "slice of the port")
        if w_recon and (self.recon is None or inferred_normal is None
                        or neck_vertex_idx is None or camera is None):
            raise ValueError(
                "process_frame(w_recon=True) needs a ReconNetwork (recon=) "
                "and the inferred_normal, neck_vertex_idx and camera "
                "arguments")
        o = self.opt

        def tensor(value):
            return torch.as_tensor(value, dtype=torch.float32).to(
                self.device)

        with torch.inference_mode():
            frame = FrameInputs(
                live_smpl_v=tensor(item["live_smpl_v"])[None],
                cano2live_jnt_mats=tensor(item["cano2live_jnt_mats"])[None],
                smpl_pos_map=tensor(item["smpl_pos_map"])[None])
            jnt_mats = frame.cano2live_jnt_mats[0]
            with _stage(timer, "geometry"):
                cano_mesh, _ = self.avatar_geometry_stage(frame)
            with _stage(timer, "skinning"):
                live_mesh, pt_mats = self.skinning_stage(cano_mesh, jnt_mats)
            if w_recon:
                # lift the image normals before the canonical layers, so
                # their interpolation joins the shared attribute table
                with _stage(timer, "lift"):
                    proj_n_tris, lift_ovf = self.lift_normals_stage(
                        live_mesh, cano_mesh.valid, pt_mats,
                        tensor(inferred_normal), tensor(item["w2c_RT"]),
                        camera)
                with _stage(timer, "cano_layers"):
                    (fri, bri, front_avatar_n, back_avatar_n, phong,
                     front_img_n, _) = self.cano_layers_stage(
                        cano_mesh, extra_tri_attrs=proj_n_tris)
            else:
                with _stage(timer, "cano_layers"):
                    (fri, bri, front_avatar_n, back_avatar_n,
                     phong) = self.cano_layers_stage(cano_mesh)
            overflow = cano_mesh.overflow | fri.overflow | bri.overflow
            results = {"cano_mesh": cano_mesh, "live_mesh": live_mesh,
                       "cano_phong": phong,
                       "front_avatar_normal": front_avatar_n,
                       "back_avatar_normal": back_avatar_n}
            if w_recon:
                with _stage(timer, "merge"):
                    if o.integrate_manner == "merge":
                        front_merged = merge_normal_images(
                            front_avatar_n, front_img_n,
                            self._neck_xy(neck_vertex_idx),
                            iter_num=o.fusion_iters)
                    else:
                        front_merged = merge_normal_images_cover(
                            front_avatar_n, front_img_n)
                # the back keeps the avatar normals (as the reference)
                recon_mesh = self.recon_stage(front_merged, back_avatar_n,
                                              timer=timer)
                with _stage(timer, "recon_skinning"):
                    live_recon, _ = self.skinning_stage(recon_mesh, jnt_mats)
                overflow = overflow | lift_ovf | recon_mesh.overflow
                results.update({"front_merged_normal": front_merged,
                                "front_image_normal": front_img_n,
                                "recon_mesh": recon_mesh,
                                "live_recon_mesh": live_recon})
            results["overflow"] = overflow
        return results
