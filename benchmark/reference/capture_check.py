"""The capture cells' comparison: what a timed frame produced against the
float32 reference on the same inputs and weights.

Per checked frame, from the frame's host outputs:

- ``avatar_iso_gap``: the avatar mesh's vertices lie on grid edges (the
  256-case marching cubes puts every vertex on an axis edge); the
  reference's own field (U-Net pose features, then the warp and template
  on every near-body node, the occupancy head's sigmoid for that form)
  interpolated along each vertex's edge at the vertex must be the iso
  level. The widest gap over the vertices, in field units. It holds the
  pose features, K1 and its occupancy head, the coarse-to-fine query and
  the vertex placement.
- ``avatar_edge_gap``: the grid edges holding a vertex against the edges
  the reference's field crosses: the larger of the spurious share and the
  missing share (mesh_gaps): a left-out or spurious part of the surface.
- ``avatar_live_gap``: the live mesh against the reference's volume
  skinning of the frame's canonical vertices (m).
- with ``w_recon``: ``layers_gap``, the canonical layers (the front and
  back avatar normal images and the lifted image normals) against the
  reference's raster and lift of the frame's own canonical mesh (its
  live mesh skinned by the reference): the share of covered pixels
  whose normal differs by more than 1e-4, the widest over the three
  images; ``merge_gap``, the merged front normals against the
  reference's merge of the frame's own avatar and image normal images
  (it follows the program from the canonical layers' output, which
  ``layers_gap`` holds); and ``recon_iso_gap``, ``recon_edge_gap``,
  ``recon_live_gap`` as above for ReconNet's mesh, on the reference's
  HGFilter features of the frame's merged front and avatar back normals
  and its decoder on every near-body node (``recon_band_share``, printed:
  the share of the mesh's vertices on edges inside the near-body band,
  where the decoder and not the prior sets the surface).
- with ``w_nerf``: ``color_gap``, the widest gap of a color channel over
  sampled vertices of both soups, against the reference's ray integral
  (the texture avatar along -normal, pose features interpolated between
  the ray's ends, the anchored near-body gate).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import networks
from benchmark.reference.avatar_query import (NEAR_SMPL_DIST,
                                              compute_pose_features,
                                              grid_pose_features,
                                              query_occupancy)
from benchmark.reference.embed import positional_encoding
from benchmark.reference.grid_sample import sample_feature_map_at_points
from benchmark.reference.knn import knn
from benchmark.reference.merge import merge_normal_images
from benchmark.reference.raster import (cano_front_back_mvp,
                                        cano_index_passes,
                                        gl_perspective_projection_matrix,
                                        interpolate, lift_image_normals)
from benchmark.reference.skinning import (build_skin_weight_volume,
                                          skin_points_by_volume)

CHUNK = 1 << 18


class CaptureReference:
    """The reference networks and per-subject tables of one capture
    configuration on ``device``, built from the benchmark's weights and
    statics (reference AvatarStatics)."""

    def __init__(self, cfg: dict, weights: dict, statics, grid: dict,
                 device):
        self.cfg, self.opt = cfg, cfg["capture"]["options"]
        self.device = torch.device(device)
        self.statics = statics.to(self.device)
        self.grid = {k: (v.to(self.device) if torch.is_tensor(v) else v)
                     for k, v in grid.items()}
        self.avatar = self._load("avatar", weights["avatar"])
        self.tex = self._load("avatar", weights["tex"])
        self.recon = self._load("recon", weights["recon"])
        self.skin_wvol = build_skin_weight_volume(
            self.statics.cano_smpl_vertices,
            self.statics.smpl_skinning_weights, self.statics.cano_bounds,
            voxel=self.opt["skin_voxel"])
        self.mvps = [torch.as_tensor(m, device=self.device) for m in
                     cano_front_back_mvp(
                         self.statics.cano_smpl_center.cpu().numpy())]
        n = int(np.prod(self.grid["vol_res"]))
        vi = self.grid["valid_idx"].long()
        self.band = torch.zeros(n + 1, dtype=torch.bool, device=self.device)
        self.band[vi.clamp(0, n)] = True
        self.band = self.band[:n]

    def _load(self, role, state):
        module = networks.build(self.cfg, role, "reference")
        module.load_state_dict(state)
        return module.to(self.device).eval()

    @property
    def iso(self) -> float:
        return self.opt["iso_value"]

    @torch.no_grad()
    def pose_features(self, pos_map: np.ndarray) -> torch.Tensor:
        pm = torch.as_tensor(pos_map, device=self.device)[None]
        return compute_pose_features(self.avatar, pm)

    @torch.no_grad()
    def avatar_volume(self, feat: torch.Tensor) -> torch.Tensor:
        """The dense (X*Y*Z,) volume: the prior, and the avatar's field at
        every near-body node."""
        g = self.grid
        vals = [query_occupancy(self.avatar, g["valid_pts"][c:c + CHUNK][None],
                                feat, self.statics)["cano_pts_ov"][0, :, 0]
                for c in range(0, g["valid_pts"].shape[0], CHUNK)]
        return _scatter(g["prior_volume"], g["valid_idx"], torch.cat(vals))

    @torch.no_grad()
    def recon_volume(self, front: np.ndarray, back: np.ndarray
                     ) -> torch.Tensor:
        """ReconNet's dense occupancy volume on the HGFilter features of
        the frame's [front, back] normal images (prior rescaled to [0, 1])."""
        g, st = self.grid, self.statics
        img = torch.cat([torch.as_tensor(front, device=self.device),
                         torch.as_tensor(back, device=self.device)], -1)
        feat_map = self.recon.get_feat_maps(img[None])
        z = g["valid_pts"][:, 2:3] - st.cano_smpl_center[2]
        vals = []
        for c in range(0, z.shape[0], CHUNK):
            pf = grid_pose_features(feat_map, st, g["vol_res"],
                                    g["valid_idx"][c:c + CHUNK])
            vals.append(self.recon.image_decoder(
                torch.cat([pf, z[c:c + CHUNK]], -1))[:, 0])
        return _scatter(0.5 * (g["prior_volume"] + 1.0), g["valid_idx"],
                        torch.cat(vals))

    @torch.no_grad()
    def skin(self, cano_v: np.ndarray, jnt_mats: np.ndarray) -> torch.Tensor:
        return skin_points_by_volume(
            torch.as_tensor(cano_v, device=self.device), self.skin_wvol,
            self.statics.cano_bounds,
            torch.as_tensor(jnt_mats, device=self.device),
            row_group=self.opt["skin_row_group"])

    @torch.no_grad()
    def cano_layers(self, cano_v: np.ndarray, cano_n: np.ndarray,
                    frame: dict, w_recon: bool) -> Dict[str, torch.Tensor]:
        """The frame's canonical layers from its own canonical soup (its
        valid triangles; the capture's max_tris slots), as
        pipeline/capture.py's cano_layers_stage and lift_normals_stage
        compute them on the frozen raster and lift (reference/raster.py):
        one front + back index pass, the normals interpolated, the back
        x-flipped; with ``w_recon`` the frame's inferred normals lifted
        from the capture camera onto the soup skinned by the reference's
        volume, interpolated in the same passes."""
        o, dev = self.opt, self.device
        T = o["max_tris"]
        nt = cano_v.shape[0] // 3

        def slots(a):
            out = torch.zeros(T, 3, 3, device=dev)
            out[:nt] = torch.as_tensor(a, device=dev).reshape(nt, 3, 3)
            return out
        tris, attr = slots(cano_v), slots(cano_n)
        valid = torch.arange(T, device=dev) < nt
        fmvp, _, bmvp, _ = self.mvps
        cc = o["raster_max_candidates"]
        fri, bri = cano_index_passes(
            tris, valid, fmvp, bmvp, res=o["render_res"],
            window=o["cano_window"], big_tris=o["cano_big_tris"],
            max_candidates=cc)
        layers = [attr]
        if w_recon:
            normal = torch.as_tensor(frame["inferred_normal"], device=dev)
            img_h, img_w = normal.shape[:2]
            cam = frame["camera"]
            fx, fy, cx, cy = (cam[k] for k in ("fx", "fy", "cx", "cy"))
            live, m16 = skin_points_by_volume(
                tris.reshape(-1, 3), self.skin_wvol, self.statics.cano_bounds,
                torch.as_tensor(frame["cano2live_jnt_mats"], device=dev),
                return_pt_mats=True, row_group=o["skin_row_group"])
            proj = torch.as_tensor(gl_perspective_projection_matrix(
                fx, fy, cx, cy, img_w, img_h, gl_space=False), device=dev)
            lifted, _ = lift_image_normals(
                live.reshape(-1, 3, 3), valid, normal, m16,
                torch.as_tensor(frame["w2c_RT"], device=dev), proj,
                fx, fy, cx, cy, img_h, img_w, window=o["cano_window"],
                big_tris=o["live_big_tris"], max_candidates=cc)
            layers.append(lifted)
        wide = torch.cat(layers, -1)
        f_out, _ = interpolate(fri, wide, covered_capacity=cc)
        b_out, _ = interpolate(bri, wide, covered_capacity=cc)
        b_out = b_out.flip(1)
        out = {"front_avatar_normal": f_out[..., 0:3],
               "back_avatar_normal": b_out[..., 0:3]}
        if w_recon:
            out["front_image_normal"] = f_out[..., 3:6]
        return out

    def neck_xy(self, neck_vertex_idx: int):
        """(x, y) of the neck vertex on the canonical front image."""
        st = self.statics
        neck_v = (st.cano_smpl_vertices[neck_vertex_idx].cpu().numpy()
                  - st.cano_smpl_center.cpu().numpy())
        res = self.opt["render_res"]
        return (int((neck_v[0] - 1.0) / 2.0 * res) % res,
                int((1.0 - neck_v[1]) / 2.0 * res))

    def merge(self, front_avatar: np.ndarray, front_image: np.ndarray,
              neck_vertex_idx: int) -> torch.Tensor:
        return merge_normal_images(
            torch.as_tensor(front_avatar, device=self.device),
            torch.as_tensor(front_image, device=self.device),
            self.neck_xy(neck_vertex_idx), iter_num=self.opt["fusion_iters"])

    @torch.no_grad()
    def ray_colors(self, feat: torch.Tensor, v: np.ndarray, n: np.ndarray
                   ) -> torch.Tensor:
        """RGB of one color ray per (v, n): origin v + n, direction -n over
        the depth band [0.98, 1.05] in n_samples samples, pose features
        lerped between the band's ends, density gated by the anchored
        distance to the body (< 8 cm) and the canonical bounds on the
        warped point; the texture avatar in float32."""
        S = self.opt["n_samples"]
        A = self.opt["near_flag_anchors"]
        near, far = 0.98, 1.05
        st = self.statics
        v = torch.as_tensor(v, device=self.device)
        n = torch.as_tensor(n, device=self.device)
        ro, rd = v + n, -n
        R = ro.shape[0]
        center = st.cano_smpl_center
        fm = feat.permute(0, 3, 1, 2)
        pf0, pf1 = (sample_feature_map_at_points(
            fm, (ro + rd * z - center)[None])[0] for z in (near, far))
        za = torch.linspace(near, far, A, device=self.device)
        apts = ro[:, None] + rd[:, None] * za[None, :, None]
        d2, _ = knn(apts.reshape(-1, 3), st.cano_smpl_vertices, k=1)
        danch = d2[:, 0].clamp_min(0.0).sqrt().reshape(R, A)
        gap = (far - near) / (S - 1)
        trans = torch.ones(R, device=self.device)
        acc = torch.zeros(R, 3, device=self.device)
        wf, tpl = self.tex.warping_field, self.tex.cano_template
        for s in range(S):
            w1 = s / (S - 1)
            pts = ro + rd * (near + gap * s)
            pf = pf0 * (1.0 - w1) + pf1 * w1
            off = wf.out_layer_coord_affine(wf.mlp(torch.cat(
                [positional_encoding(pts, wf.pos_encoding), pf], -1)))
            wpts = pts + off
            rgb, sigma, _ = tpl(wpts)
            pos = s * (A - 1) / (S - 1)
            a0 = min(int(np.floor(pos)), A - 2)
            f = pos - a0
            d = danch[:, a0] * (1.0 - f) + danch[:, a0 + 1] * f
            keep = ((d < NEAR_SMPL_DIST) & (wpts > st.cano_bounds[0]).all(-1)
                    & (wpts < st.cano_bounds[1]).all(-1))
            sigma = torch.where(keep, sigma[:, 0], torch.zeros_like(d))
            alpha = 1.0 - torch.exp(-sigma * gap)
            acc = acc + (alpha * trans)[:, None] * rgb
            trans = trans * (1.0 - alpha + 1e-10)
        return acc.flip(-1)                      # the network's BGR -> RGB


def _scatter(base: torch.Tensor, idx: torch.Tensor, values: torch.Tensor):
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((1,))])
    idx = idx.long()
    out[torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))] = \
        values
    return out[:n]


def _edges(verts: np.ndarray, bounds: torch.Tensor, vol_res):
    """Each soup vertex's grid edge. A vertex at index coordinates g =
    (v - lo) / voxel - 0.5 (voxel = span / res, marching_tets' placement)
    lies on the axis edge along its most fractional coordinate. Returns
    (g, lower node (N, 3), upper node, t along the edge, the largest
    offset off the edge's axis, edge key (N,))."""
    dev = bounds.device
    res = torch.tensor(list(vol_res), device=dev, dtype=torch.float32)
    voxel = (bounds[1] - bounds[0]) / res
    v = torch.as_tensor(verts, device=dev, dtype=torch.float32)
    g = (v - bounds[0]) / voxel - 0.5
    r = g.round()
    frac = (g - r).abs()
    axis = frac.argmax(-1)
    ga = g.gather(1, axis[:, None])[:, 0]
    lo = r.scatter(1, axis[:, None], ga.floor()[:, None])
    t = ga - ga.floor()
    hi = lo.scatter_add(1, axis[:, None], torch.ones_like(t)[:, None])
    maxi = res.long() - 1
    ia = torch.minimum(lo.long().clamp_min(0), maxi)
    ib = torch.minimum(hi.long().clamp_min(0), maxi)
    off = frac.scatter(1, axis[:, None], torch.zeros_like(t)[:, None])
    return g, ia, ib, t, off.max(-1).values, _keys(ia, axis, vol_res)


def _keys(lo: torch.Tensor, axis: torch.Tensor, vol_res) -> torch.Tensor:
    X, Y, Z = vol_res
    return ((lo[:, 0] * Y + lo[:, 1]) * Z + lo[:, 2]) * 3 + axis


def crossing_edges(vol3: torch.Tensor, iso: float):
    """Every axis edge of the grid whose ends lie on either side of the
    iso level ("inside" is value > iso): (lower node (M, 3), axis (M,))."""
    inside = vol3 > iso
    lows, axes = [], []
    for a in range(3):
        n = inside.shape[a] - 1
        cross = inside.narrow(a, 0, n) != inside.narrow(a, 1, n)
        lo = cross.nonzero()
        lows.append(lo)
        axes.append(torch.full((lo.shape[0],), a, dtype=torch.long,
                               device=lo.device))
    return torch.cat(lows), torch.cat(axes)


def emulated_soup(vol3: torch.Tensor, iso: float, bounds: torch.Tensor,
                  vol_res) -> torch.Tensor:
    """A field's vertices as the frame's marching cubes places them: one
    on every crossing edge, the ends' values rounded to bf16 for the
    interpolation, t clamped to [0, 1] (ops/marching_cubes.py). (M, 3)."""
    lo, axis = crossing_edges(vol3, iso)
    step = torch.nn.functional.one_hot(axis, 3)
    hi = lo + step
    bf = torch.bfloat16
    va = vol3[lo[:, 0], lo[:, 1], lo[:, 2]].to(bf).float()
    vb = vol3[hi[:, 0], hi[:, 1], hi[:, 2]].to(bf).float()
    den = vb - va
    t = ((iso - va) / torch.where(den.abs() < 1e-12, torch.ones_like(den),
                                  den)).clamp(0.0, 1.0)
    res = torch.tensor(list(vol_res), device=vol3.device, dtype=torch.float32)
    voxel = (bounds[1] - bounds[0]) / res
    g = lo.float() + step.float() * t[:, None]
    return (g + 0.5) * voxel + bounds[0]


def mesh_gaps(vol: torch.Tensor, verts, bounds: torch.Tensor, vol_res,
              iso: float, vol_control: torch.Tensor = None,
              band: torch.Tensor = None) -> Dict[str, float]:
    """The iso gap and the edge gap of a soup's vertices (3T, 3) against a
    field whose reference values ``vol`` (X*Y*Z,) are given. With
    ``vol_control``, the control's field takes the soup's place: its
    vertices as the frame's marching cubes would place them.

    edge gap: the larger of the share of the soup's edges that the
    reference's field does not cross, and the share of the reference's
    crossing edges that hold no vertex of the soup (at a node: a vertex
    whose t was clamped to an end). With ``band`` (X*Y*Z,) bool, also the
    share of the vertices whose edge has both ends in it."""
    X, Y, Z = vol_res
    vol3 = vol.reshape(X, Y, Z)
    if vol_control is not None:
        verts = emulated_soup(vol_control.reshape(X, Y, Z), iso, bounds,
                              vol_res)
    if len(verts) == 0:
        return {"iso_gap": float("inf"), "edge_gap": 1.0, "off_edge": 1.0}
    g, ia, ib, t, off, key = _edges(verts, bounds, vol_res)
    fa = vol3[ia[:, 0], ia[:, 1], ia[:, 2]]
    fb = vol3[ib[:, 0], ib[:, 1], ib[:, 2]]
    iso_gap = ((1.0 - t) * fa + t * fb - iso).abs()
    lo_r, ax_r = crossing_edges(vol3, iso)
    ref_keys = _keys(lo_r, ax_r, vol_res)
    on_edge = (t > 1e-4) & (t < 1.0 - 1e-4)
    soup_keys = torch.unique(key[on_edge])
    spurious = (~torch.isin(soup_keys, ref_keys)).float().mean() \
        if soup_keys.numel() else torch.tensor(1.0)
    node = torch.where((t >= 1.0 - 1e-4)[:, None], ib, ia)[~on_edge]
    node_keys = torch.unique((node[:, 0] * Y + node[:, 1]) * Z + node[:, 2])
    lo_flat = (lo_r[:, 0] * Y + lo_r[:, 1]) * Z + lo_r[:, 2]
    hi_r = lo_r + torch.nn.functional.one_hot(ax_r, 3)
    hi_flat = (hi_r[:, 0] * Y + hi_r[:, 1]) * Z + hi_r[:, 2]
    held = (torch.isin(ref_keys, soup_keys) | torch.isin(lo_flat, node_keys)
            | torch.isin(hi_flat, node_keys))
    missing = (~held).float().mean() if held.numel() else torch.tensor(1.0)
    extra = {}
    if band is not None:
        flat = band.reshape(X, Y, Z)
        extra["band_share"] = float((flat[ia[:, 0], ia[:, 1], ia[:, 2]]
                                     & flat[ib[:, 0], ib[:, 1], ib[:, 2]]
                                     ).float().mean())
    return {**extra, "iso_gap": float(iso_gap.max()),
            "iso_gap_p999": float(torch.quantile(
                iso_gap[torch.randperm(iso_gap.numel(),
                                       device=iso_gap.device)[:1 << 20]],
                0.999)),
            "edge_gap": float(max(spurious, missing)),
            "spurious": float(spurious), "missing": float(missing),
            "off_edge": float(off.max())}


def layer_gap(want: torch.Tensor, got: torch.Tensor,
              tol: float = 1e-4) -> float:
    """The share of an image's covered pixels (covered on either side)
    whose value differs by more than ``tol`` in some channel."""
    covered = (want != 0).any(-1) | (got != 0).any(-1)
    off = ((want - got).abs() > tol).any(-1) & covered
    return float(off.sum()) / max(1, int(covered.sum()))


def representatives(verts: np.ndarray, bounds: torch.Tensor, vol_res
                    ) -> np.ndarray:
    """The first slot of each grid edge's group of soup slots: the slot
    whose normal the frame's deduped color ray used."""
    key = _edges(verts, bounds, vol_res)[5].cpu().numpy()
    return np.unique(key, return_index=True)[1]


def check_frame(ref: CaptureReference, frame: dict, out: dict,
                w_recon: bool, w_nerf: bool, n_color: int,
                rng: np.random.Generator, control=None) -> Dict[str, float]:
    """The numbers of one frame (see the module docstring). ``frame``: the
    frame's inputs (pos map, joint mats, inferred normal, neck vertex);
    ``out``: its host outputs (loops/capture.HostOutputs, as arrays).
    ``control``: a context (reference/precision.py) in which the
    reference, computed a precision lower, takes the program's place: at
    the frame's own edges, images and sampled vertices."""
    bounds, res = ref.statics.cano_bounds, ref.grid["vol_res"]
    dev = ref.device

    def lowered(fn, *args):
        if control is None:
            return None
        with control():
            return fn(*args)

    feat = ref.pose_features(frame["smpl_pos_map"])
    feat_c = lowered(ref.pose_features, frame["smpl_pos_map"])
    vol = ref.avatar_volume(feat)
    vol_c = lowered(ref.avatar_volume, feat_c)
    a = mesh_gaps(vol, out["cano_v"], bounds, res, ref.iso, vol_c)
    del vol, vol_c
    nums = {"avatar_" + k: v for k, v in a.items()}
    jm = frame["cano2live_jnt_mats"]

    def skin_gap(v_key, live_key):
        want = ref.skin(out[v_key], jm)
        got = lowered(ref.skin, out[v_key], jm)
        if got is None:
            got = torch.as_tensor(out[live_key], device=dev)
        return float((want - got).abs().max())

    nums["avatar_live_gap"] = skin_gap("cano_v", "live_v")
    if w_recon:
        lay_args = (out["cano_v"], out["cano_n"], frame, w_recon)
        want = ref.cano_layers(*lay_args)
        got = lowered(ref.cano_layers, *lay_args)
        if got is None:
            got = {k: torch.as_tensor(out[k], device=dev) for k in want}
        for k in want:
            nums[k + "_gap"] = layer_gap(want[k], got[k])
        nums["layers_gap"] = max(nums[k + "_gap"] for k in want)
        del want, got
        args = (out["front_avatar_normal"], out["front_image_normal"],
                frame["neck_vertex_idx"])
        merged = lowered(ref.merge, *args)
        if merged is None:
            merged = torch.as_tensor(out["front_merged_normal"], device=dev)
        nums["merge_gap"] = float((ref.merge(*args) - merged).abs().max())
        images = (out["front_merged_normal"], out["back_avatar_normal"])
        rvol = ref.recon_volume(*images)
        rvol_c = lowered(ref.recon_volume, *images)
        r = mesh_gaps(rvol, out["recon_v"], bounds, res, 0.5, rvol_c,
                      band=ref.band)
        del rvol, rvol_c
        nums.update({"recon_" + k: v for k, v in r.items()})
        nums["recon_live_gap"] = skin_gap("recon_v", "live_recon_v")
    if w_nerf:
        gaps = []
        for v_key, n_key, c_key in (("cano_v", "cano_n", "avatar_colors"),
                                    ("recon_v", "recon_n", "recon_colors")):
            if c_key not in out or out[v_key].shape[0] == 0:
                continue
            reps = representatives(out[v_key], bounds, res)
            idx = reps[rng.choice(reps.shape[0], min(n_color, reps.shape[0]),
                                  replace=False)]
            v, n = out[v_key][idx], out[n_key][idx]
            got = lowered(ref.ray_colors, feat_c, v, n)
            if got is None:
                got = torch.as_tensor(out[c_key][idx], device=dev)
            gaps.append(float((got - ref.ray_colors(feat, v, n)).abs().max()))
        nums["color_gap"] = max(gaps)
    return nums
