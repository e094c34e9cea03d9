"""Offline training / real-data preprocessing (counterpart of
avatarcap_tpu/tools/preprocess.py).

Scan pipeline per subject (the reference's
gen_data/preprocess_training_data.py):
1. canonicalize: barycentric LBS from the closest body triangle, inverse
   skinning, two-space normal-agreement culling;
2. non-rigid ICP of the subdivided body template to the canonical scan
   (an embedded-deformation node graph, Adam in optax's order);
3. inpaint template points where the scan is missing;
4. watertight reconstruction: the screened Poisson solve (ops/poisson.py),
   or the KNN-plane TSDF;
5. curvature-adaptive point presampling, labelled by the host BVH's exact
   signed distance (native/);
6. orbit renders, position maps and the LBS weight volume
   (tools/gen_synthetic.py).

Real-data pipeline (the reference's gen_data/preprocess_real_data.py):
a square crop by the projected body, pix2pixHD normal inference, paste
back, position maps, dataConfig.yaml.

The device work (the body model, nearest neighbours, closest points, the
fit, Poisson, the renders, the generator) runs on ``device``: the card
unless the caller names the CPU, never the CPU on its own. The host keeps
what the JAX package keeps on the host: the node sampling (numpy + a
KD-tree), the subdivision, the vertex normals, the random draws, the
crops and masks (numpy + OpenCV), and the exact BVH (C++). Each nearest-
neighbour search bounds its distance tile (``knn.knn_chunk``); a smaller
chunk changes no result.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Optional

import numpy as np
import torch
import yaml

from avatarcap_tpu_torch.body.skinning import blend_joint_mats
from avatarcap_tpu_torch.body.smpl import (SmplParams, canonical_pose,
                                           smpl_forward)
from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.native import MeshBVH
from avatarcap_tpu_torch.ops.adam import Adam
from avatarcap_tpu_torch.ops.closest_point import closest_point_on_mesh
from avatarcap_tpu_torch.ops.knn import knn, knn_chunk
from avatarcap_tpu_torch.ops.marching_cubes import marching_tets
from avatarcap_tpu_torch.ops.poisson import poisson_reconstruct
from avatarcap_tpu_torch.ops.se3 import axis_angle_to_matrix, rigid_inverse
from avatarcap_tpu_torch.utils.timers import Tracer, stage, stage_seconds

# the embedded-deformation graph's node spacing (the reference's
# nonrigid_fitting.py default)
NODE_RADIUS = 0.008


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _rotate(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(N, >=3, >=3) mats' 3 x 3 blocks applied to (N, 3) vectors."""
    return (mats[..., :3, :3] * vecs[..., None, :]).sum(-1)


def _nearest_d2(queries: torch.Tensor, database: torch.Tensor
                ) -> torch.Tensor:
    """(N,) squared distance of each query to its nearest database point."""
    with torch.no_grad():
        d2, _ = knn(queries, database, k=1,
                    chunk=knn_chunk(database.shape[0]))
    return d2[:, 0]


def _face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    t = verts[faces]
    n = torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0], dim=-1)
    return n / (n.norm(dim=-1, keepdim=True) + 1e-16)


def _cano_vertices(smpl_params: SmplParams, shape: np.ndarray,
                   device) -> np.ndarray:
    with torch.no_grad():
        out = smpl_forward(smpl_params, _t(canonical_pose(), device),
                           _t(shape, device))
    return _np(out.vertices)


# ---------------------------------------------------------------------------
# 1. Scan canonicalization
# ---------------------------------------------------------------------------

def canonicalize_scan(scan_v: np.ndarray, scan_n: np.ndarray,
                      smpl_pose: np.ndarray, smpl_shape: np.ndarray,
                      smpl_params: SmplParams, device=None):
    """Inverse-skin a live scan to canonical space with normal culling
    (the reference's preprocess_training_data.py:47-103): each point takes
    the blend weights of its closest posed-body point, and is kept where
    its normal agrees with that body face's in both spaces.

    Returns (cano_v, cano_n) numpy of the surviving points.
    """
    device = resolve_device(device)
    pose = smpl_pose.copy()
    pose[-12:] = 0.0  # zero hands (reference :56-57)
    sn_np = scan_n / (np.linalg.norm(scan_n, axis=-1, keepdims=True)
                      + 1e-16)
    with torch.no_grad():
        shape = _t(smpl_shape, device)
        live = smpl_forward(smpl_params, _t(pose, device), shape)
        cano = smpl_forward(smpl_params, _t(canonical_pose(), device), shape)
        faces = torch.as_tensor(smpl_params.faces, device=device).long()
        sv = _t(scan_v, device)
        cp = closest_point_on_mesh(sv, live.vertices, faces)
        fid = cp.face_idx.long()
        tri_lbs = _t(smpl_params.weights, device)[faces[fid]]   # (N, 3, J)
        lbs = (cp.bary[..., None] * tri_lbs).sum(1)

        live2cano = cano.jnt_affine_mats @ rigid_inverse(
            live.jnt_affine_mats)
        vmats = blend_joint_mats(lbs, live2cano)
        sn = _t(sn_np, device)
        cano_v = _rotate(vmats, sv) + vmats[:, :3, 3]
        cano_n = _rotate(vmats, sn)

        fn_live = _face_normals(live.vertices, faces)[fid]
        fn_cano = _face_normals(cano.vertices, faces)[fid]
        keep = (((fn_live * sn).sum(-1) > 0)
                & ((fn_cano * cano_n).sum(-1) > 0))
    return _np(cano_v[keep]), _np(cano_n[keep])


# ---------------------------------------------------------------------------
# 2. Non-rigid embedded-deformation ICP
# ---------------------------------------------------------------------------

def sample_nodes_even(verts: np.ndarray, radius: float,
                      seed: int = 0) -> np.ndarray:
    """Approximate even surface sampling: shuffled greedy radius rejection
    (the reference's trimesh.sample_surface_even, nonrigid_fitting.py:25),
    on the host as the JAX package has it, so the nodes are its nodes:
    (1) the first point in shuffled order of every radius-sized voxel,
    (2) a greedy maximal set among those, from KD-tree neighbour lists."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(verts))
    v = verts[order].astype(np.float32)

    keys = np.floor(v / radius).astype(np.int64)
    keys -= keys.min(0)
    flat = (keys[:, 0] * (keys[:, 1].max() + 1)
            + keys[:, 1]) * (keys[:, 2].max() + 1) + keys[:, 2]
    _, first = np.unique(flat, return_index=True)
    reps = v[np.sort(first)]                 # shuffled order preserved

    from scipy.spatial import cKDTree
    neigh = cKDTree(reps).query_ball_point(reps, r=radius)
    kept = np.zeros(len(reps), bool)
    for i in range(len(reps)):
        kept[i] = not any(j < i and kept[j] for j in neigh[i])
    return reps[kept]


def nonrigid_fit(template_v: np.ndarray, template_n: np.ndarray,
                 target_v: np.ndarray, target_n: np.ndarray,
                 node_radius: float = NODE_RADIUS, iterations: int = 200,
                 lr: float = 2e-3, lambda_icp: float = 1.0,
                 lambda_smooth: float = 0.5, seed: int = 0, device=None):
    """Embedded-deformation ICP (the reference's
    gen_data/nonrigid_fitting.py, with Adam as the JAX package runs it).

    Per-node axis-angle + translation; vertices skinned by inverse-
    distance weights of their nearest nodes (the nearest one dropped, as
    the JAX package does); a point-to-plane data term on the first of the
    4 nearest target points that passes the distance and normal gates
    (distance 0.1 before step 100, then 0.05; normals within 45 deg); an
    ARAP-like smoothness over 8 node neighbours. The target search takes
    no gradient.

    Returns the deformed template vertices (V, 3) numpy.
    """
    device = resolve_device(device)
    nodes_np = sample_nodes_even(template_v, node_radius, seed)
    n_nodes = len(nodes_np)
    nodes = _t(nodes_np, device)
    tv, tn = _t(template_v, device), _t(template_n, device)
    tar_v, tar_n = _t(target_v, device), _t(target_n, device)
    with torch.no_grad():
        _, nidx = knn(nodes, nodes, k=min(9, n_nodes))
        node_nbrs = nidx[:, 1:]
        d2, vidx = knn(tv, nodes, k=min(5, n_nodes))
        d2, vidx = d2[:, 1:], vidx[:, 1:]
        w = 1.0 / torch.sqrt(d2.clamp_min(1e-12))
        w = w / (w.sum(-1, keepdim=True) + 1e-16)
    icp_chunk = knn_chunk(len(target_v), min(65536, len(template_v)))
    slot = torch.arange(4, device=device)

    def deform(aa, tr):
        R = axis_angle_to_matrix(aa[vidx])               # (V, k, 3, 3)
        Rv = (w[..., None, None] * R).sum(1)
        tvtx = (w[..., None] * tr[vidx]).sum(1)
        return _rotate(Rv, tv) + tvtx, _rotate(Rv, tn)

    def icp_loss(lv, ln, dist_thres, normal_thres):
        # the first acceptable of the 4 nearest target points
        # (reference nonrigid_fitting.py:98-124)
        with torch.no_grad():
            _, ki = knn(lv, tar_v, k=4, chunk=icp_chunk)
        kv, kn = tar_v[ki], tar_n[ki]                    # (V, 4, 3)
        dist_ok = (lv[:, None] - kv).norm(dim=-1) < dist_thres
        norm_ok = (ln[:, None, :] * kn).sum(-1) > normal_thres
        ok = dist_ok & norm_ok
        first = torch.where(ok, slot, 4).amin(-1)
        any_ok = first < 4
        pick = first.clamp_max(3)[:, None, None].expand(-1, 1, 3)
        sel_v = kv.gather(1, pick)[:, 0]
        sel_n = kn.gather(1, pick)[:, 0]
        v2n = ((lv - sel_v) * sel_n).sum(-1)
        return torch.where(any_ok, v2n * v2n, torch.zeros_like(v2n)).sum()

    def smooth_loss(aa, tr):
        live_nodes = _rotate(axis_angle_to_matrix(aa), nodes) + tr
        Rn = axis_angle_to_matrix(aa[node_nbrs])         # (n, 8, 3, 3)
        driven = _rotate(Rn, nodes[:, None, :]) + tr[node_nbrs]
        return ((live_nodes[:, None] - driven) ** 2).sum()

    aa = torch.zeros((n_nodes, 3), device=device)
    tr = torch.zeros((n_nodes, 3), device=device)
    adam = Adam([aa, tr])
    ct = math.cos(math.pi / 4)
    for it in range(iterations):
        # gating schedule (reference nonrigid_fitting.py:166-175)
        dist_thres = 0.1 if it < 100 else (0.05 if it <= 250 else 0.02)
        params = [aa.detach().requires_grad_(), tr.detach().requires_grad_()]
        lv, ln = deform(*params)
        loss = (lambda_icp * icp_loss(lv, ln, dist_thres, ct)
                + lambda_smooth * smooth_loss(*params))
        grads = torch.autograd.grad(loss, params)
        aa, tr = adam.step([aa, tr], grads, lr)
    with torch.no_grad():
        lv, _ = deform(aa, tr)
    return _np(lv)


# ---------------------------------------------------------------------------
# 4. Watertight reconstruction: the KNN-plane TSDF
# ---------------------------------------------------------------------------

def watertight_from_points(points: np.ndarray, normals: np.ndarray,
                           voxel: float = 0.01, pad: float = 0.05,
                           trunc: float = 0.02, k: int = 8,
                           max_tris: int = 1 << 20, device=None):
    """Watertight mesh from an oriented point cloud: SDF(x) is the
    inverse-square-distance-weighted mean of the k nearest points' plane
    distances dot(n_i, p_i - x) (inside-positive), truncated to +-trunc;
    the surface is its zero crossing (marching tets).

    Returns (verts (3 * num_tris, 3) soup, num_tris).
    """
    device = resolve_device(device)
    lo = points.min(0) - pad
    hi = points.max(0) + pad
    res = np.maximum(((hi - lo) / voxel).astype(np.int32), 8)
    lin = [np.linspace(lo[d], hi[d], int(res[d]), dtype=np.float32)
           for d in range(3)]
    g = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)

    pj = _t(points, device)
    nj = _t(normals / (np.linalg.norm(normals, axis=-1, keepdims=True)
                       + 1e-16), device)
    gq = _t(g, device)
    chunk = knn_chunk(len(points))
    with torch.no_grad():
        sdf = []
        for s in range(0, len(g), chunk):
            q = gq[s:s + chunk]
            d2, idx = knn(q, pj, k=k, chunk=q.shape[0])
            plane = (nj[idx] * (pj[idx] - q[:, None])).sum(-1)
            wgt = 1.0 / (d2 + 1e-8)
            wgt = wgt / wgt.sum(-1, keepdim=True)
            sdf.append((wgt * plane).sum(-1).clamp(-trunc, trunc))
        vol = torch.cat(sdf).reshape(int(res[0]), int(res[1]), int(res[2]))
        vox = (hi - lo) / res
        mesh = marching_tets(vol, 0.0, _t(lo, device), _t(vox, device),
                             max_tris=max_tris, max_active=1 << 18)
    nt = int(mesh.num_tris)
    return _np(mesh.vertices[: 3 * nt]), nt


# ---------------------------------------------------------------------------
# 5. Scan -> canonical watertight template (stages 1-4)
# ---------------------------------------------------------------------------

def canonicalize_and_reconstruct(scan_v, scan_n, smpl_pose, smpl_shape,
                                 smpl_params: SmplParams,
                                 subdivide_template: bool = True,
                                 fit_iterations: int = 200,
                                 voxel: float = 0.01,
                                 method: str = "poisson",
                                 poisson_res: int = 256, device=None,
                                 record: Optional[dict] = None):
    """Stages 1-4 of the reference's canonicalize()
    (preprocess_training_data.py:47-184): canonicalize the scan, fit the
    canonical body template to it, add the fitted template's vertices
    more than 1 cm from the scan, reconstruct ('poisson': the screened
    dense-grid solve; 'tsdf': the KNN-plane TSDF) and flag the triangles
    whose three vertices lie within 1 cm of the scan.

    ``record``, when given, is filled with each stage's seconds (a
    Tracer's stage spans: CUDA events on a card), the counts (points kept
    by the culling, nodes, inpainted vertices, triangles, the share of
    original-surface triangles, the template's mean distance to the scan
    before and after the fit, the Poisson mesh's overflow bit) and the
    reconstruction's inputs and output (``reconstruction``: ``points``,
    ``normals``, the soup ``verts``), so that a caller can repeat it.

    Returns (wt_verts soup, num_tris, ori_sur_flag per triangle).
    """
    device = resolve_device(device)
    timer = Tracer(device) if record is not None else None
    with stage(timer, "canonicalize"):
        cano_v, cano_n = canonicalize_scan(scan_v, scan_n, smpl_pose,
                                           smpl_shape, smpl_params,
                                           device=device)
    with stage(timer, "template"):
        tv = _cano_vertices(smpl_params, smpl_shape, device)
        tf = smpl_params.faces
        if subdivide_template:
            tv, tf = subdivide_mesh(tv, tf)
        tn = vertex_normals(tv, tf)
    with stage(timer, "nonrigid_fit"):
        fitted = nonrigid_fit(tv, tn, cano_v, cano_n,
                              iterations=fit_iterations, device=device)
        fitted_n = vertex_normals(fitted, tf)

    scan = _t(cano_v, device)
    with stage(timer, "inpaint"):
        # template vertices > 1 cm from the scan (reference :129-143)
        d2_fit = _nearest_d2(_t(fitted, device), scan)
        inpaint = _np(d2_fit) > 0.01 ** 2
        all_v = np.concatenate([cano_v, fitted[inpaint]])
        all_n = np.concatenate([cano_n, fitted_n[inpaint]])

    with stage(timer, method):
        if method == "poisson":
            wt_verts, nt, mesh = poisson_reconstruct(
                all_v, all_n, res=poisson_res, device=device,
                return_mesh=True)
        else:
            wt_verts, nt = watertight_from_points(all_v, all_n, voxel=voxel,
                                                  device=device)

    with stage(timer, "surface_flag"):
        # original-surface flag per triangle (reference :164-176)
        ori_v = _np(_nearest_d2(_t(wt_verts, device), scan)) < 0.01 ** 2
        tri_flag = ori_v.reshape(-1, 3).all(axis=1)

    if record is not None:
        d2_tv = _nearest_d2(_t(tv, device), scan)
        record["seconds"] = stage_seconds(timer.collect())
        record["counts"] = {
            "scan_points": len(scan_v), "kept_points": len(cano_v),
            "template_vertices": len(tv),
            "nodes": len(sample_nodes_even(tv, NODE_RADIUS)),
            "inpainted_vertices": int(inpaint.sum()),
            "reconstruction_points": len(all_v), "triangles": nt,
            "original_surface_share": float(tri_flag.mean()) if nt else 0.0,
            "template_scan_mean_distance_before":
                float(d2_tv.sqrt().mean()),
            "template_scan_mean_distance_after":
                float(d2_fit.sqrt().mean())}
        if method == "poisson":
            record["counts"]["poisson_overflow"] = bool(mesh.overflow)
        record["reconstruction"] = {"points": all_v, "normals": all_n,
                                    "verts": wt_verts}
    return wt_verts, nt, tri_flag


def subdivide_mesh(verts: np.ndarray, faces: np.ndarray,
                   iterations: int = 1):
    """Midpoint 1-to-4 subdivision (trimesh.remesh.subdivide's
    counterpart), the JAX package's vertex and face order."""
    for _ in range(iterations):
        edges = {}
        new_verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = len(new_verts)
                new_verts.append(0.5 * (verts[a] + verts[b]))
            return edges[key]

        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        verts = np.asarray(new_verts, np.float32)
        faces = np.asarray(new_faces, np.int32)
    return verts, faces


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted unit vertex normals (host numpy)."""
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return (vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-16)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# 6. Point presampling with signed-distance labels (reference :252-311)
# ---------------------------------------------------------------------------

def presample_points(wt_verts: np.ndarray, num_tris: int,
                     ori_tri_flag: np.ndarray,
                     sur_count: int = 2200000, vol_count: int = 10000,
                     sigma: float = 0.02, seed: int = 0, device=None):
    """Curvature-adaptive surface samples and uniform volume samples with
    inside-positive signed-distance labels from the host BVH (a failed
    BVH build raises). The curvature proxy is the face-normal
    disagreement with the nearest of a 1-in-(sur_count / 200,000)
    subsample, found on ``device``.

    Returns (sur, sur_ov, vol, vol_ov) numpy.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    tris = wt_verts[: 3 * num_tris].reshape(-1, 3, 3)
    ok = np.where(ori_tri_flag[:num_tris])[0]
    if len(ok) == 0:
        ok = np.arange(num_tris)
    areas = 0.5 * np.linalg.norm(
        np.cross(tris[ok, 1] - tris[ok, 0], tris[ok, 2] - tris[ok, 0]),
        axis=-1)
    probs = areas / max(areas.sum(), 1e-12)
    fid = ok[rng.choice(len(ok), sur_count, p=probs)]
    r1, r2 = rng.uniform(size=(2, sur_count))
    s = np.sqrt(r1)
    bary = np.stack([1 - s, s * (1 - r2), s * r2], -1).astype(np.float32)
    sur = (tris[fid] * bary[..., None]).sum(1)

    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-16
    step = max(1, sur_count // 200000)
    sub = sur[::step]
    with torch.no_grad():
        _, idx = knn(_t(sur, device), _t(sub, device), k=1,
                     chunk=knn_chunk(len(sub)))
    n_here = fn[fid]
    sub_fid = fid[::step]
    n_near = fn[sub_fid[_np(idx[:, 0])]]
    curv = 1.0 - np.einsum("vi,vi->v", n_here, n_near)
    curv = np.clip(curv / max(curv.max(), 1e-6), 0, 1)
    sigmas = np.where(curv > 0.004, sigma / 5.0, sigma).astype(np.float32)
    sur = (sur + rng.standard_normal(sur.shape).astype(np.float32)
           * sigmas[:, None])

    lo = wt_verts[: 3 * num_tris].min(0) - 0.2
    hi = wt_verts[: 3 * num_tris].max(0) + 0.2
    vol = (rng.uniform(size=(vol_count, 3)) * (hi - lo) + lo) \
        .astype(np.float32)

    faces_soup = np.arange(3 * num_tris, dtype=np.int32).reshape(-1, 3)
    bvh = MeshBVH(wt_verts[: 3 * num_tris], faces_soup)
    try:
        return sur, bvh.signed_distance(sur), vol, bvh.signed_distance(vol)
    finally:
        bvh.close()


# ---------------------------------------------------------------------------
# 7. The per-subject orchestrators
# ---------------------------------------------------------------------------

def preprocess_training_data(data_dir: str, smpl_params: SmplParams,
                             n_views: int = 60, img_size: int = 512,
                             pos_map_res: int = 256,
                             sur_count: int = 2200000,
                             vol_count: int = 10000,
                             fit_iterations: int = 200,
                             voxel: float = 0.01, device=None) -> dict:
    """Per-subject scan preprocessing (the reference's
    preprocess_training_data.py:466-543) on ``device``.

    Input layout: data_dir/scan/NNN.ply + smpl/pose_NNNN.txt +
    smpl/shape.txt. Writes cano_base_blend_weight_volume.npy, per scan
    cano_pts_ov/NNN.npz, imgs/NNN/ orbit renders with cams.mat, the
    position map, and dataConfig.yaml.

    Returns the run's record: the weight volume's seconds and, per scan,
    ``canonicalize_and_reconstruct``'s record plus the presampling,
    render and position-map seconds.
    """
    from avatarcap_tpu_torch.data.image_io import save_float_image
    from avatarcap_tpu_torch.data.mesh_io import load_ply
    from avatarcap_tpu_torch.tools.gen_synthetic import (
        compute_weight_volume, render_smpl_position_map,
        render_textured_orbit_views)

    device = resolve_device(device)
    shape = np.loadtxt(os.path.join(data_dir, "smpl/shape.txt")) \
        .astype(np.float32)
    scan_paths = sorted(glob.glob(os.path.join(data_dir, "scan/*.ply")))
    pose_paths = sorted(glob.glob(os.path.join(data_dir,
                                               "smpl/pose_*.txt")))
    os.makedirs(os.path.join(data_dir, "cano_pts_ov"), exist_ok=True)

    run = {"seconds": {}, "scans": []}
    timer = Tracer(device)
    with timer("weight_volume"):
        np.save(os.path.join(data_dir, "cano_base_blend_weight_volume.npy"),
                compute_weight_volume(smpl_params, shape, device=device))
    run["seconds"] = stage_seconds(timer.collect())

    # reference camera: fx=fy=550 at 512^2 (reference :488-496)
    cam = {"fx": 550.0 * img_size / 512.0, "fy": 550.0 * img_size / 512.0,
           "cx": img_size / 2.0, "cy": img_size / 2.0,
           "img_width": img_size, "img_height": img_size}

    for scan_path, pose_path in zip(scan_paths, pose_paths):
        idx = int(os.path.splitext(os.path.basename(pose_path))[0]
                  .replace("pose_", ""))
        pose = np.loadtxt(pose_path).astype(np.float32)
        verts, faces, normals, colors = load_ply(scan_path)
        if normals is None:
            normals = vertex_normals(verts, faces)
        rec = {"idx": idx}
        wt_verts, nt, ori_flag = canonicalize_and_reconstruct(
            verts, normals, pose, shape, smpl_params,
            fit_iterations=fit_iterations, voxel=voxel, device=device,
            record=rec)
        timer = Tracer(device)
        with timer("presample"):
            sur, sur_ov, vol, vol_ov = presample_points(
                wt_verts, nt, ori_flag, sur_count=sur_count,
                vol_count=vol_count, device=device)
            np.savez(os.path.join(data_dir, f"cano_pts_ov/{idx:03d}.npz"),
                     sur_pts=sur, sur_pts_ov=sur_ov, vol_pts=vol,
                     vol_pts_ov=vol_ov)

        # orbit color / depth / mask views of the TEXTURED live scan, the
        # avatar's RGB supervision (reference :314-379, 520-527)
        with timer("orbit_views"):
            if colors is None:
                # untextured scan: mid-gray so training still gets rgb
                colors = np.full_like(verts, 0.5, dtype=np.float32)
            render_textured_orbit_views(
                verts, faces, colors,
                os.path.join(data_dir, f"imgs/{idx:03d}"), cam,
                n_views=n_views, device=device)
        with timer("position_map"):
            pm = render_smpl_position_map(smpl_params, pose, shape,
                                          res=pos_map_res, device=device)
            save_float_image(os.path.join(
                data_dir, f"smpl/smpl_pos_map_{idx:04d}_cano"), pm)
        rec["seconds"].update(stage_seconds(timer.collect()))
        run["scans"].append(rec)

    with open(os.path.join(data_dir, "dataConfig.yaml"), "w") as f:
        yaml.safe_dump({"data_type": "synthetic", "view_num": n_views,
                        "camera": cam, "pos_map_name": "cano",
                        "pos_map_res": pos_map_res}, f)
    return run


def preprocess_real_data(data_dir: str, smpl_params: SmplParams,
                         generator: Optional[torch.nn.Module] = None,
                         pos_map_res: int = 256, device=None) -> list:
    """Monocular video preprocessing (the reference's
    gen_data/preprocess_real_data.py:46-123): per frame, crop by the
    projected body, infer normals with ``generator`` (a pix2pixHD
    ``GlobalGenerator`` on ``device``; without one no normals are
    written), paste back, save; position maps; dataConfig.yaml
    (data_type 'real').

    Returns one record per frame: its index and each step's seconds.
    """
    import cv2 as cv

    from avatarcap_tpu_torch.data.image_io import save_float_image
    from avatarcap_tpu_torch.tools.gen_synthetic import \
        render_smpl_position_map

    device = resolve_device(device)
    if generator is not None:
        on = {p.device.type for p in generator.parameters()}
        if on != {device.type}:
            raise ValueError(f"the generator's weights are on {on}, the "
                             f"preprocessing runs on {device}")
    with open(os.path.join(data_dir, "dataConfig.yaml"),
              encoding="UTF-8") as f:
        data_config = yaml.safe_load(f)
    cam = data_config["camera"]
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    shape = np.loadtxt(os.path.join(data_dir, "smpl/shape.txt")) \
        .astype(np.float32)
    os.makedirs(os.path.join(data_dir, "imgs/normal"), exist_ok=True)

    records = []
    for pose_path in sorted(glob.glob(
            os.path.join(data_dir, "smpl/pose_*.txt"))):
        idx = int(os.path.splitext(os.path.basename(pose_path))[0]
                  .replace("pose_", ""))
        pose = np.loadtxt(pose_path).astype(np.float32)
        timer = Tracer(device)
        if generator is not None:
            with timer("normal"):
                with torch.no_grad():
                    live_v = _np(smpl_forward(smpl_params, _t(pose, device),
                                              _t(shape, device)).vertices)
                img = cv.imread(os.path.join(
                    data_dir, f"imgs/color/color_{idx:04d}.jpg"))
                mask = cv.imread(os.path.join(
                    data_dir, f"imgs/mask/mask_{idx:04d}.png"),
                    cv.IMREAD_UNCHANGED)
                crop, _, bbox = crop_square_by_smpl(
                    img.astype(np.float32) / 255.0, mask, live_v, K)
                normal = infer_normal_map(generator, crop, mask, bbox,
                                          img.shape[:2])
                save_float_image(os.path.join(
                    data_dir, f"imgs/normal/normal_{idx:04d}"), normal)
        with timer("position_map"):
            pm = render_smpl_position_map(smpl_params, pose, shape,
                                          res=pos_map_res, device=device)
            save_float_image(os.path.join(
                data_dir, f"smpl/smpl_pos_map_{idx:04d}_cano"), pm)
        records.append({"idx": idx,
                        "seconds": stage_seconds(timer.collect())})

    data_config.update({"data_type": "real", "pos_map_name": "cano",
                        "pos_map_res": pos_map_res})
    with open(os.path.join(data_dir, "dataConfig.yaml"), "w") as f:
        yaml.safe_dump(data_config, f)
    return records


def crop_square_by_smpl(img: np.ndarray, mask: np.ndarray,
                        live_smpl_v: np.ndarray, K: np.ndarray,
                        out_size: int = 512, margin: int = 10):
    """Square crop around the projected body (reference :78-95), host
    numpy + OpenCV. Returns (cropped_img, cropped_mask, bbox (x0, y0,
    side))."""
    import cv2 as cv
    proj = live_smpl_v @ K.T
    xy = proj[:, :2] / proj[:, 2:]
    x0, y0 = xy.min(0) - margin
    x1, y1 = xy.max(0) + margin
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    side = max(x1 - x0, y1 - y0)
    x0 = int(round(cx - side / 2))
    y0 = int(round(cy - side / 2))
    side = int(round(side))
    H, W = img.shape[:2]
    pad_img = np.zeros((side, side, 3), img.dtype)
    pad_msk = np.zeros((side, side), mask.dtype)
    sx0, sy0 = max(0, x0), max(0, y0)
    sx1, sy1 = min(W, x0 + side), min(H, y0 + side)
    pad_img[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    pad_msk[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = mask[sy0:sy1, sx0:sx1]
    out_img = cv.resize(pad_img, (out_size, out_size))
    out_msk = cv.resize(pad_msk, (out_size, out_size),
                        interpolation=cv.INTER_NEAREST)
    return out_img, out_msk, (x0, y0, side)


def infer_normal_map(generator: torch.nn.Module, img01: np.ndarray,
                     mask: np.ndarray, bbox, full_shape) -> np.ndarray:
    """pix2pixHD normal inference on the generator's device, pasted back
    to full resolution and masked (reference :97-110). img01: (S, S, 3)
    in [0, 1], BGR as OpenCV reads it; the generator sees it as NCHW in
    the tanh domain, channels in that order."""
    import cv2 as cv
    dev = next(generator.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(img01 * 2.0 - 1.0))
    x = x.to(dev, torch.float32).permute(2, 0, 1)[None]
    with torch.no_grad():
        n = _np(generator(x)[0].permute(1, 2, 0))
    x0, y0, side = bbox
    n_full = np.zeros((*full_shape, 3), np.float32)
    n_res = cv.resize(n, (side, side))
    H, W = full_shape
    sx0, sy0 = max(0, x0), max(0, y0)
    sx1, sy1 = min(W, x0 + side), min(H, y0 + side)
    n_full[sy0:sy1, sx0:sx1] = n_res[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0]
    n_full[mask == 0] = 0.0
    return n_full
