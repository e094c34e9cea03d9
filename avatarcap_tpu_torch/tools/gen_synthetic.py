"""Synthetic subject writer (counterpart of
avatarcap_tpu/tools/gen_synthetic.py).

Writes the on-disk layout the dataset reads (the outputs of the reference's
gen_data/preprocess_training_data.py): dataConfig.yaml, smpl/pose_*.txt and
shape.txt, smpl/smpl_pos_map_*_cano float images, cano_pts_ov/*.npz,
imgs/NNN/{color,mask,depth}_view_*.{jpg,png}, normal_view_* float images and
cams.mat, and cano_base_blend_weight_volume.npy, from a body model and
poses, rendered with the port's rasterizer instead of OpenGL. The numpy
RandomState draws are the JAX writer's, in its order, so one seed gives
the same sampled points. The SMPL forward kinematics runs in torch on the
host CPU (as the dataset's); renders, nearest neighbours and the inside
test run on ``device`` (the card unless the caller names the CPU).
"""

from __future__ import annotations

import math
import os

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

import cv2 as cv  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from avatarcap_tpu_torch.body.smpl import (  # noqa: E402
    SmplParams, canonical_pose, smpl_forward)
from avatarcap_tpu_torch.data.image_io import save_float_image  # noqa: E402
from avatarcap_tpu_torch.device import resolve_device  # noqa: E402
from avatarcap_tpu_torch.ops.inside import points_inside_mesh  # noqa: E402
from avatarcap_tpu_torch.ops.knn import approx_lbs_weights, knn  # noqa: E402
from avatarcap_tpu_torch.ops.se3 import axis_angle_to_matrix  # noqa: E402
from avatarcap_tpu_torch.render.camera import (  # noqa: E402
    cano_front_back_mvp, gl_perspective_projection_matrix)
from avatarcap_tpu_torch.render.visualize import (  # noqa: E402
    render_cano_mesh, render_mesh_single)


def _fk(smpl_params: SmplParams, pose: np.ndarray, shape: np.ndarray):
    """Forward kinematics on the host CPU: (vertices, joints, joint mats),
    numpy float32."""
    with torch.no_grad():
        out = smpl_forward(smpl_params,
                           torch.from_numpy(np.asarray(pose, np.float32)),
                           torch.from_numpy(np.asarray(shape, np.float32)))
    return (out.vertices.numpy(), out.joints.numpy(),
            out.jnt_affine_mats.numpy())


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def render_smpl_position_map(smpl_params: SmplParams, pose: np.ndarray,
                             shape: np.ndarray, res: int = 256,
                             window: int = 8, device=None) -> np.ndarray:
    """SMPL position map: the canonical body rendered front and back with
    its posed (root-centered, zero-global, zero-hand) vertex positions as
    attributes, front|back side by side, (res, 2 res, 3) (the reference's
    gen_data/preprocess_training_data.py:382-423)."""
    device = resolve_device(device)
    cano_v = _fk(smpl_params, canonical_pose(), shape)[0]
    center = 0.5 * (cano_v.max(0) + cano_v.min(0))

    pose_ = pose.copy()
    pose_[:6] = 0.0
    pose_[3 + 22 * 3: 6 + 22 * 3] = 0.0
    pose_[3 + 23 * 3: 6 + 23 * 3] = 0.0
    posed_v, posed_j, _ = _fk(smpl_params, pose_, shape)
    posed_v = posed_v - posed_j[0]

    faces = smpl_params.faces
    valid = torch.ones((faces.shape[0],), dtype=torch.bool, device=device)
    mats = [_t(m, device) for m in cano_front_back_mvp(
        center.astype(np.float32))]
    with torch.no_grad():
        front, back = render_cano_mesh(
            _t(cano_v[faces], device), _t(posed_v[faces], device), valid,
            *mats, res=res, window=window)
    return np.concatenate([_np(front), _np(back)], axis=1)


def compute_weight_volume(smpl_params: SmplParams, shape: np.ndarray,
                          voxel: float = 0.025, max_dist: float = 0.08,
                          device=None) -> np.ndarray:
    """Canonical LBS weight volume (X, Y, Z, J) on the reference's arange
    grid (gen_data/preprocess_training_data.py:426-463): Gaussian-KNN
    weights of the canonical body, zero beyond ``max_dist`` of it."""
    device = resolve_device(device)
    v = _fk(smpl_params, canonical_pose(), shape)[0]
    min_xyz = v.min(0)
    max_xyz = v.max(0)
    min_xyz[:2] -= 0.05
    max_xyz[:2] += 0.05
    min_xyz[2] -= 0.15
    max_xyz[2] += 0.15
    xs = np.arange(min_xyz[0], max_xyz[0] + voxel, voxel)
    ys = np.arange(min_xyz[1], max_xyz[1] + voxel, voxel)
    zs = np.arange(min_xyz[2], max_xyz[2] + voxel, voxel)
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                   axis=-1).astype(np.float32)
    X, Y, Z, _ = pts.shape
    flat = _t(pts.reshape(-1, 3), device)
    verts = _t(v, device)
    with torch.no_grad():
        w = approx_lbs_weights(flat, verts, _t(smpl_params.weights, device))
        d2, _ = knn(flat, verts, k=1)
        w = torch.where(d2 > max_dist ** 2, torch.zeros_like(w), w)
    return _np(w).reshape(X, Y, Z, -1).astype(np.float32)


def _rot4(aa) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = axis_angle_to_matrix(
        torch.tensor(aa, dtype=torch.float32)).numpy()
    return m


def orbit_extrinsics(center: np.ndarray, view_idx: int, n_views: int,
                     dist: float = 2.3) -> np.ndarray:
    """Orbit-view extrinsic: trans_center -> rot_y -> rot_x(pi) -> trans_z
    (the reference's gen_data/preprocess_training_data.py:327-351)."""
    ang = 2 * math.pi * view_idx / n_views
    tc = np.eye(4, dtype=np.float32)
    tc[:3, 3] = -np.asarray(center, np.float32)
    tz = np.eye(4, dtype=np.float32)
    tz[2, 3] = dist
    return tz @ _rot4([math.pi, 0.0, 0.0]) @ _rot4([0.0, ang, 0.0]) @ tc


def _write_depth(img_dir, view_idx, pos, extr):
    """Camera-space z of the position pass in millimetres, uint16."""
    world = _np(pos.attrs)
    camz = (world @ extr[:3, :3].T + extr[:3, 3])[..., 2]
    camz = np.where(_np(pos.mask), camz, 0.0)
    cv.imwrite(os.path.join(img_dir, f"depth_view_{view_idx:03d}.png"),
               (1000 * camz).astype(np.uint16))


def render_textured_orbit_views(verts: np.ndarray, faces: np.ndarray,
                                colors: np.ndarray, img_dir: str,
                                cam: dict, n_views: int = 60,
                                dist: float = 2.3, window: int = 8,
                                device=None):
    """Orbit color / depth / mask views of a textured scan and cams.mat
    (the reference's gen_data/preprocess_training_data.py:314-379): the
    color pass interpolates raw vertex colors (float RGB in [0, 1]; uint8
    values are rescaled), the position pass gives the mask and the
    camera-space depth in millimetres."""
    import scipy.io as sio

    device = resolve_device(device)
    os.makedirs(img_dir, exist_ok=True)
    colors = np.asarray(colors, np.float32)
    if colors.max() > 1.1:  # uint8-style colors (reference :336-338)
        colors = colors / 255.0
    img_w, img_h = int(cam["img_width"]), int(cam["img_height"])
    proj = gl_perspective_projection_matrix(
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], img_w, img_h)
    center = 0.5 * (verts.max(0) + verts.min(0))
    tris = _t(verts[faces], device)
    color_tris = _t(colors[faces], device)
    valid = torch.ones((len(faces),), dtype=torch.bool, device=device)

    cam_rs, cam_ts = [], []
    for view_idx in range(n_views):
        extr = orbit_extrinsics(center, view_idx, n_views, dist)
        mvp, mv = _t(proj @ extr, device), _t(extr, device)
        with torch.no_grad():
            out = render_mesh_single(tris, color_tris, valid, mvp, mv,
                                     img_h, img_w, window=window)
            pos = render_mesh_single(tris, tris, valid, mvp, mv, img_h,
                                     img_w, window=window)
        img = np.where(_np(out.mask)[..., None], _np(out.attrs), 0.0)
        cv.imwrite(os.path.join(img_dir, f"color_view_{view_idx:03d}.jpg"),
                   (255 * np.clip(img[..., ::-1], 0, 1)).astype(np.uint8))
        cv.imwrite(os.path.join(img_dir, f"mask_view_{view_idx:03d}.png"),
                   (255 * _np(pos.mask)).astype(np.uint8))
        _write_depth(img_dir, view_idx, pos, extr)
        cam_rs.append(cv.Rodrigues(extr[:3, :3])[0][:, 0])
        cam_ts.append(extr[:3, 3])
    sio.savemat(os.path.join(img_dir, "cams.mat"),
                {"cam_rs": np.stack(cam_rs), "cam_ts": np.stack(cam_ts)})


def generate_subject(out_dir: str, smpl_params: SmplParams,
                     shape: np.ndarray, poses: np.ndarray,
                     n_views: int = 4, img_size: int = 128,
                     pos_map_res: int = 64,
                     sur_pts_count: int = 20000, vol_pts_count: int = 2000,
                     seed: int = 0, device=None):
    """Write a full synthetic subject.

    The "scan" of each pose is the posed body mesh itself; the SDF labels
    are signed distances to dense canonical surface samples, positive
    inside (sign from the ray-parity inside test), in place of the
    reference's exact igl SDF.
    """
    import scipy.io as sio

    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "smpl"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "cano_pts_ov"), exist_ok=True)

    np.savetxt(os.path.join(out_dir, "smpl/shape.txt"), shape)

    cam = {"fx": float(5 * img_size), "fy": float(5 * img_size),
           "cx": img_size / 2.0, "cy": img_size / 2.0,
           "img_width": img_size, "img_height": img_size}
    with open(os.path.join(out_dir, "dataConfig.yaml"), "w") as f:
        yaml.safe_dump({"data_type": "synthetic", "camera": cam,
                        "pos_map_name": "cano",
                        "pos_map_res": pos_map_res}, f)

    cano_v = _fk(smpl_params, canonical_pose(), shape)[0]
    faces = smpl_params.faces

    # dense canonical surface samples for the SDF labels
    tri_v = cano_v[faces]                                  # (F, 3, 3)
    areas = 0.5 * np.linalg.norm(
        np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]),
        axis=-1)
    probs = areas / areas.sum()

    def sample_surface(n):
        fid = rng.choice(len(faces), n, p=probs)
        r1, r2 = rng.uniform(size=(2, n))
        s = np.sqrt(r1)
        bary = np.stack([1 - s, s * (1 - r2), s * r2], axis=-1)
        return (tri_v[fid] * bary[..., None]).sum(1).astype(np.float32)

    dense = _t(sample_surface(100000), device)
    tri_dev = _t(tri_v, device)

    def signed_distance(pts):
        q = _t(pts, device)
        with torch.no_grad():
            d2, _ = knn(q, dense, k=1)
            inside = points_inside_mesh(q, tri_dev)
        d = _np(d2[:, 0].sqrt())
        return np.where(_np(inside), d, -d)  # inside-positive (reference :306)

    proj = gl_perspective_projection_matrix(
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], img_size, img_size)
    valid = torch.ones((len(faces),), dtype=torch.bool, device=device)
    for i, pose in enumerate(poses):
        np.savetxt(os.path.join(out_dir, f"smpl/pose_{i:04d}.txt"), pose)

        # position map, front|back side by side (res x 2 res; the dataset
        # resizes and splits it)
        pm = render_smpl_position_map(smpl_params, pose, shape,
                                      res=pos_map_res, device=device)
        save_float_image(os.path.join(
            out_dir, f"smpl/smpl_pos_map_{i:04d}_cano"), pm)

        # presampled canonical points + SDF labels (reference :252-311)
        sur = sample_surface(sur_pts_count)
        sur = sur + rng.standard_normal(sur.shape).astype(np.float32) * 0.02
        lo = cano_v.min(0) - 0.2
        hi = cano_v.max(0) + 0.2
        vol = (rng.uniform(size=(vol_pts_count, 3)) * (hi - lo)
               + lo).astype(np.float32)
        np.savez(os.path.join(out_dir, f"cano_pts_ov/{i:03d}.npz"),
                 sur_pts=sur, sur_pts_ov=signed_distance(sur),
                 vol_pts=vol, vol_pts_ov=signed_distance(vol))

        # orbit renders (reference :314-379)
        live_v = _fk(smpl_params, pose, shape)[0]
        img_dir = os.path.join(out_dir, f"imgs/{i:03d}")
        os.makedirs(img_dir, exist_ok=True)
        center = 0.5 * (live_v.max(0) + live_v.min(0))
        tris = _t(live_v[faces], device)
        normals_live = _t(_vertex_normal_tris(live_v, faces), device)
        cam_rs, cam_ts = [], []
        for view_idx in range(n_views):
            extr = orbit_extrinsics(center, view_idx, n_views)
            mvp, mv = _t(proj @ extr, device), _t(extr, device)
            with torch.no_grad():
                out = render_mesh_single(tris, normals_live, valid, mvp, mv,
                                         img_size, img_size, window=8,
                                         shading="phong")
                pos = render_mesh_single(tris, tris, valid, mvp, mv,
                                         img_size, img_size, window=8)
                nrm = render_mesh_single(tris, normals_live, valid, mvp, mv,
                                         img_size, img_size, window=8)
            mask = _np(out.mask)
            img = np.where(mask[..., None], _np(out.attrs), 0.0)
            cv.imwrite(os.path.join(img_dir,
                                    f"color_view_{view_idx:03d}.jpg"),
                       (255 * img[..., ::-1]).astype(np.uint8))
            cv.imwrite(os.path.join(img_dir, f"mask_view_{view_idx:03d}.png"),
                       (255 * mask).astype(np.uint8))
            _write_depth(img_dir, view_idx, pos, extr)
            # camera-space normal map (the capture's fusion input,
            # reference main.py:409-412), y and z flipped back at
            # consumption (normal_fusion.py:57)
            ncam = _np(nrm.attrs) @ extr[:3, :3].T
            ncam[..., 1:] *= -1.0
            ncam = np.where(_np(nrm.mask)[..., None], ncam, 0.0)
            save_float_image(os.path.join(
                img_dir, f"normal_view_{view_idx:03d}"),
                ncam.astype(np.float32))
            cam_rs.append(cv.Rodrigues(extr[:3, :3])[0][:, 0])
            cam_ts.append(extr[:3, 3])
        sio.savemat(os.path.join(img_dir, "cams.mat"),
                    {"cam_rs": np.stack(cam_rs), "cam_ts": np.stack(cam_ts)})

    np.save(os.path.join(out_dir, "cano_base_blend_weight_volume.npy"),
            compute_weight_volume(smpl_params, shape, device=device))


def _vertex_normal_tris(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, expanded to (F, 3, 3) soup attrs."""
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    return vn[faces].astype(np.float32)
