"""Full-size workloads on the toy body (counterpart of
avatarcap_tpu/tools/bench_workloads.py:22-106, :286-424 and :427-470:
``toy_avatar_statics``, ``build_capture_grid``, the networks, the capture
options, the frame's camera inputs and ``build_train_env``).

The capture workload of the repo: a 384 x 384 x 128 canonical grid
(~18.9 M nodes) over the toy body densified to 6,752 vertices (real SMPL
has 6,890; KNN cost scales with the vertex count), GeoTexAvatar and
ReconNet at their published widths with random weights, and the JAX
bench's capture camera. The training workload: a batch of 4 items of
1,024 rays x 64 samples and 5,000 + 312 geometry points each, on a
256^2 x 6 position map.
"""

from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from avatarcap_tpu_torch.body.smpl import canonical_pose, smpl_forward
from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.layers import WeightNormPointConv1d
from avatarcap_tpu_torch.models.recon import ReconNetwork
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.ops.knn import knn
from avatarcap_tpu_torch.ops.se3 import axis_angle_to_matrix
from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
from avatarcap_tpu_torch.pipeline.capture import CaptureGrid
from avatarcap_tpu_torch.utils.toy_body import make_toy_smpl_params


# The capture options of the JAX package's capture workload
# (avatarcap_tpu/tools/bench_workloads.py:368-395): static capacities sized
# to the fitted bench body, and the texture path's unique-vertex
# capacities, direct ReconNet colors and 32k-ray chunks.
CAPTURE_OPTIONS = dict(
    max_tris=(1 << 19) + (1 << 16),            # 589,824
    max_active=(1 << 18) + (1 << 15),          # 294,912
    refine_capacity=(1 << 20) + (1 << 19) + (1 << 18) + (1 << 17),
    recon_max_tris=(1 << 18) + (1 << 15),      # 294,912
    recon_max_active=(1 << 17) + (1 << 14),    # 147,456
    recon_refine_capacity=1 << 18,             # 262,144
    raster_max_candidates=1 << 16,
    skin_row_group=3, render_res=512, hierarchical_query=True,
    fusion_iters=100, integrate_manner="merge",
    normal_mode="trilinear", use_fused_query=True,
    nerf_unique_capacity=(1 << 18) + (1 << 15),  # 294,912
    recon_unique_capacity=1 << 17,             # 131,072
    recon_color_mode="direct", nerf_chunk=1 << 15)


def toy_avatar_statics(dense: bool = True, device="cpu"):
    """Toy body + AvatarStatics at benchmark fidelity.

    Returns (params, statics, cano_vertices (V, 3) numpy)."""
    kw = dict(n_lat=77, n_lon=90) if dense else {}
    params = make_toy_smpl_params(**kw)
    cano = smpl_forward(params, torch.as_tensor(canonical_pose()),
                        torch.zeros(10))
    v = cano.vertices.numpy()
    # cano bounds: AABB + 5 cm in x/y, 15 cm in z
    lo = v.min(0) - np.array([0.05, 0.05, 0.15], np.float32)
    hi = v.max(0) + np.array([0.05, 0.05, 0.15], np.float32)
    # a 2.5 cm weight volume with uniform root weights
    res_w = np.maximum(((hi - lo) / 0.025).astype(np.int32), 2)
    wv = np.zeros(tuple(res_w) + (params.num_joints,), np.float32)
    wv[..., 0] = 1.0
    statics = AvatarStatics(
        weight_volume=torch.as_tensor(wv),
        cano_smpl_vertices=cano.vertices,
        smpl_skinning_weights=torch.as_tensor(params.weights),
        cano_bounds=torch.as_tensor(np.stack([lo, hi])),
        cano_smpl_center=torch.as_tensor(0.5 * (lo + hi))).to(device)
    return params, statics, v


def random_avatar(generator: torch.Generator) -> GeoTexAvatar:
    """GeoTexAvatar at its published widths with every weight drawn from
    ``generator``: LeCun-uniform weights, U(-0.1, 0.1) biases, BatchNorm
    statistics around (0, 1). The offset head is U(+-0.002), so warps are
    a few cm (a trained warp's scale), and the geometry head U(+-0.1), so
    the field is not the +-1e-5 init noise around the iso level.
    Untrained all the same: its iso-surface is a random field."""
    model = GeoTexAvatar()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                bound = (3.0 / p[0].numel()) ** 0.5
                p.uniform_(-bound, bound, generator=generator)
            elif ".bn" in name and name.endswith(".weight"):
                p.uniform_(0.8, 1.2, generator=generator)
            else:
                p.uniform_(-0.1, 0.1, generator=generator)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.uniform_(-0.1, 0.1, generator=generator)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=generator)
        head = model.warping_field.out_layer_coord_affine
        head.weight.uniform_(-0.002, 0.002, generator=generator)
        head.bias.uniform_(-0.002, 0.002, generator=generator)
        model.cano_template.geo_mlp.fc_list[1].weight.uniform_(
            -0.1, 0.1, generator=generator)
    return model.eval()


def random_tex_avatar(avatar: GeoTexAvatar,
                      generator: torch.Generator) -> GeoTexAvatar:
    """A texture avatar for the NeRF colors: a copy of ``avatar`` whose
    density row of the geometry head is redrawn, U(-1, 1) weights and a
    bias of 4, so the color rays carry O(0.1) colors rather than the
    geometry head's faint density. The geometry (the occupancy row and
    everything before the head) is the avatar's."""
    tex = copy.deepcopy(avatar)
    head = tex.cano_template.geo_mlp.fc_list[1]
    with torch.no_grad():
        head.weight[1].uniform_(-1.0, 1.0, generator=generator)
        head.bias[1] = 4.0
    return tex.eval()


def random_recon(generator: torch.Generator) -> ReconNetwork:
    """ReconNetwork at its published widths (HGFilter stack 1, depth 4,
    256 channels, GroupNorm(32); the weight-normed 33 -> 512 -> 256 ->
    128 -> 1 decoder) with every weight drawn from ``generator``:
    LeCun-uniform conv and weight-norm directions with gains equal to
    their norms, GroupNorm scales U(0.8, 1.2), biases U(-0.1, 0.1). The
    decoder head is U(+-0.3) with a zero bias, so the occupancy
    crosses 0.5 inside the near-body band rather than sitting on one
    side of it. Untrained all the same: its iso-surface is a random
    field."""
    def lecun_(w):
        bound = (3.0 / w[0].numel()) ** 0.5
        w.uniform_(-bound, bound, generator=generator)

    model = ReconNetwork()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.GroupNorm):
                m.weight.uniform_(0.8, 1.2, generator=generator)
                m.bias.uniform_(-0.1, 0.1, generator=generator)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
                lecun_(m.weight)
                if m.bias is not None:
                    m.bias.uniform_(-0.1, 0.1, generator=generator)
            elif isinstance(m, WeightNormPointConv1d):
                lecun_(m.weight_v)
                m.weight_g.copy_(m.weight_v.norm(dim=(1, 2), keepdim=True))
                m.bias.uniform_(-0.1, 0.1, generator=generator)
        head = model.image_decoder.fc_list[3]
        head.weight.uniform_(-0.3, 0.3, generator=generator)
        head.bias.zero_()
    return model.eval()


def bench_camera(img_res: int = 512):
    """The JAX bench's capture inputs (avatarcap_tpu/tools/
    bench_workloads.py:403-421) for an img_res^2 image: the camera 2 m in
    front of the body looking +z (w2c_RT = identity with [2, 3] = 2),
    fx = fy = 550 and cx = cy = 256 at 512^2 (scaled with img_res), and an
    inferred normal map that is (0, 0, -1) on its central half and zero
    elsewhere. Returns (w2c_RT (4, 4), camera dict, normal map (H, W, 3)),
    numpy float32."""
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 2.0
    s = img_res / 512.0
    camera = {"fx": 550.0 * s, "fy": 550.0 * s, "cx": 256.0 * s,
              "cy": 256.0 * s}
    normal = np.zeros((img_res, img_res, 3), np.float32)
    q = img_res // 4
    normal[q:img_res - q, q:img_res - q] = [0.0, 0.0, -1.0]
    return w2c, camera, normal


def build_capture_grid(statics: AvatarStatics,
                       vol_res: Tuple[int, int, int] = (384, 384, 128),
                       pad_to: int = 65536):
    """Near-body compacted grid at capture resolution, built on the
    statics' device: valid = within 10 cm of a body vertex; the prior
    outside the band is a radial inside test against the nearest vertex
    (+1 inside, -1 outside). Returns (CaptureGrid, n_valid)."""
    X, Y, Z = vol_res
    dev = statics.cano_bounds.device
    bounds = statics.cano_bounds
    verts = statics.cano_smpl_vertices
    center = statics.cano_smpl_center
    lin = [torch.linspace(0.0, 1.0, r, device=dev) for r in vol_res]
    g = torch.stack(torch.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    pts = g * (bounds[1] - bounds[0]) + bounds[0]
    del g
    d2, idx1 = knn(pts, verts, k=1, chunk=65536)
    valid = d2[:, 0] < 0.1 ** 2
    inside = ((pts - center).norm(dim=-1)
              < (verts[idx1[:, 0]] - center).norm(dim=-1))
    prior = torch.where(valid, torch.zeros((), device=dev),
                        2.0 * inside.float() - 1.0)
    n_valid = int(valid.sum())
    capacity = n_valid + ((-n_valid) % pad_to)
    idx, _, live = compact_mask_indices(valid, capacity)
    valid_idx = torch.where(live, idx, X * Y * Z).to(torch.int32)
    valid_pts = torch.where(live[:, None], pts[idx.long()],
                            torch.zeros((), device=dev))
    return CaptureGrid(valid_pts, valid_idx, prior, tuple(vol_res)), n_valid


def build_capture_subject(device, vol_res=(384, 384, 128), dense=True,
                          seed=0, options=None, img_res=512):
    """The capture workload on ``device``: an AvatarCapture of random
    networks drawn from generators seeded ``seed`` (avatar), ``seed + 1``
    (ReconNet) and ``seed + 2`` (texture avatar) with ``options`` (default
    CAPTURE_OPTIONS), an item (the toy body at rest, identity joint mats,
    a N(0, 0.1) position map at 256^2 from the avatar's generator, the
    bench camera's w2c), the production frame's keyword arguments
    (inferred normal at img_res^2, neck vertex 0, camera) and the grid's
    near-body node count. Returns (capture, item, recon_kw, n_valid)."""
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    params, statics, v = toy_avatar_statics(dense=dense, device=device)
    grid, n_valid = build_capture_grid(statics, vol_res)
    gen = torch.Generator().manual_seed(seed)
    avatar = random_avatar(gen)
    recon = random_recon(torch.Generator().manual_seed(seed + 1))
    tex = random_tex_avatar(avatar, torch.Generator().manual_seed(seed + 2))
    capture = AvatarCapture(avatar, statics, grid, recon=recon,
                            tex_avatar=tex,
                            options=CaptureOptions(**(options
                                                      or CAPTURE_OPTIONS)),
                            device=device)
    pos_map = torch.randn((256, 256, 6), generator=gen) * 0.1
    w2c, camera, inferred = bench_camera(img_res)
    item = {"live_smpl_v": v.astype(np.float32),
            "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                          (params.num_joints, 1, 1)),
            "smpl_pos_map": pos_map.numpy(), "w2c_RT": w2c}
    recon_kw = dict(inferred_normal=inferred, neck_vertex_idx=0,
                    camera=camera)
    return capture, item, recon_kw, n_valid


def train_batch(params, cano_v: np.ndarray, center: np.ndarray,
                batch_size: int = 4, n_rays: int = 1024, n_surf: int = 5000,
                n_vol: int = 312, pos_map_res: int = 256,
                posed: bool = False, seed: int = 0):
    """The training batch of the JAX package's build_train_env as numpy
    arrays, drawn from np.random.RandomState(seed) in its order: random
    position maps, canonical points within 0.3 m of the body center with
    SDF targets in [-0.1, 0.1], random colors, and rays along +z from 2 m
    in front of the center. The joint mats are the identity; ``posed``
    replaces them (after those draws) with seeded rigid transforms, a
    rotation of up to 0.3 rad about a random axis and a shift of up to
    5 cm per joint, and poses the live vertices with them, so that
    inverse skinning has work to do."""
    J = params.num_joints
    B, R, NPTS = batch_size, n_rays, n_surf + n_vol
    rng = np.random.RandomState(seed)
    batch = {
        "live_smpl_v": np.tile(cano_v[None], (B, 1, 1)).astype(np.float32),
        "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                      (B, J, 1, 1)),
        "smpl_pos_map": rng.standard_normal(
            (B, pos_map_res, pos_map_res, 6)).astype(np.float32) * 0.1,
        "cano_pts": (center + rng.uniform(
            -0.3, 0.3, (B, NPTS, 3))).astype(np.float32),
        "cano_pts_ov": rng.uniform(-0.1, 0.1, (B, NPTS)).astype(np.float32),
        "rgb": rng.uniform(0, 1, (B, R, 3)).astype(np.float32),
        "ray_o": np.tile((center + [0, 0, -2.0]).astype(np.float32),
                         (B, R, 1)),
        "ray_d": np.tile(np.array([0, 0, 1], np.float32), (B, R, 1)),
        "near": np.full((B, R), 1.5, np.float32),
        "far": np.full((B, R), 2.5, np.float32),
        "depth": np.zeros((B, R), np.float32),
    }
    if posed:
        axis = rng.standard_normal((B, J, 3))
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        angle = rng.uniform(-0.3, 0.3, (B, J, 1))
        rot = axis_angle_to_matrix(torch.as_tensor(axis * angle)).numpy()
        mats = np.tile(np.eye(4), (B, J, 1, 1))
        mats[:, :, :3, :3] = rot
        mats[:, :, :3, 3] = rng.uniform(-0.05, 0.05, (B, J, 3))
        mats = mats.astype(np.float32)
        vmats = (params.weights @ mats.reshape(B, J, 16)).reshape(
            B, -1, 4, 4)
        batch["cano2live_jnt_mats"] = mats
        batch["live_smpl_v"] = (
            np.einsum("bvxy,vy->bvx", vmats[..., :3, :3], cano_v)
            + vmats[..., :3, 3]).astype(np.float32)
    return batch


def build_train_env(batch_size: int = 4, n_rays: int = 1024,
                    n_samples: int = 64, n_surf: int = 5000,
                    n_vol: int = 312, pos_map_res: int = 256,
                    dense: bool = True, posed: bool = False, seed: int = 0,
                    device=None, net_ckpt_dir: str = "train_ckpt"):
    """The repo's training-step workload (the JAX package's
    build_train_env): GeoTexAvatar at its published widths
    (random_avatar from torch.Generator(seed), in training mode), the toy
    body (densified with ``dense``) and its statics, the batch of
    train_batch as tensors on ``device`` (the card unless the caller
    names the CPU), and an AvatarTrainer with its initial state.
    Returns dict(trainer, state, batch, statics, model, params)."""
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    device = resolve_device(device)
    params, statics, v = toy_avatar_statics(dense=dense)
    model = random_avatar(torch.Generator().manual_seed(seed))
    center = statics.cano_smpl_center.numpy()
    batch = train_batch(params, v, center, batch_size, n_rays, n_surf,
                        n_vol, pos_map_res, posed, seed)
    trainer = AvatarTrainer(statics=statics, net_ckpt_dir=net_ckpt_dir,
                            n_samples=n_samples, device=device)
    state = trainer.init_state(model)
    return {"trainer": trainer, "state": state, "model": model,
            "batch": {k: torch.from_numpy(a).to(device)
                      for k, a in batch.items()},
            "statics": trainer.statics, "params": params}
