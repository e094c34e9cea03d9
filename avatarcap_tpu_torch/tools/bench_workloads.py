"""Full-size workloads on the toy body (counterpart of
avatarcap_tpu/tools/bench_workloads.py: ``toy_avatar_statics``,
``build_capture_grid``, the fitted subject of ``wrinkle_field``,
``fit_template_to_body`` and ``fit_recon_decoder``, ``build_capture_env``'s
networks, options and camera, and ``build_train_env``).

The capture workload of the repo: a 384 x 384 x 128 canonical grid
(~18.9 M nodes) over the toy body densified to 6,752 vertices (real SMPL
has 6,890; KNN cost scales with the vertex count), GeoTexAvatar and
ReconNet at their published widths, and the JAX bench's capture camera.
By default the networks are fitted to the toy body with 6 mm clothing-fold
wrinkles, as the JAX bench's are, so both iso-surfaces are one wrinkled
body and the capacities of CAPTURE_OPTIONS fit them; ``fit=False`` keeps
the random networks. The training workload: a batch of 4 items of 1,024
rays x 64 samples and 5,000 + 312 geometry points each, on a 256^2 x 6
position map.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from avatarcap_tpu_torch.body.smpl import canonical_pose, smpl_forward
from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.layers import WeightNormPointConv1d
from avatarcap_tpu_torch.models.recon import ReconNetwork
from avatarcap_tpu_torch.ops.adam import Adam
from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
from avatarcap_tpu_torch.ops.knn import knn
from avatarcap_tpu_torch.ops.se3 import axis_angle_to_matrix
from avatarcap_tpu_torch.pipeline.avatar import (AvatarStatics,
                                                 grid_pose_features)
from avatarcap_tpu_torch.pipeline.capture import CaptureGrid
from avatarcap_tpu_torch.utils.toy_body import make_toy_smpl_params

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# fitted state dicts of build_capture_subject, one file per cache key
FIT_CACHE_DIR = os.path.join(_ROOT, "build", "bench_fit")


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


# The small subject (48 x 48 x 32 grid over the sparse toy body, 128^2
# renders) of chip_smoke.py's card-against-CPU checks and of the tools'
# --small runs: the capture workload's options with capacities to match,
# one skinning row per point, 10 merge steps and 4 samples per color ray;
# its fit takes fewer and smaller steps.
SMALL_SUBJECT = dict(vol_res=(48, 48, 32), dense=False, seed=1, img_res=128)
SMALL_CAPTURE_OPTIONS = dict(
    CAPTURE_OPTIONS, max_tris=1 << 15, max_active=1 << 13,
    refine_capacity=1 << 16, recon_max_tris=0, recon_max_active=0,
    recon_refine_capacity=0, raster_max_candidates=0, render_res=128,
    skin_row_group=1, fusion_iters=10, nerf_unique_capacity=1 << 14,
    recon_unique_capacity=1 << 14, n_samples=4)
SMALL_FIT = dict(steps=(300, 100), n_pts=1024, batch=2048)


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


def random_avatar(generator: torch.Generator, **form) -> GeoTexAvatar:
    """GeoTexAvatar at its published widths (``form``: its if_type and
    positional encodings, the capture's by default) with every weight
    drawn from ``generator``: LeCun-uniform weights, U(-0.1, 0.1) biases,
    BatchNorm statistics around (0, 1). The offset head is U(+-0.002), so warps are
    a few cm (a trained warp's scale), and the geometry head U(+-0.1), so
    the field is not the +-1e-5 init noise around the iso level.
    Untrained all the same: its iso-surface is a random field."""
    model = GeoTexAvatar(**form)
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


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``module``'s convolutions, weight-normed layers and
    GroupNorms in place with flax's default initialisers, the JAX bench
    networks' starting point: LeCun-normal kernels (normal truncated at 2
    sigma, rescaled to variance 1 / fan_in), zero biases, weight-norm
    gains of 1, GroupNorm scales of 1 and shifts of 0. Draws on the host
    from ``generator`` in module order."""
    def lecun_(w, fan_in):
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std,
                                      -2.0 * std, 2.0 * std,
                                      generator=generator))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                lecun_(m.weight, m.weight[0].numel())
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WeightNormPointConv1d):
                lecun_(m.weight_v, m.weight_v[0].numel())
                m.weight_g.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module


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
        # drawn on the host (``generator`` is a CPU one), then copied
        head.weight[1].copy_(torch.empty(head.weight[1].shape).uniform_(
            -1.0, 1.0, generator=generator))
        head.bias[1] = 4.0
    return tex.eval()


def random_recon(generator: torch.Generator, **form) -> ReconNetwork:
    """ReconNetwork at its published widths (HGFilter stack 1, depth 4,
    256 channels, GroupNorm(32); the weight-normed 33 -> 512 -> 256 ->
    128 -> 1 decoder), or of another ``form`` (ReconNetwork's keywords,
    e.g. models/recon.PIFU_SHAPE_NETWORK), with every weight drawn from
    ``generator``:
    LeCun-uniform conv and weight-norm directions with gains equal to
    their norms, GroupNorm scales U(0.8, 1.2), biases U(-0.1, 0.1). The
    decoder head is U(+-0.3) with a zero bias, so the occupancy
    crosses 0.5 inside the near-body band rather than sitting on one
    side of it. Untrained all the same: its iso-surface is a random
    field."""
    def lecun_(w):
        bound = (3.0 / w[0].numel()) ** 0.5
        w.uniform_(-bound, bound, generator=generator)

    model = ReconNetwork(**form)
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
        head = model.image_decoder.fc_list[-1]
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


# -- the fitted subject ------------------------------------------------------

def wrinkle_field(q: torch.Tensor, wavelength: float = 0.045) -> torch.Tensor:
    """Unit-amplitude clothing-fold displacement at points ``q`` (N, 3)
    relative to the body center, in meters: two products of plane waves
    along directions off the grid axes, so the folds bend every way."""
    k = 2.0 * math.pi / wavelength
    return (torch.sin(k * (q[:, 0] + 0.37 * q[:, 1]))
            * torch.sin(k * (q[:, 1] - 0.21 * q[:, 2]))
            + 0.6 * torch.sin(k * 1.31 * (q[:, 2] + 0.55 * q[:, 0]))
            * torch.sin(k * 0.77 * q[:, 1]))


def _signed_body_distance(pts, verts, center, wrinkle_amp, wavelength):
    """The toy body's signed nearest-vertex distance (inside-positive:
    closer to the center than the nearest vertex is), displaced by
    ``wrinkle_amp`` x wrinkle_field, and the undisplaced inside flag."""
    d2, idx = knn(pts, verts, k=1)
    inside = ((pts - center).norm(dim=-1)
              < (verts[idx[:, 0]] - center).norm(dim=-1))
    d = torch.sqrt(d2[:, 0].clamp_min(0.0))
    sd = torch.where(inside, d, -d)
    if wrinkle_amp > 0.0:
        # shifting a unit-gradient distance by w moves its zero crossing
        # by ~w: a true displacement of the skin
        sd = sd + wrinkle_amp * wrinkle_field(pts - center, wavelength)
    return sd, inside


def body_sdf_target(pts: torch.Tensor, verts: torch.Tensor,
                    center: torch.Tensor, wrinkle_amp: float = 0.0,
                    wavelength: float = 0.045) -> torch.Tensor:
    """The template fit's target at ``pts`` (N, 3): the (wrinkled) signed
    body distance, clipped to +-5 cm like the trainer's SDF band."""
    sd, _ = _signed_body_distance(pts, verts, center, wrinkle_amp,
                                  wavelength)
    return sd.clamp(-0.05, 0.05)


def body_inside_target(pts: torch.Tensor, verts: torch.Tensor,
                       center: torch.Tensor, wrinkle_amp: float = 0.0,
                       wavelength: float = 0.045) -> torch.Tensor:
    """The ReconNet decoder fit's target at ``pts`` (N, 3): 1.0 inside the
    (wrinkled) body, else 0.0."""
    sd, inside = _signed_body_distance(pts, verts, center, wrinkle_amp,
                                       wavelength)
    return (sd > 0.0 if wrinkle_amp > 0.0 else inside).float()


def template_fit_points(statics: AvatarStatics, n_pts: int,
                        generator: torch.Generator) -> torch.Tensor:
    """One step's points of the template fit, drawn from ``generator`` (on
    the statics' device): n_pts / 2 uniform in the canonical bounds, then
    n_pts / 2 at random body vertices plus 0.03 N(0, 1)."""
    dev = statics.cano_bounds.device
    lo, hi = statics.cano_bounds[0], statics.cano_bounds[1]
    verts = statics.cano_smpl_vertices
    half = n_pts // 2
    pu = torch.rand((half, 3), generator=generator, device=dev) * (hi - lo) + lo
    vi = torch.randint(0, verts.shape[0], (half,), generator=generator,
                       device=dev)
    pn = verts[vi] + 0.03 * torch.randn((half, 3), generator=generator,
                                        device=dev)
    return torch.cat([pu, pn])


def template_fit_loss(avatar: GeoTexAvatar, statics: AvatarStatics,
                      pts: torch.Tensor, wrinkle_amp: float = 0.0,
                      wavelength: float = 0.045) -> torch.Tensor:
    """Mean squared error of the template's occupancy head at ``pts``
    against body_sdf_target (a 0-d tensor; autograd follows the
    template)."""
    tgt = body_sdf_target(pts, statics.cano_smpl_vertices,
                          statics.cano_smpl_center, wrinkle_amp, wavelength)
    _, _, occ = avatar.query_template(pts)
    return ((occ[:, 0] - tgt) ** 2).mean()


def template_fit_step(avatar: GeoTexAvatar, adam: Adam,
                      statics: AvatarStatics, pts: torch.Tensor,
                      lr: float = 1e-3, wrinkle_amp: float = 0.0,
                      wavelength: float = 0.045) -> torch.Tensor:
    """One Adam step (optax's order) of the ``cano_template`` parameters
    on ``pts``, in place. Returns the step's loss, before the update, as a
    device tensor."""
    params = list(avatar.cano_template.parameters())
    with torch.enable_grad():
        loss = template_fit_loss(avatar, statics, pts, wrinkle_amp,
                                 wavelength)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
    with torch.no_grad():
        for p, u in zip(params, adam.updates(params, grads, lr)):
            p.add_(u)
    return loss.detach()


def fit_template_to_body(avatar: GeoTexAvatar, statics: AvatarStatics,
                         steps: int = 600, n_pts: int = 32768,
                         lr: float = 1e-3, wrinkle_amp: float = 0.0,
                         wrinkle_wavelength: float = 0.045, seed: int = 7):
    """Fit the template's occupancy head to the toy body's signed distance
    (body_sdf_target), in place, on the statics' device: ``steps`` Adam
    steps of the ``cano_template`` parameters only, each on
    template_fit_points from a generator seeded ``seed``.

    An unfitted field's iso-surface is noise that fills the near-body band
    and every triangle budget; a capture loads a trained avatar whose
    surface is one body. The fit gives the bench mesh a trained avatar's
    statistics with the same per-point query work; ``wrinkle_amp`` > 0
    gives it clothing-fold detail (6 mm at ~4.5 cm in the bench), which
    multiplies the surface's cubes, triangles and refined nodes as a
    clothed human does. Nothing is read back until the last loss.
    Returns (avatar, final loss)."""
    dev = statics.cano_bounds.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    adam = Adam(list(avatar.cano_template.parameters()))
    loss = None
    for _ in range(steps):
        pts = template_fit_points(statics, n_pts, gen)
        loss = template_fit_step(avatar, adam, statics, pts, lr,
                                 wrinkle_amp, wrinkle_wavelength)
    return avatar, float(loss)


def recon_fit_features(recon: ReconNetwork, statics: AvatarStatics,
                       grid: CaptureGrid, inferred_normal,
                       images: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decoder's inputs at every grid slot (padding included): the
    HGFilter features of [inferred_normal, 0] (or of ``images``, (H, W, 6)
    on the grid's device, e.g. a frame's merged front and avatar back
    normals), fetched pixel-aligned at the grid nodes, and z - center_z.
    Returns (N, C + 1) on the grid's device."""
    dev = grid.valid_pts.device
    if images is None:
        normal = torch.as_tensor(np.asarray(inferred_normal, np.float32),
                                 device=dev)
        images = torch.cat([normal, torch.zeros_like(normal)], -1)
    with torch.no_grad():
        feat_map = recon.get_feat_maps(images[None])
        pf = grid_pose_features(feat_map, statics, grid.vol_res,
                                grid.valid_idx)
    z = grid.valid_pts[:, 2] - statics.cano_smpl_center[2]
    return torch.cat([pf, z[:, None]], -1)


def recon_fit_indices(n: int, batch: int,
                      generator: torch.Generator) -> torch.Tensor:
    """One step's batch of the decoder fit: ``batch`` slots of the n grid
    slots, uniformly with replacement."""
    return torch.randint(0, n, (batch,), generator=generator,
                         device=generator.device)


def recon_fit_loss(recon: ReconNetwork, statics: AvatarStatics,
                   feats: torch.Tensor, pts: torch.Tensor,
                   wrinkle_amp: float = 0.0,
                   wavelength: float = 0.045) -> torch.Tensor:
    """Mean squared error of the decoder's occupancy on ``feats`` (B, 33)
    against body_inside_target at their points ``pts`` (B, 3)."""
    tgt = body_inside_target(pts, statics.cano_smpl_vertices,
                             statics.cano_smpl_center, wrinkle_amp,
                             wavelength)
    occ = recon.image_decoder(feats)[:, 0]
    return ((occ - tgt) ** 2).mean()


def recon_fit_step(recon: ReconNetwork, adam: Adam, statics: AvatarStatics,
                   feats: torch.Tensor, pts: torch.Tensor, lr: float = 1e-3,
                   wrinkle_amp: float = 0.0,
                   wavelength: float = 0.045) -> torch.Tensor:
    """One Adam step (optax's order) of the ``image_decoder`` parameters on
    one batch, in place. Returns the step's loss before the update."""
    params = list(recon.image_decoder.parameters())
    with torch.enable_grad():
        loss = recon_fit_loss(recon, statics, feats, pts, wrinkle_amp,
                              wavelength)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
    with torch.no_grad():
        for p, u in zip(params, adam.updates(params, grads, lr)):
            p.add_(u)
    return loss.detach()


def fit_recon_decoder(recon: ReconNetwork, statics: AvatarStatics,
                      grid: CaptureGrid, inferred_normal, steps: int = 200,
                      batch: int = 65536, lr: float = 1e-3,
                      wrinkle_amp: float = 0.0,
                      wrinkle_wavelength: float = 0.045, seed: int = 11,
                      images: Optional[torch.Tensor] = None):
    """Fit ReconNet's decoder to the toy body's inside flag
    (body_inside_target), in place, on the grid's device: ``steps`` Adam
    steps of the ``image_decoder`` parameters only, each on a batch of
    grid slots (recon_fit_indices from a generator seeded ``seed``) of
    recon_fit_features (of ``images`` where given). A random decoder's
    occupancy crosses 0.5 all over the near-body band; the fitted one
    gives the ReconNet mesh a trained network's statistics with the same
    per-point decode work. Nothing is read back until the last loss.
    Returns (recon, final loss)."""
    dev = grid.valid_pts.device
    feats = recon_fit_features(recon, statics, grid, inferred_normal, images)
    gen = torch.Generator(device=dev).manual_seed(seed)
    adam = Adam(list(recon.image_decoder.parameters()))
    loss = None
    for _ in range(steps):
        idx = recon_fit_indices(feats.shape[0], batch, gen)
        loss = recon_fit_step(recon, adam, statics, feats[idx],
                              grid.valid_pts[idx], lr, wrinkle_amp,
                              wrinkle_wavelength)
    return recon, float(loss)


def default_fit_steps(wrinkle_amp: float) -> Tuple[int, int]:
    """The JAX bench's (template, decoder) fit steps: more for the
    wrinkled body."""
    return (1500, 400) if wrinkle_amp > 0 else (600, 200)


def _fit_cache_path(key: dict) -> str:
    digest = hashlib.sha1(json.dumps(key, sort_keys=True).encode()
                          ).hexdigest()[:16]
    return os.path.join(FIT_CACHE_DIR, f"fit_{digest}.pt")


def fit_subject(avatar: GeoTexAvatar, recon: ReconNetwork,
                statics: AvatarStatics, grid: CaptureGrid, inferred_normal,
                cache_key: dict, wrinkle_amp: float = 0.006,
                steps: Tuple[int, int] = None, n_pts: int = 32768,
                batch: int = 65536, use_cache: bool = True) -> dict:
    """Fit both networks to the toy body (fit_template_to_body with
    ``n_pts`` points a step, then fit_recon_decoder with batches of
    ``batch``; ``steps`` (template, decoder), default_fit_steps by
    default), in place, or load the fitted modules' state dicts (the
    template's and the decoder's; the rest is the caller's, unchanged by
    the fit) from the cache under build/bench_fit/, keyed on
    ``cache_key`` (which names the body, the grid, the seed and anything
    else the fit's inputs depend on), the wrinkle amplitude, the steps and
    the sizes. Returns the fit's record: steps, seconds and final loss of
    each fit, whether the cache was hit, and the cache file."""
    steps = steps or default_fit_steps(wrinkle_amp)
    key = dict(cache_key, wrinkle_amp=wrinkle_amp, steps=list(steps),
               n_pts=n_pts, batch=batch, version=3)
    path = _fit_cache_path(key)
    rec = {"steps": list(steps), "wrinkle_amp": wrinkle_amp,
           "cache_file": os.path.relpath(path, _ROOT), "cache_hit": False}
    if use_cache and os.path.exists(path):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        if saved["key"] == key:
            avatar.cano_template.load_state_dict(saved["template"])
            recon.image_decoder.load_state_dict(saved["decoder"])
            rec.update(cache_hit=True, **saved["losses"])
            return rec
    dev = grid.valid_pts.device
    for name, run in (
            ("template", lambda: fit_template_to_body(
                avatar, statics, steps=steps[0], n_pts=n_pts,
                wrinkle_amp=wrinkle_amp)),
            ("decoder", lambda: fit_recon_decoder(
                recon, statics, grid, inferred_normal, steps=steps[1],
                batch=batch, wrinkle_amp=wrinkle_amp))):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, loss = run()
        rec[f"{name}_seconds"] = time.perf_counter() - t0
        rec[f"{name}_loss"] = loss
    if use_cache:
        os.makedirs(FIT_CACHE_DIR, exist_ok=True)
        losses = {k: rec[k] for k in ("template_loss", "decoder_loss")}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"key": key, "losses": losses,
                    "template": avatar.cano_template.state_dict(),
                    "decoder": recon.image_decoder.state_dict()}, tmp)
        os.replace(tmp, path)
    return rec


def build_capture_subject(device, vol_res=(384, 384, 128), dense=True,
                          seed=0, options=None, img_res=512, fit=True,
                          wrinkle_amp=0.006, fit_kw=None):
    """The capture workload on ``device``: an AvatarCapture with
    ``options`` (default CAPTURE_OPTIONS), an item (the toy body at rest,
    identity joint mats, a N(0, 0.1) position map at 256^2 from the
    avatar's generator, the bench camera's w2c) and the production frame's
    keyword arguments (inferred normal at img_res^2, neck vertex 0,
    camera).

    The networks start from generators seeded ``seed`` (avatar),
    ``seed + 1`` (ReconNet) and ``seed + 2`` (texture avatar). With
    ``fit`` (the JAX bench's subject) the template and ReconNet are
    redrawn from ``seed + 3`` as the JAX bench's networks start
    (flax_init_; the geometry and offset heads at the reference's
    U(+-1e-5) with zero biases, so the warp is ~0), then both are fitted
    to the toy body with ``wrinkle_amp`` wrinkles (fit_subject, given
    ``fit_kw``: steps, sizes, use_cache) before the capture is built,
    since the capture builds the kernels' weight images once from the
    weights it is given; the texture avatar is drawn from the fitted
    avatar. ``fit=False`` keeps the random networks. Returns (capture, item, recon_kw, info), info holding the
    grid's near-body node count ``n_valid`` and the fit's record ``fit``
    (None without a fit)."""
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    params, statics, v = toy_avatar_statics(dense=dense, device=device)
    grid, n_valid = build_capture_grid(statics, vol_res)
    gen = torch.Generator().manual_seed(seed)
    avatar = random_avatar(gen)
    recon = random_recon(torch.Generator().manual_seed(seed + 1))
    w2c, camera, inferred = bench_camera(img_res)
    fit_rec = None
    if fit:
        g = torch.Generator().manual_seed(seed + 3)
        flax_init_(avatar.cano_template, g)
        with torch.no_grad():
            for head in (avatar.cano_template.geo_mlp.fc_list[1],
                         avatar.warping_field.out_layer_coord_affine):
                head.weight.uniform_(-1e-5, 1e-5, generator=g)
                head.bias.zero_()
        flax_init_(recon, g)
        avatar.to(device)
        recon.to(device)
        fit_rec = fit_subject(
            avatar, recon, statics, grid, inferred,
            cache_key=dict(dense=bool(dense), vol_res=list(vol_res),
                           img_res=img_res, seed=seed),
            wrinkle_amp=wrinkle_amp, **(fit_kw or {}))
        avatar.eval()
        recon.eval()
    tex = random_tex_avatar(avatar, torch.Generator().manual_seed(seed + 2))
    capture = AvatarCapture(avatar, statics, grid, recon=recon,
                            tex_avatar=tex,
                            options=CaptureOptions(**(options
                                                      or CAPTURE_OPTIONS)),
                            device=device)
    pos_map = torch.randn((256, 256, 6), generator=gen) * 0.1
    item = {"live_smpl_v": v.astype(np.float32),
            "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                          (params.num_joints, 1, 1)),
            "smpl_pos_map": pos_map.numpy(), "w2c_RT": w2c}
    recon_kw = dict(inferred_normal=inferred, neck_vertex_idx=0,
                    camera=camera)
    return capture, item, recon_kw, {"n_valid": n_valid, "fit": fit_rec}


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


def add_subject_args(parser) -> None:
    """The capture subject's command-line flags of the tools: ``--device``
    (the card by default), ``--small`` (SMALL_SUBJECT with its options and
    fit instead of the full-size workload), ``--random`` (the random
    networks, unfitted) and ``--no-fused-query`` (the f32 module path
    instead of the kernels) and ``--seed`` (the networks' seed)."""
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--small", action="store_true",
                        help="the 48 x 48 x 32 subject with small "
                             "capacities, instead of the full-size one")
    parser.add_argument("--random", action="store_true",
                        help="random networks instead of the ones fitted "
                             "to the toy body")
    parser.add_argument("--no-fused-query", action="store_true",
                        help="the f32 module path instead of the kernels")
    parser.add_argument("--seed", type=int, default=None,
                        help="the networks' seed (default: the subject's)")


def subject_from_args(args, vol_res=None, **options):
    """build_capture_subject for a tool's parsed add_subject_args flags:
    the fitted subject, on ``vol_res`` when given, with ``options`` over
    the capture options. With a card, matmuls and convolutions run in full
    float32 (no TF32), as the JAX package's do."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kw = dict(SMALL_SUBJECT, fit_kw=SMALL_FIT) if args.small else {}
    kw["fit"] = not args.random
    if vol_res is not None:
        kw["vol_res"] = tuple(vol_res)
    if args.seed is not None:
        kw["seed"] = args.seed
    if args.no_fused_query:
        options["use_fused_query"] = False
    base = SMALL_CAPTURE_OPTIONS if args.small else CAPTURE_OPTIONS
    return build_capture_subject(device, options=dict(base, **options), **kw)
