"""The benchmark's inputs and weights, made by the benchmark itself and
handed to the program and the reference alike.

Frozen copy of the subject of avatarcap_tpu_torch/tools/bench_workloads.py
at commit 2621afd (``toy_avatar_statics``, ``random_avatar``,
``flax_init_``, ``random_tex_avatar``, ``random_recon``, ``bench_camera``,
``build_capture_grid``, the wrinkled-body fit and ``train_batch``),
written on the reference's modules (benchmark/reference/): the toy body,
its statics and the canonical grid; GeoTexAvatar, its texture copy and
ReconNet in the configuration's form (benchmark/networks.py), started as
the JAX bench's networks start; the capture camera. The avatar's pose
U-Net, warp and texture are drawn from the run's seed; its template,
fitted to the toy body with 6 mm folds, and ReconNet, fitted to the same
body's occupancy on its own canonical normal images, are the
configuration's (made from its fixed seeds), so that every seed's frames
hold the same surface and the same amount of work. The fitted state
dicts are cached under benchmark/cache/fit/, keyed on the configuration's
fit and, where they are not AvatarCap's, its networks and widths.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from benchmark import networks
from benchmark.reference.adam import Adam
from benchmark.reference.avatar_query import AvatarStatics, grid_pose_features
from benchmark.reference.compaction import compact_mask_indices
from benchmark.reference.knn import knn
from benchmark.reference.layers import WeightNormPointConv1d
from benchmark.reference.raster import (cano_front_back_mvp, cano_index_passes,
                                        interpolate)
from benchmark.reference.se3 import axis_angle_to_matrix
from benchmark.reference.smpl import canonical_pose, smpl_forward
from benchmark.reference.toy_body import make_toy_smpl_params

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "cache")
FIT_VERSION = 4


def seed_parts(seed: int, n: int) -> list:
    """n 63-bit seeds drawn from ``seed`` (any size), one per generator."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    return [int(s) for s in ss.generate_state(n, np.uint64) >> 1]


# -- the body, its statics and the grid ----------------------------------

def toy_avatar_statics(body: dict, device):
    """Toy body + AvatarStatics: canonical bounds (AABB + 5 cm in x/y, 15
    cm in z) and a 2.5 cm weight volume with uniform root weights.
    Returns (params, statics, cano vertices (V, 3) numpy)."""
    params = make_toy_smpl_params(n_lat=body["n_lat"], n_lon=body["n_lon"])
    cano = smpl_forward(params, torch.as_tensor(canonical_pose()),
                        torch.zeros(10))
    v = cano.vertices.numpy()
    lo = v.min(0) - np.array([0.05, 0.05, 0.15], np.float32)
    hi = v.max(0) + np.array([0.05, 0.05, 0.15], np.float32)
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


def build_capture_grid(statics: AvatarStatics, vol_res, pad_to: int = 65536):
    """Near-body compacted grid: valid = within 10 cm of a body vertex;
    the prior outside the band is a radial inside test (+1 inside, -1
    outside). Returns dict(valid_pts, valid_idx, prior_volume, vol_res,
    n_valid)."""
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
    return {"valid_pts": valid_pts, "valid_idx": valid_idx,
            "prior_volume": prior, "vol_res": tuple(vol_res),
            "n_valid": n_valid}


def bench_camera(img_res: int, w2c):
    """The capture camera for an img_res^2 image: the JAX bench's
    intrinsics, fx = fy = 550 and cx = cy = 256 at 512^2, and the
    configuration's ``w2c`` (world -> camera). Returns (w2c (4, 4),
    camera dict), numpy float32."""
    w2c = np.asarray(w2c, np.float32)
    s = img_res / 512.0
    camera = {"fx": 550.0 * s, "fy": 550.0 * s, "cx": 256.0 * s,
              "cy": 256.0 * s}
    return w2c, camera


# -- networks -----------------------------------------------------------

def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisers in place: LeCun-normal kernels
    (truncated at 2 sigma), zero biases, weight-norm gains of 1, GroupNorm
    scales 1 and shifts 0; drawn on the host in module order."""
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


def random_avatar(cfg: dict, generator: torch.Generator,
                  **override) -> nn.Module:
    """The configuration's reference GeoTexAvatar (its keywords replaced
    by ``override``), every weight drawn from ``generator``: LeCun-uniform
    weights, U(-0.1, 0.1) biases, BatchNorm statistics around (0, 1), the
    offset head U(+-0.002) and the geometry head U(+-0.1)."""
    model = networks.build(cfg, "avatar", "reference", **override)
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


def random_tex_avatar(avatar: nn.Module,
                      generator: torch.Generator) -> nn.Module:
    """A texture avatar: a copy of ``avatar`` whose density row of the
    geometry head is redrawn, U(-1, 1) weights and a bias of 4, so the
    color rays carry O(0.1) colors."""
    tex = copy.deepcopy(avatar)
    head = tex.cano_template.geo_mlp.fc_list[1]
    with torch.no_grad():
        head.weight[1].copy_(torch.empty(head.weight[1].shape).uniform_(
            -1.0, 1.0, generator=generator))
        head.bias[1] = 4.0
    return tex.eval()


def random_recon(cfg: dict, generator: torch.Generator) -> nn.Module:
    """The configuration's reference ReconNetwork, every weight drawn from
    ``generator`` (see bench_workloads.random_recon)."""
    def lecun_(w):
        bound = (3.0 / w[0].numel()) ** 0.5
        w.uniform_(-bound, bound, generator=generator)

    model = networks.build(cfg, "recon", "reference")
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


# -- the fit to the wrinkled toy body -------------------------------------

def wrinkle_field(q: torch.Tensor, wavelength: float) -> torch.Tensor:
    """Unit-amplitude clothing-fold displacement at points q (N, 3)."""
    k = 2.0 * math.pi / wavelength
    return (torch.sin(k * (q[:, 0] + 0.37 * q[:, 1]))
            * torch.sin(k * (q[:, 1] - 0.21 * q[:, 2]))
            + 0.6 * torch.sin(k * 1.31 * (q[:, 2] + 0.55 * q[:, 0]))
            * torch.sin(k * 0.77 * q[:, 1]))


def _signed_body_distance(pts, verts, center, amp, wavelength):
    d2, idx = knn(pts, verts, k=1)
    inside = ((pts - center).norm(dim=-1)
              < (verts[idx[:, 0]] - center).norm(dim=-1))
    d = torch.sqrt(d2[:, 0].clamp_min(0.0))
    sd = torch.where(inside, d, -d)
    if amp > 0.0:
        sd = sd + amp * wrinkle_field(pts - center, wavelength)
    return sd, inside


def _fit_template(avatar, statics, fit, generator):
    """Adam steps of the template's parameters on the clipped wrinkled
    signed distance at points drawn from ``generator`` (half uniform in
    the bounds, half around body vertices)."""
    lo, hi = statics.cano_bounds[0], statics.cano_bounds[1]
    verts, center = statics.cano_smpl_vertices, statics.cano_smpl_center
    dev = lo.device
    params = list(avatar.cano_template.parameters())
    adam = Adam(params)
    half = fit["n_pts"] // 2
    loss = None
    for _ in range(fit["template_steps"]):
        pu = torch.rand((half, 3), generator=generator, device=dev) * (
            hi - lo) + lo
        vi = torch.randint(0, verts.shape[0], (half,), generator=generator,
                           device=dev)
        pn = verts[vi] + 0.03 * torch.randn((half, 3), generator=generator,
                                            device=dev)
        pts = torch.cat([pu, pn])
        tgt = _signed_body_distance(pts, verts, center, fit["wrinkle_amp"],
                                    fit["wavelength"])[0].clamp(-0.05, 0.05)
        with torch.enable_grad():
            _, _, occ = avatar.query_template(pts)
            loss = ((occ[:, 0] - tgt) ** 2).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            for p, u in zip(params, adam.updates(params, grads, 1e-3)):
                p.add_(u)
    return float(loss.detach())


def body_normal_images(params, statics, res: int, amp: float,
                       wavelength: float) -> Tuple[torch.Tensor, ...]:
    """The toy body's canonical front and back normal images at res^2, as
    the capture renders an avatar's (the orthographic pair, the back
    x-flipped): the outward normals of the body with the fit's folds
    (each vertex normal tilted by the fold field's gradient), interpolated
    over the body's triangles. Returns (front, back), (res, res, 3)."""
    dev = statics.cano_bounds.device
    v, center = statics.cano_smpl_vertices, statics.cano_smpl_center
    # the vertex normals on the host in float64: a device scatter-add
    # sums in no fixed order, and the fit would then differ by machine
    vh = v.detach().cpu().double().numpy()
    ch = center.detach().cpu().double().numpy()
    faces = np.asarray(params.faces, np.int64)

    def face_normals(f):
        t = vh[f]
        return np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    fn = face_normals(faces)
    if (fn * (vh[faces].mean(1) - ch)).sum(-1).mean() < 0.0:
        faces = faces[:, [0, 2, 1]]                 # outward, counter-
        fn = face_normals(faces)                    # clockwise in front
    vn = np.zeros_like(vh)
    np.add.at(vn, faces.reshape(-1), np.repeat(fn, 3, axis=0))
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    q = torch.as_tensor(vh - ch).requires_grad_(True)
    with torch.enable_grad():
        g = torch.autograd.grad(wrinkle_field(q, wavelength).sum(), q)[0]
    n = vn - amp * g.numpy()   # -grad of the folded inside-positive distance
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n = torch.as_tensor(n, dtype=torch.float32, device=dev)
    faces = torch.as_tensor(faces, device=dev)
    fmvp, _, bmvp, _ = (torch.as_tensor(m, device=dev) for m in
                        cano_front_back_mvp(center.cpu().numpy()))
    tris = v[faces]
    fri, bri = cano_index_passes(
        tris, torch.ones(tris.shape[0], dtype=torch.bool, device=dev),
        fmvp, bmvp, res=res, window=8, big_tris=512)
    front, _ = interpolate(fri, n[faces])
    back, _ = interpolate(bri, n[faces])
    return front, back.flip(1)


def _fit_decoder(recon, params, statics, grid, res, fit, generator):
    """Adam steps of ReconNet's decoder on the folded body's occupancy,
    sigmoid(signed distance / ``decoder_tau``) (inside positive), so that
    its 0.5 level is the surface, inside the near-body band, at grid
    slots drawn from ``generator``: on [the HGFilter features at the grid
    nodes, z - center_z] of the body's canonical normal images
    (body_normal_images), clean or, every other step, with N(0,
    ``image_noise``) on the front's covered pixels, as a merged front
    carries."""
    dev = grid["valid_pts"].device
    verts, center = statics.cano_smpl_vertices, statics.cano_smpl_center
    front, back = body_normal_images(params, statics, res,
                                     fit["wrinkle_amp"], fit["wavelength"])
    covered = front.norm(dim=-1, keepdim=True) > 0.0
    noisy = front + fit["image_noise"] * torch.randn(
        front.shape, generator=generator, device=dev)
    noisy = torch.where(covered, noisy / noisy.norm(
        dim=-1, keepdim=True).clamp_min(1e-12), front)
    z = grid["valid_pts"][:, 2] - center[2]
    feats = []
    with torch.no_grad():
        for f in (front, noisy):
            feat_map = recon.get_feat_maps(torch.cat([f, back], -1)[None])
            pf = grid_pose_features(feat_map, statics, grid["vol_res"],
                                    grid["valid_idx"])
            feats.append(torch.cat([pf, z[:, None]], -1))
    params_d = list(recon.image_decoder.parameters())
    adam = Adam(params_d)
    loss = None
    n_live = grid["n_valid"]
    for step in range(fit["decoder_steps"]):
        idx = torch.randint(0, n_live, (fit["batch"],),
                            generator=generator, device=dev)
        sd, _ = _signed_body_distance(grid["valid_pts"][idx], verts, center,
                                      fit["wrinkle_amp"], fit["wavelength"])
        tgt = torch.sigmoid(sd / fit["decoder_tau"])
        with torch.enable_grad():
            occ = recon.image_decoder(feats[step % 2][idx])[:, 0]
            loss = ((occ - tgt) ** 2).mean()
            grads = torch.autograd.grad(loss, params_d, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            for p, u in zip(params_d, adam.updates(params_d, grads, 1e-3)):
                p.add_(u)
    return float(loss.detach())


# AvatarCap's networks and widths, those of geotex_sdf and geotex_occ: their
# fits are keyed without them and so keep their cache names
AVATARCAP_FORM = {
    "networks": {
        "avatar": {
            "reference": "benchmark.reference.avatar_model:GeoTexAvatar",
            "kwargs": {"pos_encoding_template": 10, "pos_encoding_warp": 0}},
        "recon": {"reference": "benchmark.reference.recon:ReconNetwork",
                  "kwargs": {"feat_channels": 32}}},
    "widths": {"template_pos_encoding": 10, "warp_pos_encoding": 0,
               "pose_feat_dim": 64, "offset_width": 256,
               "template_width": 256, "recon_in_dim": 33,
               "recon_widths": [512, 256, 128], "unet_nf": 32,
               "hgfilter_channels": 256, "hgfilter_depth": 4,
               "recon_res_layers": [1, 2]}}


def fit_keys(cfg: dict, device) -> Tuple[dict, dict]:
    """The fit cache's keys of the template's fit and the decoder's: the
    body, grid, renders, device, folds and each fit's settings, and the
    reference networks' classes and keywords with the widths where they
    are not AvatarCap's."""
    fit = cfg["fit"]
    form = {"networks": {role: {"reference": e.get("reference"),
                                "kwargs": e.get("kwargs", {})}
                         for role, e in cfg["networks"].items()},
            "widths": cfg["widths"]}
    base = {"body": cfg["body"], "vol_res": cfg["vol_res"],
            "render_res": cfg["capture"]["options"]["render_res"],
            "device": torch.device(device).type, "version": FIT_VERSION,
            "amp": fit["wrinkle_amp"], "wavelength": fit["wavelength"]}
    if form != AVATARCAP_FORM:
        base["form"] = form
    return (dict(base, part="template", seed=fit["template_seed"],
                 steps=fit["template_steps"], n_pts=fit["n_pts"]),
            dict(base, part="decoder", seed=fit["recon_seed"],
                 steps=fit["decoder_steps"], batch=fit["batch"],
                 tau=fit["decoder_tau"], noise=fit["image_noise"]))


def _cache_path(key: dict) -> str:
    digest = hashlib.sha1(json.dumps(key, sort_keys=True).encode()
                          ).hexdigest()[:16]
    return os.path.join(CACHE, "fit", f"fit_{digest}.pt")


def _cached(key: dict, module: nn.Module, fit_fn, use_cache: bool) -> dict:
    """Load ``module``'s fitted state from the fit cache under ``key``, or
    run ``fit_fn()`` (its final loss) and store the result."""
    path = _cache_path(key)
    if use_cache and os.path.exists(path):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        if saved["key"] == key:
            module.load_state_dict(saved["state"])
            return {"cache_hit": True, "loss": saved["loss"]}
    loss = fit_fn()
    if use_cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save({"key": key, "loss": loss, "state": {
            k: v.cpu() for k, v in module.state_dict().items()}}, tmp)
        os.replace(tmp, path)
    return {"cache_hit": False, "loss": loss}


def capture_weights(cfg: dict, seed: int, params, statics, grid, device,
                    use_cache: bool = True) -> Tuple[Dict, dict]:
    """The capture networks' state dicts. GeoTexAvatar's pose U-Net and
    warp are drawn from ``seed`` (random_avatar); its template is the
    configuration's: drawn from ``template_seed`` at flax's initialisers
    (the geometry and offset heads at U(+-1e-5), zero biases: the warp
    stays ~0) and fitted to the toy body with the configuration's folds.
    The texture avatar is it with a density row redrawn from ``seed``.
    ReconNet is the one network every subject shares (AvatarCap's
    pretrained recon_net): made from the configuration's ``recon_seed``,
    its decoder fitted to the folded body's occupancy (_fit_decoder).
    Each fit is loaded from the fit cache where it is there. Returns
    ({avatar, tex, recon: CPU state dicts}, fit record: each part's cache
    hit and loss, and the seconds the fits or their loads took)."""
    import time
    t0 = time.perf_counter()
    fit = cfg["fit"]
    s_avatar, s_tex = seed_parts(seed, 2)
    t_init, t_fit = seed_parts(fit["template_seed"], 2)
    r_init, r_flax, r_fit = seed_parts(fit["recon_seed"], 3)
    # the template is fitted to a signed distance in the SDF form; the
    # occupancy form's weights are the same under its sigmoid
    avatar = random_avatar(cfg, torch.Generator().manual_seed(s_avatar),
                           if_type="sdf")
    g = torch.Generator().manual_seed(t_init)
    flax_init_(avatar.cano_template, g)
    with torch.no_grad():
        for head in (avatar.cano_template.geo_mlp.fc_list[1],
                     avatar.warping_field.out_layer_coord_affine):
            head.weight.uniform_(-1e-5, 1e-5, generator=g)
            head.bias.zero_()
    recon = random_recon(cfg, torch.Generator().manual_seed(r_init))
    flax_init_(recon, torch.Generator().manual_seed(r_flax))
    template_key, decoder_key = fit_keys(cfg, device)
    avatar.to(device)
    recon.to(device)

    def fit_template():
        gen = torch.Generator(device=device).manual_seed(t_fit)
        return _fit_template(avatar, statics, fit, gen)

    def fit_decoder():
        gen = torch.Generator(device=device).manual_seed(r_fit)
        return _fit_decoder(recon, params, statics, grid,
                            cfg["capture"]["options"]["render_res"], fit,
                            gen)
    rec = {"template": _cached(template_key, avatar.cano_template,
                               fit_template, use_cache),
           "decoder": _cached(decoder_key, recon.image_decoder, fit_decoder,
                              use_cache)}
    avatar.cpu().eval()
    recon.cpu().eval()
    tex = random_tex_avatar(avatar, torch.Generator().manual_seed(s_tex))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    rec["seconds"] = time.perf_counter() - t0
    return ({"avatar": avatar.state_dict(), "tex": tex.state_dict(),
             "recon": recon.state_dict()}, rec)


def train_weights(cfg: dict, seed: int) -> Dict:
    """The training cell's starting GeoTexAvatar state dict, in the
    configuration's form, from ``seed`` (random_avatar, the JAX bench's
    build_train_env)."""
    return random_avatar(cfg, torch.Generator().manual_seed(
        seed_parts(seed, 1)[0])).state_dict()


def train_batch(params, cano_v: np.ndarray, center: np.ndarray, train: dict,
                rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One posed training batch (bench_workloads.train_batch with
    ``posed``): random position maps, canonical points within 0.3 m of the
    center with SDF targets in [-0.1, 0.1], random colors, rays along +z
    from 2 m in front of the center, and per joint a rotation of up to
    0.3 rad about a random axis and a shift of up to 5 cm, which pose the
    live vertices."""
    J = params.num_joints
    B, R = train["batch_size"], train["n_rays"]
    NPTS = train["n_surf"] + train["n_vol"]
    res = train["pos_map_res"]
    batch = {
        "smpl_pos_map": rng.standard_normal(
            (B, res, res, 6)).astype(np.float32) * 0.1,
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
    axis = rng.standard_normal((B, J, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-0.3, 0.3, (B, J, 1))
    rot = axis_angle_to_matrix(torch.as_tensor(axis * angle)).numpy()
    mats = np.tile(np.eye(4), (B, J, 1, 1))
    mats[:, :, :3, :3] = rot
    mats[:, :, :3, 3] = rng.uniform(-0.05, 0.05, (B, J, 3))
    mats = mats.astype(np.float32)
    vmats = (params.weights @ mats.reshape(B, J, 16)).reshape(B, -1, 4, 4)
    batch["cano2live_jnt_mats"] = mats
    batch["live_smpl_v"] = (np.einsum("bvxy,vy->bvx", vmats[..., :3, :3],
                                      cano_v)
                            + vmats[..., :3, 3]).astype(np.float32)
    return batch
