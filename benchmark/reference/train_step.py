"""Frozen copy of the one-device train step of
avatarcap_tpu_torch/train/trainer.py at commit 2621afd (``param_groups``,
``make_optimizer``, the loss terms, ``train_gradients``,
``apply_gradients`` and ``make_train_step`` without its mesh branch), the
float32 reference of the benchmark's training cells.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from benchmark.reference.adam import Adam
from benchmark.reference.avatar_model import GeoTexAvatar
from benchmark.reference.avatar_query import (
    AvatarStatics, FrameInputs, avatar_forward, compute_pose_features,
    query_occupancy, stage)
from benchmark.reference.layers import f32_convolutions
from benchmark.reference.volume_render import (
    raw2outputs, stratified_z_vals, z_vals_to_dists)


class TrainState(NamedTuple):
    model: GeoTexAvatar
    opt: Dict[str, Adam]
    step: int


GROUPS = ("cano_template", "warping_field")
LOSS_KEYS = ("tex_loss", "geo_loss", "geo_offset_reg_loss",
             "tex_offset_reg_loss")


def param_groups(model: GeoTexAvatar) -> Dict[str, list]:
    """The model's parameters by optimizer group: ``cano_template`` and,
    under ``warping_field``, every other parameter."""
    out = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        out["cano_template" if name.startswith("cano_template.")
            else "warping_field"].append(p)
    return out


def make_optimizer(model: GeoTexAvatar) -> Dict[str, Adam]:
    """The two-group Adam of the JAX package's make_optimizer."""
    return {g: Adam(ps) for g, ps in param_groups(model).items()}


def _bce(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7):
    p = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def geometry_loss_terms(occ_pred: torch.Tensor, target_ov: torch.Tensor,
                        if_type: str = "sdf", sdf_thres: float = 0.1
                        ) -> torch.Tensor:
    """Per point: the L1 against SDF targets clipped to +-sdf_thres and
    normalised (``sdf``), or the BCE against the inside label target > 0
    (otherwise). occ_pred (..., 1), target_ov (...) -> (...)."""
    if if_type == "sdf":
        target = target_ov.clamp(-sdf_thres, sdf_thres) / sdf_thres
        return (occ_pred[..., 0] - target).abs()
    target = (target_ov > 0).to(occ_pred.dtype)
    return _bce(occ_pred[..., 0], target)


def geometry_loss(occ_pred: torch.Tensor, target_ov: torch.Tensor,
                  if_type: str = "sdf", sdf_thres: float = 0.1
                  ) -> torch.Tensor:
    """The mean of geometry_loss_terms."""
    return geometry_loss_terms(occ_pred, target_ov, if_type,
                               sdf_thres).mean()


def render_train_rays(model: GeoTexAvatar, batch, feat, frame, statics,
                      n_samples: int, perturb: bool, generator=None,
                      t_rand=None, timer=None):
    """The ray half of a training forward: samples along the batch's rays,
    the masked query of the posed samples, compositing. Returns
    (rgb_map (B, R, 3), the samples' offsets (B, R*S, 3)). Where a ray
    has a depth (> 1e-6) its samples span depth +- 5 cm, else the box's
    near / far."""
    has_depth = batch["depth"] > 1e-6
    near = torch.where(has_depth, batch["depth"] - 0.05, batch["near"])
    far = torch.where(has_depth, batch["depth"] + 0.05, batch["far"])
    z_vals = stratified_z_vals(near, far, n_samples, perturb, generator,
                               t_rand)
    B, R = near.shape
    wpts = (batch["ray_o"][:, :, None]
            + batch["ray_d"][:, :, None] * z_vals[..., None])
    dists = z_vals_to_dists(z_vals)
    out = avatar_forward(model, wpts.reshape(B, R * n_samples, 3),
                         dists.reshape(B, R * n_samples), feat, statics,
                         "posed", frame, timer)
    with stage(timer, "compositing"):
        ro = raw2outputs(out["raw"].reshape(B * R, n_samples, 4),
                         z_vals.reshape(B * R, n_samples))
    return ro.rgb_map.reshape(B, R, 3), out["nonrigid_offset"]


def frame_inputs(batch) -> FrameInputs:
    return FrameInputs(batch["live_smpl_v"], batch["cano2live_jnt_mats"],
                       batch["smpl_pos_map"])


def apply_updates(params, updates) -> None:
    """params += updates, in place and outside autograd (optax's
    apply_updates)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)


def make_loss_terms(statics: AvatarStatics, if_type: str = "sdf",
                    sdf_thres: float = 0.1, n_samples: int = 64,
                    perturb: bool = True):
    """The training forward of the JAX step's loss_fn, up to the losses'
    means:

      loss_terms(model, batch, generator=None, t_rand=None, timer=None)
        -> {LOSS_KEYS[i]: elementwise terms}

    (the squared image errors, the geometry loss per point, the offset
    norms of the geometry points and of the ray samples), in the model's
    current mode."""

    def loss_terms(model: GeoTexAvatar, batch, generator=None, t_rand=None,
                   timer=None):
        frame = frame_inputs(batch)
        with stage(timer, "pose_features"):
            feat = compute_pose_features(model, frame.smpl_pos_map,
                                         train=model.training)
        with stage(timer, "geometry_query"):
            geo = query_occupancy(model, batch["cano_pts"], feat, statics)
            occ_pred, occ_offsets = geo["cano_pts_ov"], geo["nonrigid_offset"]
        rgb_map, nerf_offsets = render_train_rays(
            model, batch, feat, frame, statics, n_samples, perturb,
            generator, t_rand, timer)
        with stage(timer, "compositing"):
            return {"tex_loss": torch.square(rgb_map - batch["rgb"]),
                    "geo_loss": geometry_loss_terms(
                        occ_pred, batch["cano_pts_ov"], if_type, sdf_thres),
                    "geo_offset_reg_loss": occ_offsets.norm(dim=-1),
                    "tex_offset_reg_loss": nerf_offsets.norm(dim=-1)}

    return loss_terms


def total_loss(losses: Dict[str, torch.Tensor],
               loss_weights=(1.0, 0.5, 0.05, 0.05)):
    """(total, metrics): the weighted sum of the four losses (LOSS_KEYS)
    and the five losses, total among them."""
    img_w, occ_w, geo_reg_w, tex_reg_w = loss_weights
    total = (img_w * losses["tex_loss"] + occ_w * losses["geo_loss"]
             + geo_reg_w * losses["geo_offset_reg_loss"]
             + tex_reg_w * losses["tex_offset_reg_loss"])
    return total, {**losses, "total_loss": total}


def make_loss_fn(statics: AvatarStatics, if_type: str = "sdf",
                 sdf_thres: float = 0.1, n_samples: int = 64,
                 perturb: bool = True,
                 loss_weights=(1.0, 0.5, 0.05, 0.05)):
    """The training forward and loss of the JAX step's loss_fn:

      loss_fn(model, batch, generator=None, t_rand=None, timer=None)
        -> (total, metrics)

    in the model's current mode (a train step runs it in ``train()``).
    metrics: the five losses as 0-d tensors, total among them."""
    loss_terms = make_loss_terms(statics, if_type, sdf_thres, n_samples,
                                 perturb)

    def loss_fn(model: GeoTexAvatar, batch, generator=None, t_rand=None,
                timer=None):
        terms = loss_terms(model, batch, generator, t_rand, timer)
        with stage(timer, "compositing"):
            return total_loss({k: terms[k].mean() for k in LOSS_KEYS},
                              loss_weights)

    return loss_fn


def train_gradients(model: GeoTexAvatar, total: torch.Tensor):
    """Gradients of ``total`` for every parameter, in param_groups order
    (GROUPS). The convolutions' backward runs in full float32 on
    deterministic algorithms, as their forward does (f32_convolutions). A
    parameter the forward did not reach (the U-Net's conv7 and upconv1 on
    a 64^2 map) has the zero gradient JAX gives it. Returns (groups,
    grads)."""
    groups = param_groups(model)
    params = [p for g in GROUPS for p in groups[g]]
    with f32_convolutions():
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
    return groups, grads


def apply_gradients(state: TrainState, groups, grads, lrs) -> None:
    """One Adam step of each group (train_gradients' order) at its
    learning rate, lrs = [cano_template lr, warping_field lr]."""
    i = 0
    for gi, g in enumerate(GROUPS):
        ps = groups[g]
        gs = grads[i:i + len(ps)]
        i += len(ps)
        lr = float(np.float32(lrs[gi]))
        apply_updates(ps, state.opt[g].updates(ps, gs, lr))


def make_train_step(statics: AvatarStatics, if_type: str = "sdf",
                    sdf_thres: float = 0.1, n_samples: int = 64,
                    perturb: bool = True,
                    loss_weights=(1.0, 0.5, 0.05, 0.05)):
    """The one-device train step (see the port's make_train_step)."""
    loss_fn = make_loss_fn(statics, if_type, sdf_thres, n_samples, perturb,
                           loss_weights)

    def train_step(state: TrainState, batch, lrs, generator=None,
                   t_rand=None, timer=None):
        model = state.model
        model.train()
        total, metrics = loss_fn(model, batch, generator, t_rand, timer)
        with stage(timer, "backward"):
            groups, grads = train_gradients(model, total)
        with stage(timer, "optimizer"):
            apply_gradients(state, groups, grads, lrs)
        return (state._replace(step=state.step + 1),
                {k: v.detach() for k, v in metrics.items()})

    return train_step
