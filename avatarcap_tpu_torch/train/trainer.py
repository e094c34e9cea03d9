"""Avatar training (counterpart of avatarcap_tpu/train/trainer.py; the
reference's main.py:28-159).

- Adam in two groups, ``cano_template`` and ``warping_field`` (every
  parameter not in the template), in optax's order of operations
  (ops/adam.py), with the two learning rates given per step.
- Losses: image MSE, clipped-and-normalised SDF L1 (or BCE on the
  occupancy form), and the mean offset norms of the geometry points and
  of the ray samples, weighted 1.0 / 0.5 / 0.05 / 0.05.
- The BatchNorm statistics update in the forward order of the JAX step:
  the pose features, the geometry query, the ray render (the
  OffsetDecoder's twice per step).
- ``AvatarTrainer.epoch_lrs`` is the reference's policy: StepLR floors
  5e-4 / 5e-5, and the warp field's rate 0 in epoch 0 (its Adam moments
  still advance, as optax's do).

A step is eager PyTorch with autograd on the model's device; no custom
kernel runs here (the JAX package's training reaches no Pallas kernel).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.layers import f32_convolutions
from avatarcap_tpu_torch.ops.adam import Adam
from avatarcap_tpu_torch.ops.volume_render import (
    raw2outputs, stratified_z_vals, z_vals_to_dists)
from avatarcap_tpu_torch.pipeline.avatar import (
    AvatarStatics, FrameInputs, avatar_forward, compute_pose_features,
    query_occupancy, stage)
from avatarcap_tpu_torch.train import checkpoints as ckpt
from avatarcap_tpu_torch.train.schedules import StepSchedule
from avatarcap_tpu_torch.utils.tb_logging import ScalarLogger

GROUPS = ("cano_template", "warping_field")


class TrainState(NamedTuple):
    """A model in training: its parameters and BatchNorm statistics live
    in ``model`` (updated in place by a step), its Adam state per
    parameter group in ``opt``; ``step`` counts the steps taken."""

    model: GeoTexAvatar
    opt: Dict[str, Adam]
    step: int


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


def geometry_loss(occ_pred: torch.Tensor, target_ov: torch.Tensor,
                  if_type: str = "sdf", sdf_thres: float = 0.1
                  ) -> torch.Tensor:
    """L1 against SDF targets clipped to +-sdf_thres and normalised
    (``sdf``), or BCE against the inside label target > 0 (otherwise).
    occ_pred (..., 1), target_ov (...)."""
    if if_type == "sdf":
        target = target_ov.clamp(-sdf_thres, sdf_thres) / sdf_thres
        return (occ_pred[..., 0] - target).abs().mean()
    target = (target_ov > 0).to(occ_pred.dtype)
    return _bce(occ_pred[..., 0], target).mean()


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


def make_loss_fn(statics: AvatarStatics, if_type: str = "sdf",
                 sdf_thres: float = 0.1, n_samples: int = 64,
                 perturb: bool = True,
                 loss_weights=(1.0, 0.5, 0.05, 0.05)):
    """The training forward and loss of the JAX step's loss_fn:

      loss_fn(model, batch, generator=None, t_rand=None, timer=None)
        -> (total, metrics)

    in the model's current mode (a train step runs it in ``train()``).
    metrics: the five losses as 0-d tensors, total among them."""
    img_w, occ_w, geo_reg_w, tex_reg_w = loss_weights

    def loss_fn(model: GeoTexAvatar, batch, generator=None, t_rand=None,
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
            img_loss = torch.square(rgb_map - batch["rgb"]).mean()
            geo_loss = geometry_loss(occ_pred, batch["cano_pts_ov"],
                                     if_type, sdf_thres)
            geo_reg = occ_offsets.norm(dim=-1).mean()
            tex_reg = nerf_offsets.norm(dim=-1).mean()
            total = (img_w * img_loss + occ_w * geo_loss
                     + geo_reg_w * geo_reg + tex_reg_w * tex_reg)
        return total, {"tex_loss": img_loss, "geo_loss": geo_loss,
                       "geo_offset_reg_loss": geo_reg,
                       "tex_offset_reg_loss": tex_reg, "total_loss": total}

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
    """The avatar train step:

      train_step(state, batch, lrs, generator=None, t_rand=None,
                 timer=None) -> (state, metrics)

    batch: dict of tensors on the model's device (the dataset's keys);
    lrs: [cano_template lr, warping_field lr]; generator / t_rand: the
    sample jitter of ``perturb``, drawn from the generator or given
    ((B, R, S) uniform draws); timer: ``timer(stage)`` -> a context
    manager around each stage (pose_features, geometry_query,
    inverse_skinning, ray_query, compositing, backward, optimizer).
    metrics: the five losses as 0-d tensors (reading them waits for the
    device). The step updates state.model and state.opt in place.
    """
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


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch's numeric arrays (numpy or torch) as tensors on
    ``device``; other values are left out."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != np.object_:
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out


@dataclasses.dataclass
class AvatarTrainer:
    """The training loop (the reference's main.py:28-159) on one device:
    ``device=None`` is the card (device.resolve_device); the CPU runs
    when asked for."""

    statics: AvatarStatics
    net_ckpt_dir: str
    if_type: str = "sdf"
    cano_template_lr: float = 1e-3
    warping_field_lr: float = 1e-4
    n_samples: int = 64
    loss_weights: tuple = (1.0, 0.5, 0.05, 0.05)
    log_name: str = "train"
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.statics = self.statics.to(self.device)
        self.train_step = make_train_step(
            self.statics, self.if_type, n_samples=self.n_samples,
            loss_weights=self.loss_weights)
        self.lr_schedule_template = StepSchedule(self.cano_template_lr,
                                                 5000, 0.5)
        self.lr_schedule_warp = StepSchedule(self.warping_field_lr,
                                             20000, 0.5)

    def init_state(self, model: GeoTexAvatar) -> TrainState:
        """A training state on a copy of ``model`` (the caller's model is
        left as it is), with fresh Adam moments and step 0."""
        model = copy.deepcopy(model).to(self.device).train()
        return TrainState(model, make_optimizer(model), 0)

    def epoch_lrs(self, epoch_idx: int, batch_num: int) -> np.ndarray:
        """[cano_template lr, warping_field lr] of an epoch (the
        reference's main.py:80-89)."""
        it = epoch_idx * batch_num
        lr_t = max(5e-4, self.lr_schedule_template(it))
        lr_w = 0.0 if epoch_idx < 1 else max(5e-5, self.lr_schedule_warp(it))
        return np.array([lr_t, lr_w], np.float32)

    def fit(self, dataset, start_epoch: int, end_epoch: int,
            batch_size: int, state: TrainState, ckpt_interval: int = 10,
            seed: int = 31359, log_fn=print,
            num_workers: int = 3) -> TrainState:
        """Epochs [start_epoch, end_epoch) over ``dataset.batches(...)``
        (an AvatarCapDataset, or any source with ``__len__`` and
        ``batches``). Each step's losses are read back after the next
        step was queued, so the host prepares the next batch while the
        device works; they go to ``{log_name}_loss.jsonl`` (per batch and
        epoch means) and TensorBoard. Checkpoints ``epoch_N`` every
        ``ckpt_interval`` epochs and ``epoch_latest`` after every epoch."""
        os.makedirs(self.net_ckpt_dir, exist_ok=True)
        logger = ScalarLogger(self.net_ckpt_dir, self.log_name)
        batch_num = max(1, len(dataset) // batch_size)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        epoch_losses: Dict[str, float] = {}

        def log_metrics(epoch_idx, batch_idx, lrs, metrics):
            m = {k: float(v) for k, v in metrics.items()}
            for k, v in m.items():
                epoch_losses[k] = epoch_losses.get(k, 0.0) + v
            log_fn(f"epoch {epoch_idx}, batch {batch_idx}, "
                   f"lr: {lrs[0]:.2e}, {lrs[1]:.2e}, "
                   + ", ".join(f"{k}: {v:.6f}" for k, v in m.items()))
            logger.log(m, step=epoch_idx * batch_num + batch_idx,
                       extra={"epoch": epoch_idx, "batch": batch_idx})

        try:
            for epoch_idx in range(start_epoch, end_epoch):
                lrs = self.epoch_lrs(epoch_idx, batch_num)
                t_epoch = time.time()
                epoch_losses.clear()
                prev = None
                for batch_idx, batch in enumerate(dataset.batches(
                        batch_size, shuffle=True, seed=seed + epoch_idx,
                        num_workers=num_workers)):
                    state, metrics = self.train_step(
                        state, batch_to_device(batch, self.device), lrs,
                        generator=generator)
                    if prev is not None:
                        log_metrics(epoch_idx, batch_idx - 1, lrs, prev)
                    prev = metrics
                if prev is not None:
                    log_metrics(epoch_idx, batch_num - 1, lrs, prev)
                logger.log({f"epoch/{k}": v / batch_num
                            for k, v in epoch_losses.items()},
                           step=epoch_idx,
                           extra={"epoch": epoch_idx, "batch": -1})
                logger.flush()
                log_fn(f"epoch {epoch_idx} took "
                       f"{time.time() - t_epoch:.1f} s")
                if epoch_idx % ckpt_interval == 0:
                    ckpt.save_train_state(os.path.join(
                        self.net_ckpt_dir, f"epoch_{epoch_idx}"), state)
                ckpt.save_train_state(
                    os.path.join(self.net_ckpt_dir, "epoch_latest"), state)
        finally:
            logger.close()
        return state
