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
- Over a mesh (``make_train_step(mesh=)``, ``AvatarTrainer(mesh=)``) the
  step is the whole-batch step, as the JAX step jitted over a mesh is
  under GSPMD: the batch splits into one block per device; each replica
  of the model runs its block in a host thread of its own, one replica
  at a time up to the next reduction (parallel/mesh.ReplicaWorkers),
  with the mesh's BatchNorm statistics (models/layers.py); the losses
  are the mesh's sums over its element counts; one backward runs over
  the mesh's loss, and every replica's Adam steps with the gradients
  summed in device order, so the replicas keep the same bits. ``fit``
  and the CLI run on one device, as JAX's do.

A step is eager PyTorch with autograd on the model's device; no custom
kernel runs here (the JAX package's training reaches no Pallas kernel).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.models.layers import f32_convolutions
from avatarcap_tpu_torch.ops.adam import Adam
from avatarcap_tpu_torch.ops.volume_render import (
    raw2outputs, stratified_z_vals, z_vals_to_dists)
from avatarcap_tpu_torch.parallel.mesh import (
    ReplicaWorkers, all_reduce, canonical_device, make_mesh, shard_batch,
    sum_to_first)
from avatarcap_tpu_torch.pipeline.avatar import (
    AvatarStatics, FrameInputs, avatar_forward, compute_pose_features,
    query_occupancy, stage)
from avatarcap_tpu_torch.train import checkpoints as ckpt
from avatarcap_tpu_torch.train.schedules import StepSchedule
from avatarcap_tpu_torch.utils.tb_logging import ScalarLogger

GROUPS = ("cano_template", "warping_field")
LOSS_KEYS = ("tex_loss", "geo_loss", "geo_offset_reg_loss",
             "tex_offset_reg_loss")


class TrainState(NamedTuple):
    """A model in training: its parameters and BatchNorm statistics live
    in ``model`` (updated in place by a step), its Adam state per
    parameter group in ``opt``; ``step`` counts the steps taken. Over a
    mesh, ``model`` and ``opt`` are the first device's and ``replicas``
    holds the (model, opt) of each other device of the mesh, in order
    (replicate_state); on one device it is empty."""

    model: GeoTexAvatar
    opt: Dict[str, Adam]
    step: int
    replicas: Tuple = ()


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


def replicate_state(state: TrainState, mesh) -> TrainState:
    """``state`` over ``mesh``: its model and Adam groups, on the mesh's
    first device, copied to each other device of the mesh (a device may
    repeat) as ``replicas``."""
    mesh = make_mesh(mesh)
    _check_device(state.model, mesh[0])
    replicas = []
    for dev in mesh[1:]:
        model = copy.deepcopy(state.model).to(dev)
        groups = param_groups(model)
        opt = {}
        for g, src in state.opt.items():
            opt[g] = Adam(groups[g])
            opt[g].load_state_dict({"mu": src.mu.clone(),
                                    "nu": src.nu.clone(),
                                    "count": src.count})
        replicas.append((model, opt))
    return state._replace(replicas=tuple(replicas))


def _check_device(model: torch.nn.Module, device: torch.device) -> None:
    dev = canonical_device(next(model.parameters()).device)
    if dev != device:
        raise ValueError(f"a replica on {dev} where the mesh has {device}")


def mesh_replicas(state: TrainState, mesh: Sequence[torch.device]
                  ) -> List[tuple]:
    """The state's (model, opt) per mesh device, checked against the
    mesh."""
    replicas = [(state.model, state.opt), *state.replicas]
    if len(replicas) != len(mesh):
        raise ValueError(
            f"the state holds {len(replicas)} replicas for a mesh of "
            f"{len(mesh)} devices; build it with AvatarTrainer(mesh=)"
            ".init_state or replicate_state")
    for (model, _), dev in zip(replicas, mesh):
        _check_device(model, dev)
    return replicas


def split_batch(mesh: Sequence[torch.device], batch) -> List[dict]:
    """The batch (a dict of tensors) as one block of every tensor's first
    dimension per mesh device (parallel/mesh.shard_batch). A dimension
    that does not divide by the mesh size raises a ValueError: JAX would
    replicate such a tensor, and the step would then no longer be the
    whole-batch step."""
    for k, v in batch.items():
        if v.dim() == 0 or v.shape[0] % len(mesh):
            raise ValueError(
                f"batch[{k!r}] of shape {tuple(v.shape)} does not split "
                f"over a mesh of {len(mesh)} devices")
    placed = shard_batch(mesh, batch)
    return [{k: v[r] for k, v in placed.items()} for r in range(len(mesh))]


def mesh_jitter(mesh, batch, n_samples: int, perturb: bool, generator=None,
                t_rand=None) -> list:
    """The sample jitter of a step over the mesh, one (B / n, R, S) block
    per device: ``t_rand``, or (B, R, S) uniform draws from ``generator``
    (the draws of the one-device step from the same generator state);
    None per device where the step does not jitter."""
    if perturb and t_rand is None and generator is not None:
        t_rand = torch.rand((*batch["near"].shape, n_samples),
                            generator=generator, dtype=batch["near"].dtype,
                            device=generator.device)
    if not perturb or t_rand is None:
        return [None] * len(mesh)
    return [b["t"] for b in split_batch(mesh, {"t": t_rand})]


def mesh_losses(workers: ReplicaWorkers, replica_terms) -> dict:
    """``replica_terms(rank)`` -> a dict of elementwise loss terms, run on
    every replica of the workers' mesh (parallel/mesh.ReplicaWorkers;
    convolutions in full float32 on deterministic algorithms for all of
    them, as compute_pose_features asks); returns each term's mean over
    the whole mesh on the first device: the sum of the replicas' sums, in
    device order, over the sum of their element counts."""
    def forward(rank):
        return {k: (t.sum(), t.numel())
                for k, t in replica_terms(rank).items()}

    mesh = workers.mesh
    with f32_convolutions():
        outs = workers.run(forward)
    return {k: sum_to_first(mesh, [o[k][0] for o in outs])
            / sum(o[k][1] for o in outs) for k in outs[0]}


def mesh_apply_gradients(mesh, replicas, total: torch.Tensor,
                         lrs: Dict[str, float], timer=None) -> None:
    """One backward of ``total`` over every replica's parameters of the
    groups named in ``lrs`` (train_gradients' rules: full-float32
    deterministic convolutions, zero gradients where the forward did not
    reach), each group's gradients summed over the mesh in device order,
    and one Adam step of each replica's group with the sum, at the
    group's learning rate: every replica takes the same step."""
    names = list(lrs)
    with stage(timer, "backward"):
        params = [[param_groups(model)[g] for g in names]
                  for model, _ in replicas]
        with f32_convolutions():
            grads = iter(torch.autograd.grad(
                total, [p for rep in params for ps in rep for p in ps],
                allow_unused=True, materialize_grads=True))
        flat = [[torch.cat([next(grads).reshape(-1) for _ in ps])
                 for ps in rep] for rep in params]
        summed = [all_reduce(mesh, [f[gi] for f in flat])
                  for gi in range(len(names))]
    with stage(timer, "optimizer"):
        for r, (_, opt) in enumerate(replicas):
            for gi, g in enumerate(names):
                ps = params[r][gi]
                apply_updates(ps, opt[g].updates(
                    ps, [summed[gi][r]], float(np.float32(lrs[g]))))


def make_train_step(statics: AvatarStatics, if_type: str = "sdf",
                    sdf_thres: float = 0.1, n_samples: int = 64,
                    perturb: bool = True,
                    loss_weights=(1.0, 0.5, 0.05, 0.05), mesh=None):
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

    ``mesh`` (parallel/mesh.make_mesh devices): the whole-batch step over
    the mesh (the module docstring). The state holds a replica per device
    (AvatarTrainer(mesh=).init_state, replicate_state); the batch, on any
    device, splits over the mesh (split_batch); the generator draws the
    (B, R, S) jitter on its device, as the one-device step does, and the
    draws split with the batch; the metrics are on the mesh's first
    device; the timer's stages are forward, backward and optimizer. A
    one-device mesh is the one-device step.
    """
    mesh = None if mesh is None else make_mesh(mesh)
    if mesh is not None and len(mesh) > 1:
        return _make_mesh_train_step(mesh, statics, if_type, sdf_thres,
                                     n_samples, perturb, loss_weights)
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


def _make_mesh_train_step(mesh, statics, if_type, sdf_thres, n_samples,
                          perturb, loss_weights):
    loss_terms = [make_loss_terms(statics.to(d), if_type, sdf_thres,
                                  n_samples, perturb) for d in mesh]
    workers = ReplicaWorkers(mesh)

    def train_step(state: TrainState, batch, lrs, generator=None,
                   t_rand=None, timer=None):
        replicas = mesh_replicas(state, mesh)
        shards = split_batch(mesh, batch)
        t_rands = mesh_jitter(mesh, batch, n_samples, perturb, generator,
                              t_rand)

        def replica_terms(rank):
            model = replicas[rank][0]
            model.train()
            return loss_terms[rank](model, shards[rank],
                                    t_rand=t_rands[rank])

        with stage(timer, "forward"):
            total, metrics = total_loss(
                mesh_losses(workers, replica_terms), loss_weights)
        mesh_apply_gradients(mesh, replicas, total,
                             {g: lrs[gi] for gi, g in enumerate(GROUPS)},
                             timer)
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
    when asked for. With ``mesh`` (parallel/mesh.make_mesh devices; its
    first device is the trainer's) ``train_step`` is the step over the
    mesh and ``init_state`` replicates; ``fit`` stays on one device."""

    statics: AvatarStatics
    net_ckpt_dir: str
    if_type: str = "sdf"
    cano_template_lr: float = 1e-3
    warping_field_lr: float = 1e-4
    n_samples: int = 64
    loss_weights: tuple = (1.0, 0.5, 0.05, 0.05)
    log_name: str = "train"
    device: Optional[torch.device] = None
    mesh: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if self.mesh is None:
            self.device = resolve_device(self.device)
        else:
            self.mesh = make_mesh(self.mesh)
            if (self.device is not None
                    and canonical_device(self.device) != self.mesh[0]):
                raise ValueError(f"device {self.device} is not the mesh's "
                                 f"first device {self.mesh[0]}")
            self.device = self.mesh[0]
        self.statics = self.statics.to(self.device)
        self.train_step = make_train_step(
            self.statics, self.if_type, n_samples=self.n_samples,
            loss_weights=self.loss_weights, mesh=self.mesh)
        self.lr_schedule_template = StepSchedule(self.cano_template_lr,
                                                 5000, 0.5)
        self.lr_schedule_warp = StepSchedule(self.warping_field_lr,
                                             20000, 0.5)

    def init_state(self, model: GeoTexAvatar) -> TrainState:
        """A training state on a copy of ``model`` (the caller's model is
        left as it is), with fresh Adam moments and step 0."""
        model = copy.deepcopy(model).to(self.device).train()
        state = TrainState(model, make_optimizer(model), 0)
        return state if self.mesh is None else replicate_state(state,
                                                               self.mesh)

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
        if self.mesh is not None and len(self.mesh) > 1:
            raise ValueError("fit runs on one device, as the JAX package's "
                             "does; drive train_step over the mesh instead")
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
