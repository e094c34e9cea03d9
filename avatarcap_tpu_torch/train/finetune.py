"""Texture-template finetuning (counterpart of avatarcap_tpu/train/
finetune.py; the reference's main.py:162-272).

Adam 5e-4 on the canonical template only, over one scan's views. The
warp field's parameters stay fixed; it still runs in training mode, so its
BatchNorm statistics update, as in the JAX step. The geometry is anchored
by an L1 loss against the occupancy of a frozen copy of the initial
network, run in eval mode (its running statistics). Total = image MSE +
0.5 x anchor L1. Over a mesh (``make_finetune_step(mesh=)``) the step is
the whole-batch step, on train/trainer.py's machinery: the trained
model's BatchNorms take the mesh's statistics, each replica's anchor
stays in eval mode, and only the template's Adam group moves.
"""

from __future__ import annotations

import copy
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.ops.adam import Adam
from avatarcap_tpu_torch.parallel.mesh import ReplicaWorkers, make_mesh
from avatarcap_tpu_torch.pipeline.avatar import (
    AvatarStatics, compute_pose_features, query_occupancy)
from avatarcap_tpu_torch.train import checkpoints as ckpt
from avatarcap_tpu_torch.train.trainer import (
    TrainState, apply_updates, batch_to_device, frame_inputs, mesh_jitter,
    mesh_apply_gradients, mesh_losses, mesh_replicas, param_groups,
    render_train_rays, replicate_state, split_batch)

FINETUNE_LR = 5e-4


def finetune_state(model: GeoTexAvatar, mesh=None) -> TrainState:
    """A finetuning state: Adam on ``model``'s template parameters only,
    step 0 (``model`` itself is trained in place); over ``mesh`` (whose
    first device holds ``model``) replicated to every device of it."""
    state = TrainState(model, {"cano_template": Adam(
        param_groups(model)["cano_template"])}, 0)
    return state if mesh is None else replicate_state(state, mesh)


def _finetune_terms(model, init_model, batch, statics, n_samples,
                    generator, t_rand):
    """The finetune step's forward: the squared image errors of the
    trained model (its BatchNorms in training mode) and the anchor L1 per
    geometry point against the frozen anchor (eval mode)."""
    model.train()
    frame = frame_inputs(batch)
    feat = compute_pose_features(model, frame.smpl_pos_map, train=True)
    occ = query_occupancy(model, batch["cano_pts"], feat,
                          statics)["cano_pts_ov"]
    rgb_map, _ = render_train_rays(model, batch, feat, frame, statics,
                                   n_samples, True, generator, t_rand)
    init_model.eval()
    with torch.no_grad():
        feat0 = compute_pose_features(init_model, frame.smpl_pos_map)
        occ_init = query_occupancy(init_model, batch["cano_pts"], feat0,
                                   statics)["cano_pts_ov"]
    return {"tex_loss": torch.square(rgb_map - batch["rgb"]),
            "geo_loss": (occ - occ_init).abs()}


def make_finetune_step(statics: AvatarStatics, n_samples: int = 64,
                       mesh=None):
    """The finetune step:

      step(state, init_model, batch, generator=None, t_rand=None)
        -> (state, metrics)

    ``init_model`` is the frozen anchor (kept in eval mode; not changed).
    Samples along the rays are always jittered: by the given (B, R, S)
    draws ``t_rand``, or drawn from ``generator``.

    ``mesh``: the whole-batch step over the mesh, as train/trainer.py's
    (finetune_state(mesh=) replicates the state); ``init_model`` is then
    one anchor per mesh device, on it. A one-device mesh is the
    one-device step."""
    mesh = None if mesh is None else make_mesh(mesh)
    if mesh is not None and len(mesh) > 1:
        return _make_mesh_finetune_step(mesh, statics, n_samples)

    def step(state: TrainState, init_model: GeoTexAvatar, batch,
             generator=None, t_rand=None):
        model = state.model
        terms = _finetune_terms(model, init_model, batch, statics,
                                n_samples, generator, t_rand)
        img_loss = terms["tex_loss"].mean()
        geo_loss = terms["geo_loss"].mean()
        total = img_loss + 0.5 * geo_loss
        params = param_groups(model)["cano_template"]
        grads = torch.autograd.grad(total, params)
        apply_updates(params, state.opt["cano_template"].updates(
            params, grads, FINETUNE_LR))
        metrics = {"tex_loss": img_loss, "geo_loss": geo_loss,
                   "total_loss": total}
        return (state._replace(step=state.step + 1),
                {k: v.detach() for k, v in metrics.items()})

    return step


def _make_mesh_finetune_step(mesh, statics, n_samples):
    statics_r = [statics.to(d) for d in mesh]
    workers = ReplicaWorkers(mesh)

    def step(state: TrainState, init_model, batch, generator=None,
             t_rand=None):
        replicas = mesh_replicas(state, mesh)
        anchors = list(init_model)
        if len(anchors) != len(mesh):
            raise ValueError(f"{len(anchors)} anchors for a mesh of "
                             f"{len(mesh)} devices: give one per device")
        shards = split_batch(mesh, batch)
        t_rands = mesh_jitter(mesh, batch, n_samples, True, generator,
                              t_rand)
        losses = mesh_losses(workers, lambda r: _finetune_terms(
            replicas[r][0], anchors[r], shards[r], statics_r[r], n_samples,
            None, t_rands[r]))
        total = losses["tex_loss"] + 0.5 * losses["geo_loss"]
        mesh_apply_gradients(mesh, replicas, total,
                             {"cano_template": FINETUNE_LR})
        return (state._replace(step=state.step + 1),
                {k: v.detach() for k, v in
                 {**losses, "total_loss": total}.items()})

    return step


def finetune_texture_template(cfg, statics: AvatarStatics, dataset,
                              state: TrainState, end_epoch: int = 1000,
                              log_fn=print, batch_size: int = 4,
                              num_workers: int = 3,
                              device=None) -> TrainState:
    """The finetuning loop (the reference's main.py:162-272): ``end_epoch``
    epochs over the views of the scan ``cfg.training.finetune_tex_data_idx``
    in batches of ``batch_size`` views, decoded on a thread pool; a
    checkpoint every 20 epochs and ``epoch_latest`` under
    ``cfg.training.net_ckpt_dir/finetune_tex``, the losses (read back one
    step late) in its ``loss.jsonl``. ``cfg`` needs ``n_samples`` and
    ``training.{finetune_tex_data_idx, net_ckpt_dir}``. ``state``'s model
    is copied twice: the frozen anchor and the model finetuned."""
    device = resolve_device(device)
    statics = statics.to(device)
    step_fn = make_finetune_step(statics, n_samples=cfg.n_samples)
    init_model = copy.deepcopy(state.model).to(device).eval()
    ft_state = finetune_state(copy.deepcopy(state.model).to(device))

    rel = dataset.data_indices.index(cfg.training.finetune_tex_data_idx)
    indices = list(range(dataset.img_num_per_pose * rel,
                         dataset.img_num_per_pose * (rel + 1)))
    out_dir = os.path.join(cfg.training.net_ckpt_dir, "finetune_tex")
    os.makedirs(out_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(314)
    nprng = np.random.RandomState(314)
    batch_size = max(1, min(batch_size, len(indices)))

    def log_metrics(epoch_idx, batch_idx, metrics):
        with open(os.path.join(out_dir, "loss.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": epoch_idx, "batch": batch_idx,
                                **{k: float(v)
                                   for k, v in metrics.items()}}) + "\n")

    prev = None
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        def build_batch(idxs, seed0):
            futs = [pool.submit(dataset.__getitem__, int(ix),
                                np.random.RandomState(seed0 + 7919 * j))
                    for j, ix in enumerate(idxs)]
            items = [f.result() for f in futs]
            return batch_to_device(
                {k: np.stack([it[k] for it in items])
                 for k, v in items[0].items() if isinstance(v, np.ndarray)},
                device)

        for epoch_idx in range(end_epoch):
            t0 = time.time()
            nprng.shuffle(indices)
            for batch_idx in range(max(1, len(indices) // batch_size)):
                idxs = indices[batch_idx * batch_size:
                               (batch_idx + 1) * batch_size]
                batch = build_batch(idxs, 314 + epoch_idx * 100003
                                    + batch_idx * 131)
                ft_state, metrics = step_fn(ft_state, init_model, batch,
                                            generator=generator)
                if prev is not None:
                    log_metrics(*prev)
                prev = (epoch_idx, batch_idx, metrics)
            log_fn(f"finetune epoch {epoch_idx} took "
                   f"{time.time() - t0:.1f} s")
            if epoch_idx % 20 == 0 and epoch_idx > 0:
                ckpt.save_train_state(
                    os.path.join(out_dir, f"epoch_{epoch_idx}"), ft_state)
    if prev is not None:
        log_metrics(*prev)
    ckpt.save_train_state(os.path.join(out_dir, "epoch_latest"), ft_state)
    return ft_state
