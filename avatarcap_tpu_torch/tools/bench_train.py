"""Avatar training on one NVIDIA GPU: the repo's training workload
(tools/bench_workloads.build_train_env: GeoTexAvatar at its published
widths, batch 4, 1,024 rays x 64 samples and 5,000 + 312 geometry points
an item, 256^2 x 6 position maps, the toy body densified to 6,752
vertices) driven through the port's training entry points, and checked.

- The full-width step: one warm-up step, then ``--steps`` steps on the
  same batch at lrs [1e-3, 1e-4], each between two synchronisations:
  median and min ms, points per second (ray samples + geometry points),
  peak device memory, the five losses of the first and the last step
  (finite; the total must fall), the step's multiply-adds with the
  bound they set at the card's float32 peak, and the kernels' launches
  over the steps (tools/bench_stream's count; on the card the
  nearest-vertex kernel's must be one an item, inverse skinning's).
- The synchronised stage times of one step.
- The epoch-0 policy: one step at lrs [1e-3, 0] leaves every warp-field
  parameter's bits as they were, moves every template parameter and the
  warp field's BatchNorm statistics.
- The card against the CPU: one small step (batch 2, 32 rays x 8
  samples, 256 + 64 points, 128^2 maps, the same jitter) from one
  state_dict on both: losses, gradients, parameters after the step, and
  the card's Adam on the CPU's gradients.
- AvatarTrainer.fit: 2 epochs of 2 full-width batches from an in-memory
  source, checkpoints written and read back bit for bit, 4 steps.
- Finetuning: 2 full-width make_finetune_step steps, the warp field's
  parameters unchanged bit for bit, the template's moved.
- Repeatability: the largest parameter difference between two runs of
  one step from one state (reported: grid_sample's and the gathers'
  backward add with atomics on the card).

Prints ``[train] {...}`` (one JSON line) and returns the record; raises
AssertionError on a failed check and without a CUDA device.

``--mesh`` (``run_mesh``, chip_smoke.py's ``[train_mesh]``) runs the
data-parallel step instead: the one-device step timed beside it, then
the full-width step over two replicas on the first card and, where more
cards are visible, over the most cards that the batch of 4 divides
among (one item a card on four), each from the state and generator of a
one-device step:

- the five losses of one step against the one-device step's (rtol
  MESH_LOSS_RTOL), and the parameters by tests/test_torch_train.py's
  rule (every element within 2 lr + 1e-6, MESH_STEP_SHARE of each group
  within MESH_STEP_TOL);
- the replicas' parameters, BatchNorm statistics and Adam moments
  bit-equal after 3 steps;
- the median and min ms of ``--steps`` steps, each between
  synchronisations of every card; points per second; peak memory per
  card; each card's busy share over one profiled step (the union of its
  kernels' intervals over the span of the step's kernels on all cards);
- the epoch-0 policy over the mesh: lrs [1e-3, 0] leaves every warp
  field parameter's bits on every replica;
- one finetune step over the mesh: the warp field's bits kept, the
  template moved, the replicas bit-equal.

Prints ``[train_mesh] {...}``.

Usage: python -m avatarcap_tpu_torch.tools.bench_train [--steps 10]
       [--mesh]
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from avatarcap_tpu_torch.utils.timers import StageTimer

# H100 SXM data-sheet float32 peak outside the tensor cores (TF32 is off)
PEAK_F32_FLOPS = 67e12
# The card-vs-CPU step, float32 on both with different summation orders,
# at 128^2 maps (at 64^2 the U-Net's innermost BatchNorms normalise over
# 2 values a channel and the gradients of the two devices differ ~5x
# more: 1.4% of the model's gradient norm, against 0.25% at 128^2).
# Losses relative. Gradients relative to each tensor's norm, floored at
# 1e-3 of the largest tensor norm (the biases that feed a BatchNorm have
# a gradient of exactly 0 in exact arithmetic, float32 noise on each
# side): the whole model's and the median tensor's within CPU_GRAD_RTOL,
# every tensor within CPU_GRAD_RTOL_MAX (measured 0.25%, 0.18% and 0.56%).
# The first Adam step is lr g / (|g| + eps) per element, so an element
# whose gradients differ in sign moves by +-lr on either side: the card's
# Adam, given the CPU's gradients, must land within 1e-6 of the CPU's
# step on CPU_PARAM_SHARE of the elements (measured all, within 1.5e-8),
# and each side's step on its own gradients on CPU_OWN_STEP_SHARE
# (measured 98.9% of the template's elements, 99.92% of the warp
# field's: PE(10) turns float32 noise into the gradient differences
# above), every element within 2 lr + 1e-6.
CPU_LOSS_RTOL = 1e-4
CPU_GRAD_RTOL = 1e-2
CPU_GRAD_RTOL_MAX = 2e-2
CPU_PARAM_SHARE = 0.999
CPU_OWN_STEP_SHARE = 0.97
# The mesh step against the one-device step: the same float32 formulas
# in another summation order (the BatchNorm statistics from the mesh's
# sums, the losses and gradients summed over replicas), and the card's
# atomics in the backward on both: the CPU tests' rules
# (tests/test_torch_train_mesh.py, tests/test_torch_train.py)
MESH_LOSS_RTOL = 1e-4
MESH_STEP_TOL = 1e-5
MESH_STEP_SHARE = 0.995
SMALL = dict(batch_size=2, n_rays=32, n_samples=8, n_surf=256, n_vol=64,
             pos_map_res=128, dense=False)
LRS = (1e-3, 1e-4)
CKPT_DIR = Path(__file__).resolve().parents[2] / "build" / "train_ckpt"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_macs(model, batch, n_samples: int) -> dict:
    """Multiply-adds of one train step, forward and backward (x 3): the
    per-point MLPs (OffsetDecoder, its offset head and all DoubleTNet
    heads, at every ray sample and geometry point) from the model's
    shapes, the U-Net's convolutions at the batch's map size, and the
    inverse-skinning KNN's distance products."""
    point_macs = sum(p.numel() for n, p in model.named_parameters()
                     if p.dim() == 3 and (n.startswith("cano_template.")
                                          or ".mlp." in n
                                          or "out_layer" in n))
    B, R = batch["near"].shape
    n_pts = B * (R * n_samples + batch["cano_pts"].shape[1])
    unet = 0
    hooks = []

    def count(mod, _inp, out):
        nonlocal unet
        w = mod.weight
        per_out = w.shape[1] * w.shape[2] * w.shape[3]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            per_out = w.shape[0] * w.shape[2] * w.shape[3] // 4
        unet += out.numel() * per_out
    for m in model.warping_field.unet.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            hooks.append(m.register_forward_hook(count))
    with torch.no_grad():
        model.pose_features(batch["smpl_pos_map"])
    for h in hooks:
        h.remove()
    knn = B * R * n_samples * batch["live_smpl_v"].shape[1] * 3
    return {"points": n_pts, "point_macs": point_macs,
            "unet_macs": unet, "knn_macs": knn,
            "step_macs": 3 * (point_macs * n_pts + unet) + knn}


def full_width_steps(env, device, n_steps: int) -> dict:
    trainer, batch = env["trainer"], env["batch"]
    state = env["state"]
    gen = torch.Generator(device=device).manual_seed(0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, m = trainer.train_step(state, batch, LRS, generator=gen)
    first = {k: float(v) for k, v in m.items()}
    from avatarcap_tpu_torch.tools.bench_stream import (_launches,
                                                         _zero_launches)
    ms = []
    _zero_launches()
    for _ in range(n_steps):
        _sync(device)
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch, LRS, generator=gen)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = _launches()
    last = {k: float(v) for k, v in m.items()}
    env["state"] = state
    macs = step_macs(state.model, batch, trainer.n_samples)
    median = statistics.median(ms)
    rec = {"step_ms": ms, "median_ms": median, "min_ms": min(ms),
           "points_per_s": macs["points"] / (median * 1e-3),
           "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
           "losses_first": first, "losses_last": last,
           "launches": launches, **macs,
           "bound_ms": 2 * macs["step_macs"] / PEAK_F32_FLOPS * 1e3,
           "tflops": 2 * macs["step_macs"] / (median * 1e-3) / 1e12}
    if not all(np.isfinite(list(first.values()) + list(last.values()))):
        raise AssertionError(f"non-finite losses: {first} -> {last}")
    if not last["total_loss"] < first["total_loss"]:
        raise AssertionError("the total loss did not fall over the steps: "
                             f"{first['total_loss']} -> "
                             f"{last['total_loss']}")
    items = batch["live_smpl_v"].shape[0]
    if device.type == "cuda" and launches["knn"] != n_steps * items:
        raise AssertionError(f"{n_steps} steps of {items} items launched the "
                             f"nearest-vertex kernel {launches['knn']} "
                             "times, expected one an item")
    return rec


def stage_times(env, device) -> dict:
    timer = StageTimer(device)
    gen = torch.Generator(device=device).manual_seed(1)
    env["state"], _ = env["trainer"].train_step(
        env["state"], env["batch"], LRS, generator=gen, timer=timer)
    return timer.times


def epoch0_policy(env, device) -> dict:
    """One step at lrs [1e-3, 0] (epoch 0's warp freeze)."""
    state = env["state"]
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(2)
    state, _ = env["trainer"].train_step(state, env["batch"], (LRS[0], 0.0),
                                         generator=gen)
    env["state"] = state
    after = state.model.state_dict()
    params = dict(state.model.named_parameters())
    warp = [n for n in params if n.startswith("warping_field.")]
    tpl = [n for n in params if n.startswith("cano_template.")]
    stats = [n for n in after if "running" in n]
    changed = [n for n in warp if not torch.equal(after[n], before[n])]
    still = [n for n in tpl if torch.equal(after[n], before[n])]
    frozen_stats = [n for n in stats if torch.equal(after[n], before[n])]
    if changed or still or frozen_stats:
        raise AssertionError(f"epoch-0 policy: warp parameters changed "
                             f"{changed[:3]}, template parameters unmoved "
                             f"{still[:3]}, BatchNorm statistics unmoved "
                             f"{frozen_stats[:3]}")
    return {"warp_params_bit_equal": len(warp), "template_params_moved":
            len(tpl), "bn_stats_moved": len(stats)}


def _param_diffs(a, b, names):
    """Per group: the share of elements within 1e-6, the largest
    difference and its bound 2 lr + 1e-6."""
    out = {}
    for gi, group in enumerate(("cano_template", "warping_field")):
        d = torch.cat([(a[n] - b[n]).abs().reshape(-1) for n in names
                       if n.startswith(group + ".")])
        out[group] = {"share_1e-6": float((d <= 1e-6).double().mean()),
                      "max_abs": float(d.max()),
                      "bound": 2 * LRS[gi] + 1e-6}
    return out


def card_against_cpu(device) -> dict:
    """One small step on the card and on the CPU from one state_dict with
    the same jitter; then the card's Adam on the CPU's gradients."""
    from avatarcap_tpu_torch.tools.bench_workloads import build_train_env
    from avatarcap_tpu_torch.train.trainer import (
        GROUPS, apply_gradients, make_loss_fn, param_groups,
        train_gradients)
    envs = {d: build_train_env(device=d, net_ckpt_dir=str(CKPT_DIR), **SMALL)
            for d in ("cpu", device)}
    init = {k: v.clone()
            for k, v in envs["cpu"]["state"].model.state_dict().items()}
    envs[device]["state"].model.load_state_dict(init)
    B, R, S = SMALL["batch_size"], SMALL["n_rays"], SMALL["n_samples"]
    t_rand = torch.rand((B, R, S), generator=torch.Generator().manual_seed(3))
    out = {}
    for d, e in envs.items():
        state = e["state"]
        state.model.train()
        loss_fn = make_loss_fn(e["statics"], n_samples=S)
        total, metrics = loss_fn(state.model, e["batch"],
                                 t_rand=t_rand.to(d))
        groups, grads = train_gradients(state.model, total)
        grads = [g.detach() for g in grads]
        apply_gradients(state, groups, grads, LRS)
        out[d] = ({k: float(v.detach()) for k, v in metrics.items()},
                  [g.cpu() for g in grads],
                  {k: v.detach().cpu()
                   for k, v in state.model.state_dict().items()})
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[device]
    # parameter names in param_groups' order: the template's, then the rest
    names = [n for g in GROUPS
             for n, _ in envs["cpu"]["state"].model.named_parameters()
             if n.startswith("cano_template.") == (g == "cano_template")]
    # the card's optimizer on the CPU's gradients, from the initial state
    probe = envs[device]["trainer"].init_state(envs[device]["model"])
    probe.model.load_state_dict(init)
    apply_gradients(probe, param_groups(probe.model),
                    [g.to(device) for g in gc], LRS)
    pp = {k: v.detach().cpu() for k, v in probe.model.state_dict().items()}

    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    floor = 1e-3 * max(float(g.norm()) for g in gc)
    grad_err = {n: float((a - b).norm()) / max(float(b.norm()), floor)
                for n, a, b in zip(names, gg, gc)}
    worst = max(grad_err, key=grad_err.get)
    whole = float(torch.cat([(a - b).reshape(-1) for a, b in zip(gg, gc)])
                  .norm() / torch.cat([b.reshape(-1) for b in gc]).norm())
    rec = {"losses_card": lg, "losses_cpu": lc, "loss_rel_err": loss_err,
           "grad_rel_err_whole": whole,
           "grad_rel_err_median": statistics.median(grad_err.values()),
           "grad_rel_err_max": grad_err[worst], "grad_worst": worst,
           "adam_on_cpu_grads": _param_diffs(pp, pc, names),
           "own_step": _param_diffs(pg, pc, names),
           "bn_stats_max_abs": max(float((pg[k] - pc[k]).abs().max())
                                   for k in pc if "running" in k),
           "tolerances": {"loss_rtol": CPU_LOSS_RTOL,
                          "grad_rtol": CPU_GRAD_RTOL,
                          "grad_rtol_max": CPU_GRAD_RTOL_MAX,
                          "param_share": CPU_PARAM_SHARE,
                          "own_step_share": CPU_OWN_STEP_SHARE}}
    bad = [loss_err > CPU_LOSS_RTOL, whole > CPU_GRAD_RTOL,
           rec["grad_rel_err_median"] > CPU_GRAD_RTOL,
           grad_err[worst] > CPU_GRAD_RTOL_MAX]
    for key, share in (("adam_on_cpu_grads", CPU_PARAM_SHARE),
                       ("own_step", CPU_OWN_STEP_SHARE)):
        bad += [s["share_1e-6"] < share or s["max_abs"] > s["bound"]
                for s in rec[key].values()]
    if any(bad):
        raise AssertionError(f"card against CPU: {json.dumps(rec)}")
    return rec


class InMemoryBatches:
    """A batch source for AvatarTrainer.fit: ``n_batches`` copies of one
    batch (tensors already on the card) per epoch."""

    def __init__(self, batch, n_batches: int):
        self.batch = batch
        self.n_batches = n_batches

    def __len__(self):
        return self.batch["near"].shape[0] * self.n_batches

    def batches(self, batch_size, shuffle=True, seed=0, num_workers=0):
        for _ in range(self.n_batches):
            yield self.batch


def fit_round_trip(env, device) -> dict:
    from avatarcap_tpu_torch.train import checkpoints as ckpt
    trainer = env["trainer"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    trainer.net_ckpt_dir = str(CKPT_DIR)
    state = trainer.init_state(env["model"])
    _sync(device)
    t0 = time.perf_counter()
    state = trainer.fit(InMemoryBatches(env["batch"], 2), 0, 2,
                        batch_size=env["batch"]["near"].shape[0],
                        state=state, log_fn=lambda *_: None)
    _sync(device)
    secs = time.perf_counter() - t0
    written = sorted(p.name for p in CKPT_DIR.iterdir() if p.is_dir())
    back = ckpt.load_train_state(str(CKPT_DIR / "epoch_latest"),
                                 trainer.init_state(env["model"]))
    a, b = state.model.state_dict(), back.model.state_dict()
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    diff += [(g, k) for g in state.opt for k in ("mu", "nu")
             if not torch.equal(getattr(state.opt[g], k),
                                getattr(back.opt[g], k))]
    if (not {"epoch_0", "epoch_latest"} <= set(written) or diff
            or state.step != 4 or back.step != 4):
        raise AssertionError(f"fit: dirs {written}, steps {state.step} / "
                             f"{back.step}, differing tensors {diff[:3]}")
    return {"seconds": secs, "steps": state.step, "dirs": written,
            "round_trip_bit_equal": True}


def finetune_steps(env, device) -> dict:
    from avatarcap_tpu_torch.train.finetune import (finetune_state,
                                                    make_finetune_step)
    init_model = copy.deepcopy(env["model"]).to(device).eval()
    state = finetune_state(copy.deepcopy(env["model"]).to(device))
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    step = make_finetune_step(env["statics"],
                              n_samples=env["trainer"].n_samples)
    gen = torch.Generator(device=device).manual_seed(4)
    ms = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        state, m = step(state, init_model, env["batch"], generator=gen)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    params = dict(state.model.named_parameters())
    changed = [n for n, p in params.items() if n.startswith("warping_field.")
               and not torch.equal(p, before[n])]
    still = [n for n, p in params.items() if n.startswith("cano_template.")
             and torch.equal(p, before[n])]
    losses = {k: float(v) for k, v in m.items()}
    if changed or still or not np.all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"finetune: warp changed {changed[:3]}, "
                             f"template unmoved {still[:3]}, {losses}")
    return {"step_ms": ms, "losses": losses}


def repeatability(env, device) -> dict:
    """Two runs of one step from one state with the same jitter."""
    B, R = env["batch"]["near"].shape
    t_rand = torch.rand((B, R, env["trainer"].n_samples), device=device,
                        generator=torch.Generator(device=device)
                        .manual_seed(5))
    runs = []
    for _ in range(2):
        state = env["trainer"].init_state(env["model"])
        state, _ = env["trainer"].train_step(state, env["batch"], LRS,
                                             t_rand=t_rand)
        runs.append(state.model.state_dict())
    diffs = {k: float((runs[0][k].float() - runs[1][k].float()).abs().max())
             for k in runs[0]}
    worst = max(diffs, key=diffs.get)
    return {"max_abs_diff": diffs[worst], "worst": worst,
            "tensors_differing": sum(d > 0 for d in diffs.values())}


def _sync_all(mesh):
    for dev in set(mesh):
        _sync(dev)


def _replicas_differ(state) -> list:
    """The parameters, statistics and Adam moments in which a replica's
    bits differ from the first device's."""
    def tensors(model, opt):
        out = {k: v.cpu() for k, v in model.state_dict().items()}
        out.update({f"adam.{g}.{k}": getattr(opt[g], k).cpu()
                    for g in opt for k in ("mu", "nu")})
        return out
    ref = tensors(state.model, state.opt)
    return sorted({k for model, opt in state.replicas
                   for k, v in tensors(model, opt).items()
                   if not torch.equal(v, ref[k])})


def card_busy_shares(run, mesh) -> dict:
    """Run ``run()`` under torch.profiler (card activity only): each
    card's busy share, the union of its kernels' intervals over the span
    from the first kernel's start to the last one's end on any card."""
    from torch.profiler import ProfilerActivity, profile
    from avatarcap_tpu_torch.tools.bench_stream import union_ns
    cards = sorted({d.index for d in mesh})
    _sync_all(mesh)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        _sync_all(mesh)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.name().startswith(("Memcpy", "Memset"))):
            spans.setdefault(e.device_index(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    if not spans:
        return {f"cuda:{c}": None for c in cards}
    every = [x for v in spans.values() for x in v]
    span = max(e for _, e in every) - min(s for s, _ in every)
    return {f"cuda:{c}": (union_ns(spans[c]) / span if c in spans else 0.0)
            for c in cards} | {"span_ms": span * 1e-6,
                               "kernels": len(every)}


def _step_rule(a: dict, b: dict, names) -> dict:
    """Per group: the largest parameter difference against its bound
    2 lr + 1e-6 and the share within MESH_STEP_TOL."""
    out = {}
    for gi, group in enumerate(("cano_template", "warping_field")):
        d = torch.cat([(a[n] - b[n].to(a[n].device)).abs().reshape(-1)
                       for n in names if n.startswith(group + ".")])
        out[group] = {"max_abs": float(d.max()),
                      "bound": 2 * LRS[gi] + 1e-6,
                      "share_tol": float((d <= MESH_STEP_TOL).double()
                                         .mean())}
    return out


def mesh_steps(env, mesh, n_steps: int = 10) -> dict:
    """The full-width step over ``mesh`` (whose first device is the
    env's) and its checks; see the module docstring."""
    from avatarcap_tpu_torch.train.finetune import (finetune_state,
                                                    make_finetune_step)
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer
    one_trainer, batch = env["trainer"], env["batch"]
    trainer = AvatarTrainer(statics=env["statics"], net_ckpt_dir="unused",
                            n_samples=one_trainer.n_samples, mesh=mesh)
    rec = {"devices": [str(d) for d in mesh]}
    cards = sorted({d for d in mesh if d.type == "cuda"}, key=str)

    one, m1 = one_trainer.train_step(
        one_trainer.init_state(env["model"]), batch, LRS,
        generator=torch.Generator(device=mesh[0]).manual_seed(6))
    one_params = {n: p.detach() for n, p in one.model.named_parameters()}
    # (its U-Net forward in training mode moves the BatchNorm statistics:
    # on the one-device state, which is thrown away)
    macs = step_macs(one.model, batch, trainer.n_samples)
    del one
    for d in cards:     # the peaks of the mesh's steps, not the reference's
        torch.cuda.reset_peak_memory_stats(d)
    state = trainer.init_state(env["model"])
    gen = torch.Generator(device=mesh[0]).manual_seed(6)
    state, m = trainer.train_step(state, batch, LRS, generator=gen)
    ref = {k: float(v) for k, v in m1.items()}
    got = {k: float(v) for k, v in m.items()}
    rec["losses"], rec["losses_one_device"] = got, ref
    rec["loss_rel_err"] = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                              for k in ref)
    rec["params"] = _step_rule(one_params, state.model.state_dict(),
                               list(one_params))
    for _ in range(2):
        state, m = trainer.train_step(state, batch, LRS, generator=gen)
    rec["replicas_differ_after_3"] = _replicas_differ(state)

    ms = []
    for _ in range(n_steps):
        _sync_all(mesh)
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch, LRS, generator=gen)
        _sync_all(mesh)
        ms.append(1e3 * (time.perf_counter() - t0))
    rec.update({"step_ms": ms, "median_ms": statistics.median(ms),
                "min_ms": min(ms), "points": macs["points"],
                "points_per_s": macs["points"]
                / (statistics.median(ms) * 1e-3),
                "losses_last": {k: float(v) for k, v in m.items()}})
    rec["peak_mem_gb"] = {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                          for d in cards}
    if cards:
        def one_step():
            nonlocal state
            state, _ = trainer.train_step(state, batch, LRS, generator=gen)
        rec["busy_share"] = card_busy_shares(one_step, mesh)

    before = [{n: p.detach().clone() for n, p in model.named_parameters()}
              for model, _ in [(state.model, None), *state.replicas]]
    state, _ = trainer.train_step(state, batch, (LRS[0], 0.0),
                                  generator=gen)
    changed, still = [], []
    for b, (model, _) in zip(before, [(state.model, None),
                                      *state.replicas]):
        for n, p in model.named_parameters():
            if n.startswith("warping_field.") and not torch.equal(p, b[n]):
                changed.append(n)
            if n.startswith("cano_template.") and torch.equal(p, b[n]):
                still.append(n)
    rec["epoch0"] = {"warp_changed": changed[:3],
                     "template_still": still[:3],
                     "replicas_differ": _replicas_differ(state)}

    ft = finetune_state(copy.deepcopy(env["model"]).to(mesh[0]), mesh)
    anchors = [copy.deepcopy(env["model"]).to(d).eval() for d in mesh]
    tpl_before = {n: p.detach().clone()
                  for n, p in ft.model.named_parameters()}
    step = make_finetune_step(env["statics"],
                              n_samples=trainer.n_samples, mesh=mesh)
    _sync_all(mesh)
    t0 = time.perf_counter()
    ft, fm = step(ft, anchors, batch, generator=gen)
    _sync_all(mesh)
    params = dict(ft.model.named_parameters())
    rec["finetune"] = {
        "ms": 1e3 * (time.perf_counter() - t0),
        "losses": {k: float(v) for k, v in fm.items()},
        "warp_changed": [n for n, p in params.items()
                         if n.startswith("warping_field.")
                         and not torch.equal(p, tpl_before[n])][:3],
        "template_still": [n for n, p in params.items()
                           if n.startswith("cano_template.")
                           and torch.equal(p, tpl_before[n])][:3],
        "replicas_differ": _replicas_differ(ft)}

    bad = [rec["loss_rel_err"] > MESH_LOSS_RTOL,
           rec["replicas_differ_after_3"], changed, still,
           rec["epoch0"]["replicas_differ"],
           not np.all(np.isfinite(list(rec["losses_last"].values())
                                  + list(rec["finetune"]["losses"]
                                         .values()))),
           rec["finetune"]["warp_changed"],
           rec["finetune"]["template_still"],
           rec["finetune"]["replicas_differ"]]
    bad += [g["max_abs"] > g["bound"] or g["share_tol"] < MESH_STEP_SHARE
            for g in rec["params"].values()]
    if any(bool(b) for b in bad):
        raise AssertionError(f"train step over {rec['devices']}: "
                             f"{json.dumps(rec)}")
    return rec


def mesh_for_cards(batch_size: int):
    """Every visible card, or the most of them that ``batch_size``
    divides among (the step splits the batch evenly)."""
    from avatarcap_tpu_torch.parallel.mesh import make_mesh
    k = max(k for k in range(1, torch.cuda.device_count() + 1)
            if batch_size % k == 0)
    return make_mesh([torch.device("cuda", i) for i in range(k)])


def run_mesh(device, n_steps: int = 10, **env_kw) -> dict:
    """The one-device step timed as full_width_steps does (and its busy
    share on a card), then mesh_steps over two replicas on ``device``
    and, where more cards are visible, over mesh_for_cards; ``env_kw``
    (build_train_env's sizes) shrinks the workload for a rehearsal on
    the CPU."""
    from avatarcap_tpu_torch.parallel.mesh import make_mesh
    from avatarcap_tpu_torch.tools.bench_workloads import build_train_env
    t0 = time.perf_counter()
    device = make_mesh([device])[0]
    env = build_train_env(device=device, net_ckpt_dir=str(CKPT_DIR),
                          **env_kw)
    rec = {"build_s": time.perf_counter() - t0}
    rec["one_device"] = full_width_steps(env, device, n_steps)
    if device.type == "cuda":
        def one_step():
            env["state"], _ = env["trainer"].train_step(
                env["state"], env["batch"], LRS,
                generator=torch.Generator(device=device).manual_seed(1))
        rec["one_device"]["busy_share"] = card_busy_shares(one_step,
                                                           (device,))
    rec["two_replicas_one_card"] = mesh_steps(env, make_mesh([device] * 2),
                                              n_steps)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = mesh_for_cards(env["batch"]["near"].shape[0])
        if len(mesh) > 1:
            rec[f"cards_{len(mesh)}"] = mesh_steps(env, mesh, n_steps)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run(device, n_steps: int = 10, **env_kw) -> dict:
    """Every phase above; ``env_kw`` (build_train_env's sizes) shrinks
    the workload for a rehearsal on the CPU."""
    from avatarcap_tpu_torch.tools.bench_workloads import build_train_env
    t0 = time.perf_counter()
    env = build_train_env(device=device, net_ckpt_dir=str(CKPT_DIR),
                          **env_kw)
    rec = {"build_s": time.perf_counter() - t0}
    rec["full_width"] = full_width_steps(env, device, n_steps)
    rec["stages"] = stage_times(env, device)
    rec["epoch0"] = epoch0_policy(env, device)
    rec["card_vs_cpu"] = card_against_cpu(device)
    rec["fit"] = fit_round_trip(env, device)
    rec["finetune"] = finetune_steps(env, device)
    rec["repeatability"] = repeatability(env, device)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--mesh", action="store_true",
                        help="the data-parallel step over a mesh instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from avatarcap_tpu_torch.tools.bench_kernels import (
        gpu_name_and_power_limit)
    if args.mesh:
        rec = run_mesh(torch.device("cuda"), args.steps)
        print(f"[train_mesh] {json.dumps(rec)}")
    else:
        rec = run(torch.device("cuda"), args.steps)
        print(f"[train] {json.dumps(rec)}")
    print(gpu_name_and_power_limit())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
