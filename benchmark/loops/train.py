"""The training loop: ``AvatarTrainer.train_step`` at full width on a pool
of posed batches on the device, cycled, with no synchronise between
steps.

Set-up builds one trainer state from the seed's weights and drives it
through the first ``mix["checked_steps"]`` steps (batches 0, 1, 2 of the
pool, each with its own sample jitter) through the window's own call;
those steps are the warm-up too. The state after step 1 (Adam's first
moments) and after the last checked step is copied aside. The window then
continues the same state. After it: the peak memory, the program freed,
and the reference's steps from the same weights and batches compared
with the copies.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import generate, networks, subject
from benchmark.harness import Run
from benchmark.reference import precision
from benchmark.reference.train_check import compare, reference_steps
from benchmark.trace import StageMarks, reduce_device_trace, reduce_trace, \
    window_range


def snapshot(model) -> dict:
    """Every parameter and BatchNorm buffer, copied."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if v.is_floating_point()}


def first_gradients(state, groups) -> dict:
    """Each parameter's first gradient as Adam holds it after one step:
    mu_1 = (1 - b1) g."""
    out = {}
    for g, names in groups.items():
        mu = state.opt[g].mu.detach() / (1.0 - 0.9)
        sizes = [p.numel() for _, p in names]
        for (name, _), part in zip(names, mu.split(sizes)):
            out[name] = part.clone()
    return out


def run(r: Run) -> None:
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer, GROUPS

    cfg, mix, dev = r.cfg, r.mix, r.device
    networks.check(cfg)
    tr = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, statics, cano_v = subject.toy_avatar_statics(cfg["body"], dev)
    init = subject.train_weights(cfg, r.seed)
    pool_np = generate.train_pool(mix, cfg, params, cano_v,
                                  statics.cano_smpl_center.cpu().numpy(),
                                  r.seed)
    pool = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in pool_np]
    model = networks.build(cfg, "avatar", "program")
    model.load_state_dict(init)
    trainer = AvatarTrainer(
        statics=AvatarStatics(*(t.detach().clone() for t in statics)),
        net_ckpt_dir="unused", if_type=cfg["if_type"],
        n_samples=tr["n_samples"], loss_weights=tuple(tr["loss_weights"]),
        device=dev)
    state = trainer.init_state(model)
    del model
    named = dict(state.model.named_parameters())
    groups = {g: [(n, p) for n, p in named.items()
                  if (n.startswith("cano_template.")) == (g == GROUPS[0])]
              for g in GROUPS}
    lrs = np.array(mix["lrs"], np.float32)
    losses = []

    def step(i, timer=None):
        nonlocal state
        b = pool[i % len(pool)]
        batch = {k: v for k, v in b.items() if k != "t_rand"}
        state, m = trainer.train_step(state, batch, lrs, t_rand=b["t_rand"],
                                      timer=timer)
        losses.append(m["total_loss"])

    p0 = snapshot(state.model)
    grads1 = None
    for i in range(mix["checked_steps"]):
        step(i)
        if i == 0:
            grads1 = first_gradients(state, groups)
    p_last = snapshot(state.model)
    checked_losses = torch.stack(losses).cpu().numpy()
    losses.clear()
    r.setup_s = time.perf_counter() - r.t0
    start = mix["checked_steps"]
    cuda = dev.type == "cuda"

    def stretch(timer=None):
        """Up to trace_steps steps within a third of the run's seconds;
        their count and seconds, to a synchronise."""
        n, t_start = 0, time.perf_counter()
        while (n < mix["trace_steps"]
               and time.perf_counter() - t_start < r.seconds / 3):
            step(start + r.iterations, timer)
            r.iterations += 1
            n += 1
        if cuda:
            torch.cuda.synchronize(dev)
        return n, time.perf_counter() - t_start

    if r.trace:
        # the steps' host time, a device-only profile (busy time, kernel
        # times), then one with the stage ranges (benchmark/trace.py)
        from torch.profiler import ProfilerActivity, profile
        n, secs = stretch()
        r.host_stages = {"iterations": n, "window_s": secs, "seconds": {}}
        with profile(activities=[ProfilerActivity.CUDA] if cuda
                     else [ProfilerActivity.CPU]) as prof:
            t_start = time.perf_counter_ns()
            n = stretch()[0]
            window_ns = time.perf_counter_ns() - t_start
        r.summary = dict(reduce_device_trace(prof, window_ns), iterations=n)
        del prof
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])) as prof:
            with window_range():
                n = stretch(StageMarks())[0]
        staged = reduce_trace(prof)
        r.stage_summary = None if staged is None else dict(staged,
                                                           iterations=n)
        del prof
        r.window_s = r.summary["window_ns"] * 1e-9
    else:
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < r.seconds:
            step(start + r.iterations)
            r.iterations += 1
        if cuda:
            torch.cuda.synchronize(dev)
        r.window_s = time.perf_counter() - t_start
    window_losses = torch.stack(losses).cpu().numpy()
    r.attempted = mix["checked_steps"] + r.iterations
    r.failed = int((~np.isfinite(checked_losses)).sum()
                   + (~np.isfinite(window_losses)).sum())
    if dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del state, trainer, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx = (precision.CONTROLS[r.control] if r.control is not None
           else precision.f32)
    with ctx():
        ref = reference_steps(cfg, mix, init, statics, pool_np, dev)
    if r.control is not None:
        # the control in the program's place, against the float32 reference
        with precision.f32():
            want = reference_steps(cfg, mix, init, statics, pool_np, dev)
        got = ref
    else:
        want = {"losses": checked_losses, "grads1": grads1, "p0": p0,
                "p_last": p_last}
        got, want = want, ref
    r.checks.update(compare(got, want))
