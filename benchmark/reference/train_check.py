"""The training cell's comparison: the reference's first steps against the
program's, from the same weights, batches and sample jitter.

- ``loss_gap``: the relative gap of the first step's total loss. (The
  later steps' losses follow parameters that Adam's first step moved by
  +-lr wherever a gradient is ~0, so their gaps swing by orders of
  magnitude from seed to seed: ``loss_gap_steps``, printed, not limited.)
- ``grad_gap``: the first gradient of each leaf as the optimizer holds it
  (Adam's first moment after one step, over 1 - b1); the worst leaf's gap
  between the two norms, over the larger of the reference leaf's norm and
  the median leaf's. Leaves whose reference gradient is under a thousandth
  of the median leaf's are left out (rounding moves them under Adam).
- ``change_gap``: the same of each leaf's change over the checked steps
  (parameters and BatchNorm statistics), the same leaves left out.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import networks
from benchmark.reference.avatar_query import AvatarStatics
from benchmark.reference.train_step import (GROUPS, TrainState,
                                            make_optimizer, make_train_step)


def reference_steps(cfg: dict, mix: dict, init: dict, statics, pool, device
                    ) -> Dict:
    """The reference's checked steps: losses, first gradients, the leaves
    before and after."""
    tr = cfg["train"]
    model = networks.build(cfg, "avatar", "reference")
    model.load_state_dict(init)
    model = model.to(device).train()
    st = AvatarStatics(*(t.to(device) for t in statics))
    step = make_train_step(st, cfg["if_type"], n_samples=tr["n_samples"],
                           loss_weights=tuple(tr["loss_weights"]))
    state = TrainState(model, make_optimizer(model), 0)
    lrs = np.array(mix["lrs"], np.float32)
    named = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()
          if v.is_floating_point()}
    losses, grads1 = [], {}
    for i in range(mix["checked_steps"]):
        b = {k: torch.from_numpy(v).to(device) for k, v in pool[i].items()}
        t_rand = b.pop("t_rand")
        state, m = step(state, b, lrs, t_rand=t_rand)
        losses.append(float(m["total_loss"]))
        if i == 0:
            for g in GROUPS:
                names = [n for n in named
                         if n.startswith("cano_template.") == (g == GROUPS[0])]
                mu = state.opt[g].mu.detach() / (1.0 - 0.9)
                for n, part in zip(names, mu.split(
                        [named[n].numel() for n in names])):
                    grads1[n] = part.clone()
    p_last = {k: v.detach().clone() for k, v in model.state_dict().items()
              if v.is_floating_point()}
    return {"losses": np.array(losses), "grads1": grads1, "p0": p0,
            "p_last": p_last}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    """max over kept leaves of |got - want| / max(want, median of want)."""
    ws = [want[k] for k in keep]
    med = float(np.median(ws)) if ws else 0.0
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-30)
                for k in keep), default=float("inf"))


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers of one run: ``got`` (the program, or a control in its
    place) against ``want`` (the reference)."""
    lg, lw = np.asarray(got["losses"]), np.asarray(want["losses"])
    g_got, g_want = _norms(got["grads1"]), _norms(want["grads1"])
    med = float(np.median(list(g_want.values())))
    moved = {k for k, v in g_want.items() if v >= 1e-3 * med}
    change_got = _norms({k: got["p_last"][k] - got["p0"][k]
                         for k in got["p0"]})
    change_want = _norms({k: want["p_last"][k] - want["p0"][k]
                          for k in want["p0"]})
    # parameters by their gradient; BatchNorm statistics all
    leaves = {k for k in change_want if k in moved or k not in g_want}
    rel = np.abs(lg - lw) / np.abs(lw)
    return {"loss_gap": float(rel[0]), "loss_gap_steps": float(rel.max()),
            "grad_gap": leaf_gap(g_got, g_want, moved),
            "change_gap": leaf_gap(change_got, change_want, leaves),
            "leaves_left_out": float(len(g_want) - len(moved))}
