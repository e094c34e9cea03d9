"""Frozen copy of avatarcap_tpu_torch/ops/adam.py at commit 2621afd, the f32 reference path of the benchmark.

Adam in optax's order of operations, shared by the normal-fusion merge
(optax.adam) and training (the JAX package's two-group Adam with learning
rates given per step, avatarcap_tpu/train/trainer.py: make_optimizer).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


class Adam:
    """optax.scale_by_adam (b1 0.9, b2 0.999, eps 1e-8 added after the
    bias-corrected sqrt, eps_root 0), then the scale by -lr and the sum of
    optax.apply_updates, over a group of tensors held as one flat vector.

    The learning rate is given per step. With lr 0 the moments and the
    count still advance, as optax's do, and the tensors keep their bits.
    The bias corrections 1 - b^t (optax raises the float32 b to the step
    count) are filled on the device, so a step makes no host-device copy.
    """

    def __init__(self, tensors: Sequence[torch.Tensor]):
        like = tensors[0]
        n = sum(t.numel() for t in tensors)
        self.mu = torch.zeros(n, dtype=like.dtype, device=like.device)
        self.nu = torch.zeros_like(self.mu)
        self.count = 0

    def _correction(self, b: float) -> torch.Tensor:
        # 1 - b^t in float32, as optax computes it, filled into a 0-d
        # tensor on the device: a true division, where a Python scalar
        # divisor would become a multiply by its reciprocal
        c = np.float32(1) - np.float32(b) ** np.float32(self.count)
        return torch.full((), float(c), dtype=self.mu.dtype,
                          device=self.mu.device)

    def direction(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Advance the moments by one step of ``grads``; returns the flat
        mu_hat / (sqrt(nu_hat) + eps)."""
        g = torch.cat([x.reshape(-1) for x in grads])
        b1, b2 = 0.9, 0.999
        self.mu = (1 - b1) * g + b1 * self.mu
        self.nu = (1 - b2) * g ** 2 + b2 * self.nu
        self.count += 1
        mu_hat = self.mu / self._correction(b1)
        nu_hat = self.nu / self._correction(b2)
        return mu_hat / (torch.sqrt(nu_hat) + 1e-8)

    def updates(self, tensors: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], lr: float
                ) -> List[torch.Tensor]:
        """One step: the per-tensor updates -lr * direction, to be added
        to ``tensors``."""
        upd = (-lr) * self.direction(grads)
        return [u.view_as(t) for t, u in
                zip(tensors, upd.split([t.numel() for t in tensors]))]

    def step(self, tensors: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """One step, out of place: the updated tensors."""
        return [t + u for t, u in zip(tensors,
                                      self.updates(tensors, grads, lr))]

    def state_dict(self) -> Dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        if state["mu"].shape != self.mu.shape:
            raise ValueError(f"Adam state of {state['mu'].numel()} elements "
                             f"for a group of {self.mu.numel()}")
        self.mu = state["mu"].to(self.mu)
        self.nu = state["nu"].to(self.nu)
        self.count = int(state["count"])
