"""Frozen copy of avatarcap_tpu_torch/ops/volume_render.py at commit 2621afd, the f32 reference path of the benchmark.

Volume-rendering compositor (counterpart of
avatarcap_tpu/ops/volume_render.py): alpha compositing with the exclusive
cumulative transmittance product of the reference's raw2outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderOutputs(NamedTuple):
    rgb_map: torch.Tensor    # (R, 3)
    disp_map: torch.Tensor   # (R,)
    acc_map: torch.Tensor    # (R,)
    weights: torch.Tensor    # (R, S)
    depth_map: torch.Tensor  # (R,)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                white_bkgd: bool = False) -> RenderOutputs:
    """Composite per-sample (rgb, alpha) along rays.

    Args:
      raw: (R, S, 4) rgb + alpha per sample (alpha already 1 - exp(-sigma
        dist)).
      z_vals: (R, S) sample depths.
    """
    rgb = raw[..., :-1]
    alpha = raw[..., -1]
    # exclusive cumprod of (1 - alpha): T_i = prod_{j<i} (1 - a_j + 1e-10)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    weights = alpha * trans
    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    acc_map = weights.sum(-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)


def linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """linspace(0, 1, n) with jnp.linspace's values: i times the rounded
    reciprocal of n - 1 (XLA turns the division by a constant into that
    product), and exactly 1 last. torch.linspace can differ by an ulp."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    t = torch.arange(n, dtype=dtype, device=device) * (1.0 / (n - 1))
    # a fill, where t[-1] = 1.0 would copy a host scalar (and wait)
    t[n - 1:].fill_(1.0)
    return t


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      perturb: bool,
                      generator: Optional[torch.Generator] = None,
                      t_rand: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Sample depths along rays, (..., R) -> (..., R, S): linspace(near,
    far) per ray, jittered within each sample's bin when ``perturb`` and
    either the uniform draws themselves (``t_rand``, shaped like the
    result) or a generator to draw them from is given."""
    t = linspace01(n_samples, near.dtype, near.device)
    z_vals = near[..., None] * (1.0 - t) + far[..., None] * t
    if perturb and (t_rand is not None or generator is not None):
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator,
                                dtype=z_vals.dtype, device=generator.device)
        z_vals = lower + (upper - lower) * t_rand.to(z_vals.device)
    return z_vals


def z_vals_to_dists(z_vals: torch.Tensor) -> torch.Tensor:
    """Per-sample segment lengths; the last repeats."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    return torch.cat([dists, dists[..., -1:]], dim=-1)
