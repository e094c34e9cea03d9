"""Ray generation and ray/AABB intersection (counterpart of
avatarcap_tpu/ops/rays.py). Each function takes numpy arrays (the host
data pipeline, data/ray_sampling.py) or torch tensors (the JAX package's
``xp=jnp`` use) and returns the same kind; the ray and box conventions
live here only.
"""

from __future__ import annotations

import numpy as np
import torch


class _Numpy:
    @staticmethod
    def norm(x, keepdims=False):
        return np.linalg.norm(x, axis=-1, keepdims=keepdims)

    @staticmethod
    def stack(xs):
        return np.stack(xs, axis=-1)

    @staticmethod
    def arange(n, like):
        return np.arange(n, dtype=like.dtype)

    @staticmethod
    def const(values, like):
        return np.asarray(values, dtype=like.dtype)

    inv = staticmethod(np.linalg.inv)
    meshgrid = staticmethod(np.meshgrid)
    broadcast_to = staticmethod(np.broadcast_to)
    where = staticmethod(np.where)
    amin = staticmethod(lambda x: x.min(-1))
    amax = staticmethod(lambda x: x.max(-1))


class _Torch:
    @staticmethod
    def norm(x, keepdims=False):
        return torch.linalg.norm(x, dim=-1, keepdim=keepdims)

    @staticmethod
    def stack(xs):
        return torch.stack(xs, dim=-1)

    @staticmethod
    def arange(n, like):
        return torch.arange(n, dtype=like.dtype, device=like.device)

    @staticmethod
    def const(values, like):
        return torch.tensor(values, dtype=like.dtype, device=like.device)

    inv = staticmethod(torch.linalg.inv)
    meshgrid = staticmethod(torch.meshgrid)
    broadcast_to = staticmethod(torch.broadcast_to)
    where = staticmethod(torch.where)
    amin = staticmethod(lambda x: x.amin(-1))
    amax = staticmethod(lambda x: x.amax(-1))


def _xp(x):
    return _Torch if isinstance(x, torch.Tensor) else _Numpy


def get_rays(H: int, W: int, K, R, T):
    """Per-pixel world-space rays of an H x W image with intrinsics K and
    world->camera x_c = R x_w + T: the camera center o = -R^T T and, for
    pixel (x, y), d = R^T K^{-1} (x, y, 1) normalised (pixel centers at
    integer coordinates). Returns rays_o, rays_d: (H, W, 3)."""
    xp = _xp(R)
    T = T.reshape(3)
    rays_o = -(R.T @ T)
    i, j = xp.meshgrid(xp.arange(W, rays_o), xp.arange(H, rays_o),
                       indexing="xy")
    xy1 = xp.stack([i, j, i * 0 + 1])
    # rows of xy1 are pixel vectors: p K^{-T} R = (R^T K^{-1} p^T)^T
    rays_d = (xy1 @ xp.inv(K).T) @ R
    rays_d = rays_d / xp.norm(rays_d, keepdims=True)
    return xp.broadcast_to(rays_o, rays_d.shape), rays_d


def get_near_far(bounds, ray_o, ray_d):
    """Ray/AABB intersection through the 6 box planes, with the
    reference's 0.01 padding of the bounds and its rule that a ray hits
    when exactly two plane hits lie on the box.

    Args:
      bounds: (2, 3) min/max corners; ray_o, ray_d: (N, 3).
    Returns:
      near (N,), far (N,), mask_at_box (N,) bool; near and far are 0
      where the ray misses.
    """
    xp = _xp(ray_o)
    pad = xp.const([-0.01, 0.01], ray_o)
    bounds = bounds + pad[:, None]
    nominator = bounds[None] - ray_o[:, None]                  # (N, 2, 3)
    d_intersect = (nominator / (ray_d[:, None] + 1e-9)).reshape(-1, 6)
    p_intersect = (d_intersect[..., None] * ray_d[:, None]
                   + ray_o[:, None])                           # (N, 6, 3)
    eps = 1e-6
    lo = bounds[0] - eps
    hi = bounds[1] + eps
    at_box = ((p_intersect >= lo) & (p_intersect <= hi)).all(-1)
    mask_at_box = at_box.sum(-1) == 2
    # the (up to) two in-box depths without compaction: misses masked to
    # +-inf, then min and max
    norm_ray = xp.norm(ray_d)
    depth = xp.norm(p_intersect - ray_o[:, None]) / norm_ray[:, None]
    near = xp.amin(xp.where(at_box, depth, np.inf))
    far = xp.amax(xp.where(at_box, depth, -np.inf))
    near = xp.where(mask_at_box, near, 0.0)
    far = xp.where(mask_at_box, far, 0.0)
    return near, far, mask_at_box
