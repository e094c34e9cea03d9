"""Dense-grid screened Poisson surface reconstruction (counterpart of
avatarcap_tpu/ops/poisson.py: ``_corner_weights``, ``_splat``,
``_sample``, ``_indicator_grid``, ``poisson_reconstruct``).

The oriented points' normals are splatted trilinearly into a vector field,
smoothed by a Gaussian and turned into the indicator chi by one spectral
solve of lap(chi) = div(V) (complex64 FFTs, frequencies ``fftfreq`` x
2 pi, the zero frequency dropped); with a point weight, a fixed number of
conjugate-gradient steps on -lap + sigma P^T P (P: trilinear sampling at
the points), preconditioned by the FFT inverse of -lap + lambda, refine it
(Kazhdan & Hoppe 2013). The surface is chi's zero crossing through
``marching_tets``, inside-positive.

The splat is a scatter-add. On the card, ``index_add_`` on float32 is
atomic and its sums change in their last bits from run to run, which
would move iso-crossings and triangle counts of a 256^3 indicator. So
``_splat`` accumulates with ``index_put_(accumulate=True)`` under
``torch.use_deterministic_algorithms``, which sorts the contributions by
voxel and sums each voxel's run in a fixed order: the same inputs give the
same bits every time.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from avatarcap_tpu_torch.device import resolve_device
from avatarcap_tpu_torch.ops.marching_cubes import Mesh, marching_tets

_OFFSETS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _corner_weights(t: torch.Tensor):
    """Eight (corner_offset, weight (N,)) trilinear pairs for fracs t."""
    out = []
    for dx, dy, dz in _OFFSETS:
        w = ((t[:, 0] if dx else 1 - t[:, 0])
             * (t[:, 1] if dy else 1 - t[:, 1])
             * (t[:, 2] if dz else 1 - t[:, 2]))
        out.append(((dx, dy, dz), w))
    return out


@contextlib.contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    caller's setting restored after it."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def _splat(vals: torch.Tensor, i0: torch.Tensor, t: torch.Tensor,
           res: int) -> torch.Tensor:
    """P^T: add per-point values (N, C) into a (res^3, C) grid, each
    point's eight trilinear shares, with a repeatable accumulate."""
    idx, contrib = [], []
    for (dx, dy, dz), w in _corner_weights(t):
        idx.append(((i0[:, 0] + dx) * res + (i0[:, 1] + dy)) * res
                   + (i0[:, 2] + dz))
        contrib.append(vals * w[:, None])
    flat = torch.zeros((res ** 3, vals.shape[-1]), dtype=vals.dtype,
                       device=vals.device)
    with _deterministic_algorithms():
        flat.index_put_((torch.cat(idx),), torch.cat(contrib),
                        accumulate=True)
    return flat


def _sample(grid_flat: torch.Tensor, i0: torch.Tensor, t: torch.Tensor,
            res: int) -> torch.Tensor:
    """P: trilinear gather of a flat (res^3,) grid at the points."""
    base = (i0[:, 0] * res + i0[:, 1]) * res + i0[:, 2]
    acc = 0.0
    for (dx, dy, dz), w in _corner_weights(t):
        acc = acc + grid_flat[base + (dx * res + dy) * res + dz] * w
    return acc


def _fftn(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftn(x.to(torch.complex64), dim=(0, 1, 2))


def _ifftn_real(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftn(x, dim=(0, 1, 2)).real


def _indicator_grid(points: torch.Tensor, normals: torch.Tensor,
                    bmin: torch.Tensor, bmax: torch.Tensor, res: int,
                    smooth_voxels: float, point_weight: float = 0.0,
                    screen_iters: int = 10) -> torch.Tensor:
    """Oriented point cloud -> indicator volume chi (res^3), the iso at the
    sample-mean level subtracted (zero at the samples, inside-negative as
    returned; the caller flips).

    point_weight=0: the closed-form unscreened spectral solve.
    point_weight>0: ``screen_iters`` preconditioned CG steps on
    A = -lap + sigma P^T P, warm-started at the unscreened solution;
    sigma is point_weight over the mean splat density the samples see.
    """
    dev = points.device
    extent = bmax - bmin
    f = (points - bmin) / extent * (res - 1)
    f = f.clamp(0.0, res - 1 - 1e-4)
    i0 = torch.floor(f).long()
    t = f - i0
    V = _splat(normals, i0, t, res)

    k = (torch.fft.fftfreq(res, device=dev, dtype=torch.float32)
         * 2.0 * np.pi)
    kx, ky, kz = torch.meshgrid(k, k, k, indexing="ij")
    k2 = kx * kx + ky * ky + kz * kz
    gauss = torch.exp(-0.5 * (smooth_voxels ** 2) * k2)

    Vh = torch.fft.fftn(V.reshape(res, res, res, 3).to(torch.complex64),
                        dim=(0, 1, 2))
    divh = 1j * (kx * Vh[..., 0] + ky * Vh[..., 1] + kz * Vh[..., 2])
    del Vh, V
    pos = k2 > 1e-12
    chih = torch.where(pos, divh * gauss / torch.where(pos, -k2, 1.0),
                       torch.zeros((), dtype=divh.dtype, device=dev))
    chi_flat = _ifftn_real(chih).reshape(-1)
    del chih
    iso = _sample(chi_flat, i0, t, res).mean()

    if point_weight > 0.0:
        W = _splat(torch.ones((points.shape[0], 1), dtype=chi_flat.dtype,
                              device=dev), i0, t, res)[:, 0]
        w_bar = (W * W).sum() / W.sum().clamp_min(1e-12)
        sigma = point_weight / w_bar.clamp_min(1e-12)
        del W
        n = points.shape[0]
        # in y = chi - iso the targets are 0 and b = -div(V_s)
        b = _ifftn_real(-divh * gauss).reshape(-1)
        del divh
        lam = sigma * n / (res ** 3)

        def A(x):
            lap = _ifftn_real(k2 * _fftn(x.reshape(res, res, res)))
            return lap.reshape(-1) + sigma * _splat(
                _sample(x, i0, t, res)[:, None], i0, t, res)[:, 0]

        def Minv(r):
            rh = _fftn(r.reshape(res, res, res))
            return _ifftn_real(rh / (k2 + lam)).reshape(-1)

        x = chi_flat - iso
        r = b - A(x)
        z = Minv(r)
        p = z
        for _ in range(screen_iters):
            Ap = A(p)
            rz = torch.dot(r, z)
            alpha = rz / torch.dot(p, Ap).clamp_min(1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Minv(r)
            beta = torch.dot(r, z) / rz.clamp_min(1e-30)
            p = p * beta + z
        chi_flat = x
        iso = _sample(chi_flat, i0, t, res).mean()

    return (chi_flat - iso).reshape(res, res, res)


def poisson_reconstruct(points: np.ndarray, normals: np.ndarray,
                        res: int = 256, pad: float = 0.1,
                        smooth_voxels: float = 1.5,
                        max_tris: int = 1 << 20,
                        max_active: int = 1 << 18,
                        point_weight: float = 4.0,
                        screen_iters: int = 10, device=None,
                        return_mesh: bool = False):
    """Watertight mesh from an oriented point cloud, on ``device`` (the
    card unless the caller names the CPU).

    Args:
      points: (N, 3) float32; normals: (N, 3) OUTWARD normals.
      res: dense grid resolution; pad: world padding around the points'
        box (absorbs the spectral solve's periodic boundary);
      smooth_voxels: Gaussian sigma in voxels; point_weight: screening
        strength (4.0 as the reference binary's default, 0 unscreened);
      screen_iters: preconditioned CG steps when screening.
    Returns:
      (vertices (3 * num_tris, 3) soup, num_tris), and the full
      ``Mesh`` (its ``overflow`` bit) third with ``return_mesh``.
    """
    device = resolve_device(device)
    pts_np = np.asarray(points, np.float32)
    pts = torch.as_tensor(pts_np, device=device)
    nrm = torch.as_tensor(np.asarray(normals, np.float32), device=device)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    bmin = torch.as_tensor(pts_np.min(0) - pad, device=device)
    bmax = torch.as_tensor(pts_np.max(0) + pad, device=device)
    with torch.no_grad():
        chi = _indicator_grid(pts, nrm, bmin, bmax, res, smooth_voxels,
                              point_weight=point_weight,
                              screen_iters=screen_iters)
        voxel = (bmax - bmin) / res
        # chi is inside-NEGATIVE as computed (outward normals: the
        # divergence sinks inside); the repo's convention is
        # inside-positive
        mesh: Mesh = marching_tets(-chi, 0.0, bmin, voxel,
                                   max_tris=max_tris, max_active=max_active)
    nt = int(mesh.num_tris)
    verts = mesh.vertices[: 3 * nt].cpu().numpy()
    return (verts, nt, mesh) if return_mesh else (verts, nt)
