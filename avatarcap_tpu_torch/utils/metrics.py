"""Mesh and point-set fidelity metrics (counterpart of
avatarcap_tpu/utils/metrics.py): the symmetric Chamfer distance, and the
Chamfer distance between two padded triangle soups through area-uniform
surface samples."""

from __future__ import annotations

from typing import Optional

import torch

from avatarcap_tpu_torch.ops.knn import knn


def chamfer_distance(a: torch.Tensor, b: torch.Tensor,
                     squared: bool = False) -> torch.Tensor:
    """Symmetric Chamfer distance between (N, 3) and (M, 3) point sets:
    mean_a min_b d(a, b) + mean_b min_a d(a, b) (squared distances when
    ``squared``)."""
    d_ab, _ = knn(a, b, k=1, chunk=min(65536, a.shape[0]))
    d_ba, _ = knn(b, a, k=1, chunk=min(65536, b.shape[0]))
    if squared:
        return d_ab[:, 0].mean() + d_ba[:, 0].mean()
    return d_ab[:, 0].sqrt().mean() + d_ba[:, 0].sqrt().mean()


def _sample_soup(soup: torch.Tensor, num_tris, samples: int,
                 generator: torch.Generator) -> torch.Tensor:
    tris = soup.reshape(-1, 3, 3)
    T = tris.shape[0]
    valid = torch.arange(T, device=soup.device) < num_tris
    area = 0.5 * torch.linalg.cross(tris[:, 1] - tris[:, 0],
                                    tris[:, 2] - tris[:, 0]).norm(dim=-1)
    area = torch.where(valid, area, torch.zeros_like(area))
    fid = torch.multinomial(area, samples, replacement=True,
                            generator=generator)
    r = torch.rand((samples, 2), generator=generator,
                   device=generator.device).to(soup.device)
    s = r[:, 0:1].sqrt()
    bary = torch.cat([1 - s, s * (1 - r[:, 1:2]), s * r[:, 1:2]], dim=-1)
    return torch.einsum("nk,nkd->nd", bary, tris[fid])


def mesh_chamfer(soup_a: torch.Tensor, num_tris_a, soup_b: torch.Tensor,
                 num_tris_b, samples: int = 100000,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Chamfer distance between two (possibly padded) triangle soups
    (3*T, 3) with their triangle counts, through ``samples`` area-uniform
    surface samples of each, drawn from ``generator`` (one on the soups'
    device; default: seeded 0)."""
    if generator is None:
        generator = torch.Generator(device=soup_a.device).manual_seed(0)
    pa = _sample_soup(soup_a, num_tris_a, samples, generator)
    pb = _sample_soup(soup_b, num_tris_b, samples, generator)
    return chamfer_distance(pa, pb)
