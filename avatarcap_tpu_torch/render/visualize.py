"""Canonical front/back index passes and Phong shading (counterpart of
avatarcap_tpu/render/visualize.py: ``cano_index_passes`` with the mirror
pair and ``phong_shade``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avatarcap_tpu_torch.render.raster import RasterIndex, rasterize_index_pair


def transform_tris(tris: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) world triangle vertices x row-major (4, 4) -> (T, 3, 4)."""
    vh = torch.cat([tris, torch.ones_like(tris[..., :1])], dim=-1)
    return torch.einsum("ij,tvj->tvi", mvp, vh)


def phong_shade(cam_pos: torch.Tensor, cam_normal: torch.Tensor,
                base_color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel Phong of the reference shader: ambient .3, diffuse .7,
    specular 1, light (0, 0, 1) in camera space; material .85/.85/.1,
    shininess 10."""
    ldir = torch.tensor([0.0, 0.0, 1.0], dtype=cam_pos.dtype,
                        device=cam_pos.device)
    n = cam_normal / cam_normal.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    vdir = -cam_pos / cam_pos.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    i = -ldir
    rdir = i - 2.0 * (n * i).sum(-1, keepdim=True) * n
    diff = (n * ldir).sum(-1, keepdim=True).clamp_min(0.0)
    spec = (vdir * rdir).sum(-1, keepdim=True).clamp_min(0.0) ** 10.0
    c = (0.3 * 0.85 + 0.7 * 0.85 * diff + 1.0 * 0.1 * spec).clamp(0.0, 1.0)
    c = c.expand(cam_pos.shape)
    if base_color is not None:
        c = c * base_color
    return c


def cano_index_passes(tris: torch.Tensor, valid: torch.Tensor,
                      front_mvp: torch.Tensor, back_mvp: torch.Tensor,
                      res: int = 512, window: int = 4, big_tris: int = 0,
                      max_candidates: int = 0
                      ) -> Tuple[RasterIndex, RasterIndex]:
    """Front + back orthographic visibility buffers of the canonical mesh
    in one merged candidate pass (the matrices must be the mirror pair of
    camera.cano_front_back_mvp)."""
    return rasterize_index_pair(
        transform_tris(tris, front_mvp), transform_tris(tris, back_mvp),
        valid, res, res, window=window, big_tri_capacity=big_tris,
        max_candidates=max_candidates)
