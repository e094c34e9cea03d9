"""Mesh renders (counterpart of avatarcap_tpu/render/visualize.py): the
canonical front/back index passes (the mirror pair) with their attribute
and Phong layers, the canonical orthographic render, one perspective or
orthographic pass, the live front/back Phong preview and normal2color.
All of it runs on the tensors' device; the back views are x-flipped as the
reference's cv.flip(img, 1)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avatarcap_tpu_torch.device import device_constant
from avatarcap_tpu_torch.render.raster import (RasterIndex, RasterOutput,
                                               interpolate, rasterize,
                                               rasterize_index_pair)


def transform_tris(tris: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) world triangle vertices x row-major (4, 4) -> (T, 3, 4)."""
    vh = torch.cat([tris, torch.ones_like(tris[..., :1])], dim=-1)
    return torch.einsum("ij,tvj->tvi", mvp, vh)


def phong_shade(cam_pos: torch.Tensor, cam_normal: torch.Tensor,
                base_color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel Phong of the reference shader: ambient .3, diffuse .7,
    specular 1, light (0, 0, 1) in camera space; material .85/.85/.1,
    shininess 10."""
    ldir = device_constant([0.0, 0.0, 1.0], cam_pos.device, cam_pos.dtype)
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


def _cam_space(tris: torch.Tensor, normal_tris: torch.Tensor,
               mv: torch.Tensor):
    """Camera-space vertices and (unnormalised) normals under ``mv``."""
    cam_v = torch.einsum("ij,tvj->tvi", mv[:3, :3], tris) + mv[:3, 3]
    cam_n = torch.einsum("ij,tvj->tvi", mv[:3, :3], normal_tris)
    return cam_v, cam_n


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def cano_interpolate(fri: RasterIndex, bri: RasterIndex,
                     attr_tris: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attribute layers (T, 3, A) at precomputed canonical index passes;
    the back x-flipped."""
    front, _ = interpolate(fri, attr_tris)
    back, _ = interpolate(bri, attr_tris)
    return front, back.flip(1)


def cano_phong(fri: RasterIndex, bri: RasterIndex, tris: torch.Tensor,
               normal_tris: torch.Tensor, front_mv: torch.Tensor,
               back_mv: torch.Tensor,
               color_tris: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phong images from precomputed index passes (render_cano_mesh's
    'phong' arithmetic; white background)."""
    def shade(ri, mv):
        cam_v, cam_n = _cam_space(tris, normal_tris, mv)
        v, _ = interpolate(ri, cam_v)
        n, _ = interpolate(ri, _unit(cam_n))
        base = (interpolate(ri, color_tris)[0] if color_tris is not None
                else None)
        img = phong_shade(v, n, base)
        return torch.where(ri.mask[..., None], img, torch.ones_like(img))

    return shade(fri, front_mv), shade(bri, back_mv).flip(1)


def _phong_pass(tris, normal_tris, valid, mvp, mv, height, width, window,
                color_tris, big_tris, unit_normals):
    cam_v, cam_n = _cam_space(tris, normal_tris, mv)
    if unit_normals:
        cam_n = _unit(cam_n)
    attrs = torch.cat([cam_v, cam_n] + ([color_tris] if color_tris
                                        is not None else []), dim=-1)
    out = rasterize(transform_tris(tris, mvp), attrs, valid, height, width,
                    window=window, big_tri_capacity=big_tris)
    base = out.attrs[..., 6:9] if color_tris is not None else None
    img = phong_shade(out.attrs[..., :3], out.attrs[..., 3:6], base)
    img = torch.where(out.mask[..., None], img, torch.ones_like(img))
    return out._replace(attrs=img)


def render_cano_mesh(tris: torch.Tensor, attr_tris: torch.Tensor,
                     valid: torch.Tensor, front_mvp: torch.Tensor,
                     front_mv: torch.Tensor, back_mvp: torch.Tensor,
                     back_mv: torch.Tensor, res: int = 512, window: int = 4,
                     shading: str = "attribute",
                     color_tris: Optional[torch.Tensor] = None,
                     big_tris: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front + back orthographic canonical render of (T, 3, 3) triangles
    with per-vertex attributes (T, 3, A) and the (4, 4) matrices of
    camera.cano_front_back_mvp. ``shading``: 'attribute' (raw attributes,
    background 0) or 'phong' (attr_tris are normals; background 1).
    Returns (front (res, res, A), back (res, res, A))."""
    def one_pass(mvp, mv):
        if shading == "phong":
            return _phong_pass(tris, attr_tris, valid, mvp, mv, res, res,
                               window, color_tris, big_tris, True).attrs
        return rasterize(transform_tris(tris, mvp), attr_tris, valid, res,
                         res, window=window, big_tri_capacity=big_tris).attrs

    return one_pass(front_mvp, front_mv), one_pass(back_mvp, back_mv).flip(1)


def render_mesh_single(tris: torch.Tensor, attr_tris: torch.Tensor,
                       valid: torch.Tensor, mvp: torch.Tensor,
                       mv: torch.Tensor, height: int, width: int,
                       window: int = 4, shading: str = "attribute",
                       color_tris: Optional[torch.Tensor] = None,
                       big_tris: int = 0) -> RasterOutput:
    """One perspective or orthographic pass: the raw attributes
    ('attribute') or a Phong image of the normals in ``attr_tris``
    ('phong', background 1; the normals are not normalised per vertex,
    as in the JAX package)."""
    if shading == "phong":
        return _phong_pass(tris, attr_tris, valid, mvp, mv, height, width,
                           window, color_tris, big_tris, False)
    return rasterize(transform_tris(tris, mvp), attr_tris, valid, height,
                     width, window=window, big_tri_capacity=big_tris)


def render_live_mesh(tris, normal_tris, valid, front_mv, back_mv, proj,
                     real2gl, res: int = 512, window: int = 4,
                     color_tris=None, big_tris: int = 0):
    """Perspective front/back Phong preview (the reference's
    utils/visualize_util.py:90-126); the matrices may be numpy or tensors.
    Returns (front (res, res, 3), back (res, res, 3))."""
    def mat(m):
        return torch.as_tensor(m, dtype=tris.dtype, device=tris.device)

    pj, gl = mat(proj), mat(real2gl)
    images = []
    for mv in (front_mv, back_mv):
        m = gl @ mat(mv)
        images.append(render_mesh_single(tris, normal_tris, valid, pj @ m, m,
                                         res, res, window, "phong",
                                         color_tris, big_tris).attrs)
    return images[0], images[1]


def normal2color(normal_img: torch.Tensor) -> torch.Tensor:
    """Unit normals to display colors: 0.5 n + 0.5 where the normal is not
    zero, the input elsewhere."""
    mask = normal_img.norm(dim=-1) > 1e-6
    return torch.where(mask[..., None], 0.5 * _unit(normal_img) + 0.5,
                       normal_img)
