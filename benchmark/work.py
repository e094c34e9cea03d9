"""The yardstick's work counts and peaks, frozen in the benchmark.

Copied at commit 2621afd from:

- avatarcap_tpu_torch/ops/fused_query.py: the (out, in) layer shapes of
  K1's offset decoder and template, of K2's decoder, and the MACs per
  point they give (OFFSET_SHAPES, TEMPLATE_SHAPES, RECON_SHAPES,
  MACS_PER_POINT, RECON_MACS_PER_POINT);
- avatarcap_tpu_torch/tools/bench_kernels.py: the published peaks and
  ``launch_bound`` (the bytes per point of each kernel as that tool counts
  them);
- avatarcap_tpu_torch/tools/bench_train.py: ``step_macs``.

Here the shapes are computed from a configuration's widths, so a count
does not depend on what implements the work.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _pe_dim(freqs: int) -> int:
    return 3 + 6 * freqs


def offset_shapes(w: dict):
    """(out, in) of the OffsetDecoder's 7 layers and the 3-d head: 4 x
    width, the input concatenated back before layer 5."""
    d_in = _pe_dim(w["warp_pos_encoding"]) + w["pose_feat_dim"]
    h = w["offset_width"]
    return ((h, d_in), (h, h), (h, h), (h, h), (h, h + d_in), (h, h),
            (h, h), (3, h))


def template_shapes(w: dict):
    """(out, in) of the template's shared MLP (6 x width, PE concatenated
    before layer 5, then the 256 feature layer), its geometry head
    (width 128 -> 2) and its color head (256, 128 -> 3)."""
    pe = _pe_dim(w["template_pos_encoding"])
    h = w["template_width"]
    return ((h, pe), (h, h), (h, h), (h, h), (h, h + pe), (h, h), (h, h),
            (128, h), (2, 128), (256, h), (128, 256), (3, 128))


def recon_shapes(w: dict):
    """(out, in) of ReconNet's decoder: recon_in_dim -> each of
    recon_widths -> 1, the input concatenated back ([h, x]) before each
    layer whose index is in recon_res_layers (AvatarCap's: 33 -> 512,
    [h, x] -> 256, [h, x] -> 128, 128 -> 1)."""
    d, res = w["recon_in_dim"], set(w["recon_res_layers"])
    shapes, prev = [], d
    for i, out in enumerate(list(w["recon_widths"]) + [1]):
        shapes.append((out, prev + (d if i in res else 0)))
        prev = out
    return tuple(shapes)


def macs(shapes: Sequence) -> int:
    return sum(o * i for o, i in shapes)


def weight_bytes(shapes: Sequence) -> int:
    """bf16 weights and f32 biases, read once per launch."""
    return sum(o * i * 2 + o * 4 for o, i in shapes)


def k1_macs_per_point(w: dict) -> int:
    return macs(offset_shapes(w)) + macs(template_shapes(w))


def k2_macs_per_point(w: dict) -> int:
    return macs(recon_shapes(w))


def k2_bytes_per_point(w: dict) -> int:
    """K2's float32 input row (the pixel-aligned feature and z) in and its
    occupancy out."""
    return 4 * (w["recon_in_dim"] + 1)


def launch_bound_s(n: float, macs_per_point: int, bytes_per_point: float,
                   weight_bytes_: int) -> float:
    """The least time the card could take for n points: the larger of the
    bf16 operations over the peak rate and the bytes (each input read
    once, each output written once, the weights once) over the memory
    rate."""
    t_ops = 2.0 * macs_per_point * n / PEAK_BF16_FLOPS
    t_bytes = (n * bytes_per_point + weight_bytes_) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes)


def k1_bound_s(w: dict, n: float) -> float:
    """K1 on n points: f32 points in, bf16 pose features in, f32 occ,
    alpha, rgb and offset out (bench_kernels' 3*4 + 64*2 + 8*4 bytes)."""
    return launch_bound_s(n, k1_macs_per_point(w),
                          3 * 4 + w["pose_feat_dim"] * 2 + 8 * 4,
                          weight_bytes(offset_shapes(w))
                          + weight_bytes(template_shapes(w)))


def k3_bound_s(w: dict, rays: float, n_samples: int, n_anchors: int) -> float:
    """K3 on ``rays`` rays of n_samples samples: each sample is one K1
    query; a ray reads its origin, direction, anchors and two bf16
    feature rows and writes its color."""
    per_ray = (3 + 3 + n_anchors + 3) * 4 + 2 * w["pose_feat_dim"] * 2
    return launch_bound_s(rays * n_samples, k1_macs_per_point(w),
                          per_ray / n_samples,
                          weight_bytes(offset_shapes(w))
                          + weight_bytes(template_shapes(w)))


def conv_macs(module: torch.nn.Module, run) -> int:
    """Multiply-adds of every Conv1d/2d and ConvTranspose2d of ``module``
    while ``run()`` drives it (bench_train.step_macs's hook: output
    elements x the products behind each)."""
    total = 0

    def count(mod, _inp, out):
        nonlocal total
        w = mod.weight
        per_out = w[0].numel()
        if isinstance(mod, torch.nn.ConvTranspose2d):
            per_out = w.shape[0] * w.shape[2] * w.shape[3] // (
                mod.stride[0] * mod.stride[1])
        total += out.numel() * per_out // max(1, mod.groups)
    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d,
                               torch.nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return total


def train_step_macs(w: dict, train: dict, unet_macs: int,
                    n_body_vertices: int) -> Dict[str, int]:
    """Multiply-adds of one train step, forward and backward (x 3): the
    per-point MLPs (offset decoder and head, all template heads, at every
    ray sample and geometry point), the U-Net's convolutions at the
    batch's map size (``unet_macs``, forward), and the inverse-skinning
    KNN's distance products (bench_train.step_macs)."""
    point_macs = k1_macs_per_point(w)
    B, R, S = train["batch_size"], train["n_rays"], train["n_samples"]
    n_pts = B * (R * S + train["n_surf"] + train["n_vol"])
    knn = B * R * S * n_body_vertices * 3
    return {"points": n_pts, "point_macs": point_macs, "unet_macs": unet_macs,
            "knn_macs": knn,
            "step_macs": 3 * (point_macs * n_pts + unet_macs) + knn}
