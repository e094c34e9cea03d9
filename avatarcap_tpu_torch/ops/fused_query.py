"""Fused point and ray queries: kernels K1-K5 of the port.

Each wrapper replaces one Pallas kernel of avatarcap_tpu/ops/pallas_query.py
and launches a hand-written Hopper kernel on a CUDA tensor (or raises); on
a CPU tensor it runs its plain version, the same arithmetic in plain
PyTorch. Nothing falls back from the card to the plain version.

  K1 ``warp_template_query``  :warp_template_query_fused (pallas_call
     :341, body _warp_template_core :255-296), csrc/warp_template_query.cu
  K2 ``recon_decode``         :recon_decode_fused (:239, _recon_kernel
     :188-200), csrc/recon_decode.cu; PIFu's decoder through the same
     wrapper on K2w, csrc/recon_decode_wide.cu (no Pallas counterpart)
  K3 ``ray_color_query``      :ray_color_query_fused (:496,
     _ray_color_kernel :362-440), csrc/ray_color_query.cu
  K4 ``template_query``       :template_query_fused (:533,
     _template_kernel :53-81), csrc/template_offset_query.cu
  K5 ``offset_query``         :offset_query_fused (:172, _offset_kernel
     :115-129), csrc/template_offset_query.cu
K1, K3, K4 and K5 share one device implementation of the 20-layer chain
(csrc/warp_template_core.cuh), and their plain versions share
``_offset_plain`` and ``_template_plain``.

What bounds all five on an H100: operations. K1 does ~1.97 MFLOP per point
against ~172 B of input and output per point (3 f32 + 64 bf16 in, 8 f32
out); K2 387,072 FLOP against 136 B (33 f32 in, 1 f32 out); K3 ~1.97 MFLOP
per sample against (6 + A) f32 + 128 bf16 in and 3 f32 out per ray. Each
kernel keeps a 128-point (or 128-ray) tile's activations on chip across all
its layers and runs every product on bf16 tensor cores with f32
accumulators. All five run on ``wgmma`` and take their weights as one image
of 16-k chunks in the order and operand layout the kernel consumes, built
once per packed set (``weight_image``: ~2 MB for K1, K3, K4 and K5;
``recon_weight_image``: 414 KB for K2), that a producer warpgroup streams
through a ring in shared memory (csrc/chunk_ring.cuh; see the sources'
headers).

The contract of K1's two versions (the TPU kernel's rounding points):
points rounded to bf16 only for the decoder input; the PE built from the
f32 warped points; bf16 operands and f32 accumulation in every product;
every activation rounded to bf16 after its nonlinearity; softplus =
logaddexp(x, 0) in f32 (the kernels evaluate it from the hardware's exp2
approximation and a polynomial, within 2^-19 of the accurate value, before
the bf16 rounding); eval BatchNorm folded into the packed weights.
K4 builds the PE from its f32 input points, K5 rounds all 67 inputs to
bf16. K3 runs K1's chain per sample on bf16(f32 lerp of the bf16 end
features) and folds the samples in order (no cumprod), every scalar step
one f32 operation. K2's: all 33 inputs rounded to bf16 (z included); bf16
operands and f32 accumulation in every product, the f32 bias added after;
every leaky ReLU (0.02) output rounded to bf16; skip concats [h, x] with
the bf16 input; the 128 -> 1 output not rounded before the f32 sigmoid;
weight norm folded into the packed weights. K2w's (PIFu's shape network,
257 -> 1024 -> 512 -> 256 -> 128 -> 1 with [h, x] before every layer after
the first): the same, with leaky ReLU (0.01) and no weight norm; the
kernel sums z's products apart from the 256 features' (bf16 operands
both, f32 accumulation: only the order of the f32 sums differs).
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avatarcap_tpu_torch import kernels
from avatarcap_tpu_torch.ops.embed import positional_encoding
from avatarcap_tpu_torch.utils.timers import count, span

NUM_FREQS = 10
POSE_FEAT_DIM = 64
# (out, in) of every packed layer: 8 offset-decoder layers, 12 template
OFFSET_SHAPES = ((256, 67), (256, 256), (256, 256), (256, 256),
                 (256, 323), (256, 256), (256, 256), (3, 256))
TEMPLATE_SHAPES = ((256, 63), (256, 256), (256, 256), (256, 256),
                   (256, 319), (256, 256), (256, 256), (128, 256), (2, 128),
                   (256, 256), (128, 256), (3, 128))
# multiply-adds per point, from the shapes above: K1 985,472 (~1.97
# MFLOP), and per ray sample of K3; K4 557,184; K5 428,288
OFFSET_MACS_PER_POINT = sum(o * i for o, i in OFFSET_SHAPES)
TEMPLATE_MACS_PER_POINT = sum(o * i for o, i in TEMPLATE_SHAPES)
MACS_PER_POINT = OFFSET_MACS_PER_POINT + TEMPLATE_MACS_PER_POINT
OFFSET_IN_DIM = 3 + POSE_FEAT_DIM
# K3's anchor distances per ray: 2 <= A <= MAX_ANCHORS (the kernel keeps
# them in shared memory)
MAX_ANCHORS = 16
# (out, in) of K2's packed layers: 33 -> 512, [h, x] 545 -> 256,
# [h, x] 289 -> 128, 128 -> 1
RECON_IN_DIM = 33
RECON_SHAPES = ((512, 33), (256, 545), (128, 289), (1, 128))
RECON_MACS_PER_POINT = sum(o * i for o, i in RECON_SHAPES)     # 193,536
# K2w: PIFu's shape network (scripts/test.sh: --mlp_dim 257 1024 512 256
# 128 1, the input concatenated again before every layer after the first)
RECON_WIDE_IN_DIM = 257
RECON_WIDE_SHAPES = ((1024, 257), (512, 1281), (256, 769), (128, 513),
                     (1, 385))
RECON_WIDE_MACS_PER_POINT = sum(o * i for o, i in RECON_WIDE_SHAPES)
# the decoders a kernel runs, by their packed shapes: the kernel's span, the
# layers that take the input again and the leaky slope that the kernel has
# built in
RECON_FORMS = {RECON_SHAPES: ("k2", (1, 2), 0.02),
               RECON_WIDE_SHAPES: ("k2w", (1, 2, 3, 4), 0.01)}


def _recon_shapes(packed: Sequence[torch.Tensor]) -> tuple:
    return tuple(tuple(w.shape) for w in packed[0::2])


def _pack_layer(weight_oi: torch.Tensor, bias: torch.Tensor):
    return (weight_oi.detach().to(torch.bfloat16).contiguous(),
            bias.detach().to(torch.float32).contiguous())


def pack_offset_weights(warping_field, eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, ...]:
    """WarpingField OffsetDecoder + out head -> (v1, c1, ..., v7, c7, ow, ob):
    (O, I) bf16 weights with eval BatchNorm folded in, (O,) f32 biases."""
    mlp = warping_field.mlp
    packed = []
    for i in range(1, 8):
        conv = getattr(mlp, f"conv{i}")
        bn = getattr(mlp, f"bn{i}")
        k = conv.weight[:, :, 0].float()
        a = bn.weight.float() / torch.sqrt(bn.running_var.float() + eps)
        packed += _pack_layer(k * a[:, None],
                              (conv.bias.float() - bn.running_mean.float())
                              * a + bn.bias.float())
    out = warping_field.out_layer_coord_affine
    packed += _pack_layer(out.weight[:, :, 0], out.bias)
    return tuple(packed)


def pack_template_weights(cano_template) -> Tuple[torch.Tensor, ...]:
    """DoubleTNet -> (w0, b0, ..., w6, b6, gw0, gb0, gw1, gb1, cw0, cb0,
    cw1, cb1, cw2, cb2): (O, I) bf16 weights, (O,) f32 biases."""
    sp = cano_template.shared_mlp.fc_list
    gp = cano_template.geo_mlp.fc_list
    cp = cano_template.clr_mlp.fc_list
    layers = [sp[i][0] for i in range(6)] + [sp[6], gp[0][0], gp[1],
                                             cp[0][0], cp[1][0], cp[2]]
    packed = []
    for conv in layers:
        packed += _pack_layer(conv.weight[:, :, 0], conv.bias)
    return tuple(packed)


def pack_recon_weights(image_decoder) -> Tuple[torch.Tensor, ...]:
    """ReconNet ``image_decoder`` (models/mlp.MLP, any number of hidden
    layers) -> (w0, b0, ..., wL, bL): (O, I) bf16 weights, with
    w = g v / |v| folded in f32 where a layer is weight-normed, (O,) f32
    biases. A decoder of a kernel's shapes (RECON_FORMS) must have that
    kernel's skips and leaky slope (ValueError)."""
    fc = image_decoder.fc_list
    packed = []
    for block in fc[:-1]:
        conv = block[0]
        w = (conv.folded_weight() if hasattr(conv, "folded_weight")
             else conv.weight[:, :, 0])
        packed += _pack_layer(w, conv.bias)
    packed += _pack_layer(fc[-1].weight[:, :, 0], fc[-1].bias)
    form = RECON_FORMS.get(_recon_shapes(packed))
    if form is not None:
        slope = getattr(fc[0][1], "negative_slope", None)
        if (tuple(image_decoder.res_layers), slope) != form[1:]:
            raise ValueError(
                f"a decoder of these shapes runs on a kernel with skips "
                f"{form[1]} and leaky slope {form[2]}; this one has "
                f"{tuple(image_decoder.res_layers)} and {slope}")
    return tuple(packed)


# The weight image of K1, K3, K4 and K5 (csrc/warp_template_core.cuh states
# the same numbers). Wide layers (O = 256 or 128) are zero-padded in K to the
# column blocks of their inputs (x 80, pe 64, hidden 256) and cut into chunks
# of CHUNK_K columns;
# (seg0, pad0, k_pad) per layer: padded columns [0, seg0) are weight columns
# [0, seg0), [seg0, pad0) are zero, and [pad0, k_pad) continue from weight
# column seg0 (zero past the last one).
CHUNK_K = 16
_OFFSET_PADS = {0: (67, 80, 80), 4: (67, 80, 336)}
_TEMPLATE_PADS = {0: (63, 64, 64), 4: (319, 320, 320)}
_BIAS_ALIGN = 4                    # floats: every layer's bias starts aligned


def _image_plan(shapes, pads):
    """[(layer, O, I, seg0, pad0, k_pad)] of a half's wide layers and
    [(layer, O, I)] of its heads, in chain order."""
    wide, heads = [], []
    for layer, (o, i) in enumerate(shapes):
        if o >= 128:
            wide.append((layer, o, i) + pads.get(layer, (i, i, i)))
        else:
            heads.append((layer, o, i))
    return wide, heads


_PLANS = {"offset": _image_plan(OFFSET_SHAPES, _OFFSET_PADS),
          "template": _image_plan(TEMPLATE_SHAPES, _TEMPLATE_PADS)}


def _half_sizes(half: str):
    """(chunks, image elements, bias floats) of one half of the image."""
    wide, heads = _PLANS[half]
    shapes = OFFSET_SHAPES if half == "offset" else TEMPLATE_SHAPES
    chunks = sum(k_pad // CHUNK_K for *_, k_pad in wide)
    elems = (sum(o * k_pad for _, o, _, _, _, k_pad in wide)
             + sum(o * i for _, o, i in heads))
    bias = sum(-(-o // _BIAS_ALIGN) * _BIAS_ALIGN for o, _ in shapes)
    return chunks, elems, bias


OFFSET_CHUNKS, OFFSET_IMAGE_ELEMS, OFFSET_BIAS_FLOATS = _half_sizes("offset")
TEMPLATE_CHUNKS, TEMPLATE_IMAGE_ELEMS, TEMPLATE_BIAS_FLOATS = _half_sizes(
    "template")


def _padded_columns(i: int, seg0: int, pad0: int, k_pad: int, device):
    """Weight column of each padded column, -1 for a zero pad."""
    kp = torch.arange(k_pad, device=device)
    col = torch.where(kp < pad0, kp, kp - pad0 + seg0)
    zero = ((kp >= seg0) & (kp < pad0)) | (col >= i)
    return torch.where(zero, torch.full_like(col, -1), col)


def _pad_weight(w: torch.Tensor, seg0: int, pad0: int, k_pad: int
                ) -> torch.Tensor:
    """(O, I) weights -> (O, k_pad // CHUNK_K, 2, 8): zero-padded in K,
    each chunk of CHUNK_K columns as two groups of 8."""
    col = _padded_columns(w.shape[1], seg0, pad0, k_pad, w.device)
    w_pad = torch.where(col >= 0, w[:, col.clamp_min(0)],
                        torch.zeros((), dtype=w.dtype, device=w.device))
    return w_pad.reshape(w.shape[0], k_pad // CHUNK_K, 2, 8)


def _unpad_weight(w_pad: torch.Tensor, i: int, seg0: int, pad0: int
                  ) -> torch.Tensor:
    """The inverse of _pad_weight: (O, k_pad // CHUNK_K, 2, 8) -> (O, i)."""
    o, k_pad = w_pad.shape[0], w_pad[0].numel()
    w_pad = w_pad.reshape(o, k_pad)
    col = _padded_columns(i, seg0, pad0, k_pad, w_pad.device)
    w = w_pad.new_zeros((o, i))
    w[:, col[col >= 0]] = w_pad[:, col >= 0]
    return w


def _padded_biases(packed: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every layer's f32 bias in packed order, each padded to 4 floats."""
    return _padded_vectors(packed[1::2])


def _padded_vectors(vectors: Sequence[torch.Tensor]) -> torch.Tensor:
    out = []
    for b in vectors:
        out += [b, b.new_zeros((-b.numel()) % _BIAS_ALIGN)]
    return torch.cat(out)


def _half_image(packed: Sequence[torch.Tensor], half: str):
    wide, heads = _PLANS[half]
    # each chunk as wgmma reads an unswizzled K-major operand: core
    # matrices of 8 rows x 8 columns, stored [c][k / 8][n][k % 8]
    parts = [_pad_weight(packed[2 * layer], seg0, pad0, k_pad)
             .permute(1, 2, 0, 3).reshape(-1)
             for layer, _, _, seg0, pad0, k_pad in wide]
    parts += [packed[2 * layer].reshape(-1) for layer, _, _ in heads]
    return torch.cat(parts), _padded_biases(packed)


def weight_image(packed_offset: Optional[Sequence[torch.Tensor]] = None,
                 packed_template: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed weights as the one buffer the kernels stream (plain
    PyTorch, any device): (image, bias), 1-D bf16 and f32.

    Each half given (offset first) holds its wide layers as chunks of
    CHUNK_K zero-padded input columns, in the order the chain runs them
    (offset layers 0-6: 106 chunks; template 0-7, 9, 10: 152 chunks; 8 KB
    a chunk at O = 256, 4 KB at O = 128), each chunk as [k / 8][n][k % 8]
    (wgmma's unswizzled K-major core matrices), then its heads' (O, I)
    weights as they are; ``bias`` holds every layer's f32 bias in packed
    order, each padded to 4 floats. K1 and K3 take both halves, K4 the
    template half, K5 the offset half.
    """
    halves = [_half_image(p, h) for p, h in ((packed_offset, "offset"),
                                             (packed_template, "template"))
              if p is not None]
    if not halves:
        raise ValueError("weight_image needs at least one packed half")
    return (torch.cat([h[0] for h in halves]),
            torch.cat([h[1] for h in halves]))


def unpack_weight_image(image: torch.Tensor, half: str
                        ) -> List[torch.Tensor]:
    """The (O, I) weights of one half's layers, in packed order, read back
    from that half of an image (the inverse of ``weight_image``; a joint
    image's template half starts at OFFSET_IMAGE_ELEMS)."""
    wide, heads = _PLANS[half]
    out, pos = {}, 0
    for layer, o, i, seg0, pad0, k_pad in wide:
        w_pad = (image[pos:pos + o * k_pad]
                 .reshape(k_pad // CHUNK_K, 2, o, 8).permute(2, 0, 1, 3))
        pos += o * k_pad
        out[layer] = _unpad_weight(w_pad, i, seg0, pad0)
    for layer, o, i in heads:
        out[layer] = image[pos:pos + o * i].reshape(o, i)
        pos += o * i
    return [out[layer] for layer in sorted(out)]


# The weight image of K2 (csrc/recon_decode.cu states the same numbers).
# Each wide layer's (O, I) weights are zero-padded in K to the kernel's
# input segments: x (33 columns) padded to RECON_X_COLS, and the [h, x]
# concats as h (512 or 256) then x padded the same way; (seg0, pad0, k_pad)
# as in _padded_columns.
RECON_X_COLS = 48
_RECON_PADS = ((33, 48, 48), (512, 512, 560), (256, 256, 304))


def _recon_stream():
    """[(layer, first output row, rows, k-chunk)] of K2's chunks in the
    order the kernel takes them: for each of layer 0's four slices of 128
    output columns its 3 chunks, then layer 1's 8 chunks over that slice of
    h1; then layer 1's x segment (3 chunks) and layer 2 (19 chunks at
    O = 128: h2, then x)."""
    stream = []
    for j in range(4):
        stream += [(0, 128 * j, 128, c) for c in range(3)]
        stream += [(1, 0, 256, 8 * j + c) for c in range(8)]
    stream += [(1, 0, 256, c) for c in range(32, 35)]
    stream += [(2, 0, 128, c) for c in range(304 // CHUNK_K)]
    return stream


RECON_CHUNKS = len(_recon_stream())                              # 66
RECON_HEAD_ELEM = sum(o * k_pad for (o, _), (_, _, k_pad)
                      in zip(RECON_SHAPES, _RECON_PADS))         # 206,848
RECON_IMAGE_ELEMS = RECON_HEAD_ELEM + RECON_SHAPES[3][1]
RECON_BIAS_FLOATS = sum(-(-o // _BIAS_ALIGN) * _BIAS_ALIGN
                        for o, _ in RECON_SHAPES)                # 900


def recon_weight_image(packed: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's packed weights (pack_recon_weights) as the one buffer its
    kernel streams (plain PyTorch, any device): (image, bias), 1-D bf16
    and f32.

    The image holds the RECON_CHUNKS chunks of _recon_stream in order, each
    an (O rows x 16 k) block of a layer's zero-padded weights as
    [k / 8][n][k % 8] (wgmma's unswizzled K-major core matrices), then the
    (1, 128) head as it is; ``bias`` holds the four f32 biases in packed
    order, each padded to 4 floats.
    """
    pads = [_pad_weight(w, *pad) for w, pad in zip(packed[0:6:2],
                                                      _RECON_PADS)]
    parts = [pads[layer][r0:r0 + o, c].permute(1, 0, 2).reshape(-1)
             for layer, r0, o, c in _recon_stream()]
    parts.append(packed[6].reshape(-1))
    return torch.cat(parts), _padded_biases(packed)


def unpack_recon_weight_image(image: torch.Tensor) -> List[torch.Tensor]:
    """The four (O, I) weights read back from K2's image (the inverse of
    ``recon_weight_image``)."""
    pads = [image.new_zeros((o, k_pad // CHUNK_K, 2, 8))
            for (o, _), (_, _, k_pad) in zip(RECON_SHAPES, _RECON_PADS)]
    pos = 0
    for layer, r0, o, c in _recon_stream():
        pads[layer][r0:r0 + o, c] = (image[pos:pos + o * CHUNK_K]
                                     .reshape(2, o, 8).permute(1, 0, 2))
        pos += o * CHUNK_K
    out = [_unpad_weight(w_pad, i, seg0, pad0) for w_pad, (_, i), (seg0, pad0, _)
           in zip(pads, RECON_SHAPES, _RECON_PADS)]
    o, i = RECON_SHAPES[3]
    out.append(image[pos:pos + o * i].reshape(o, i))
    return out


# The weight image of K2w (csrc/recon_decode_wide.cu states the same
# numbers). Each layer's input splits into h (the previous layer's output,
# none for layer 0), the 256 pixel-aligned features and z: the h and
# feature columns are cut into chunks of CHUNK_K columns of some rows, each
# as [k / 8][n][k % 8]; z's column goes to the f32 vectors, beside the
# biases. Regions, in this order: layer 0 (eight slices of 128 rows, 16
# chunks each), layer 1's h columns (two halves of 256 rows, then eight
# slices of 128 columns, 8 chunks each), layer 1's feature columns (per
# half, 16 chunks), layer 2 (h columns 256-511, h columns 0-255, features:
# 48 chunks at O = 256), layer 3 (h, features: 32 chunks at O = 128), then
# the (1, 384) head [h, features] row-major.
RECON_WIDE_X_COLS = 256


def _recon_wide_stream():
    """[(layer, first output row, rows, first input column)] of K2w's
    chunks in image order (the kernel reads layer 0's region twice, once
    per half of layer 1's rows)."""
    x0 = (0, 1024, 512, 256)           # each layer's first feature column
    steps = RECON_WIDE_X_COLS // CHUNK_K
    stream = [(0, 128 * j, 128, 16 * c) for j in range(8)
              for c in range(steps)]
    stream += [(1, 256 * hh, 256, 128 * j + 16 * c) for hh in range(2)
               for j in range(8) for c in range(8)]
    stream += [(1, 256 * hh, 256, x0[1] + 16 * c) for hh in range(2)
               for c in range(steps)]
    stream += [(2, 0, 256, 16 * c) for c in list(range(16, 32))
               + list(range(16)) + list(range(x0[2] // 16,
                                               x0[2] // 16 + steps))]
    stream += [(3, 0, 128, 16 * c) for c in list(range(16))
               + list(range(x0[3] // 16, x0[3] // 16 + steps))]
    return stream


RECON_WIDE_HEAD_ELEM = sum(o * CHUNK_K for _, _, o, _ in
                           _recon_wide_stream())                 # 1,179,648
RECON_WIDE_IMAGE_ELEMS = RECON_WIDE_HEAD_ELEM + 128 + RECON_WIDE_X_COLS
# the f32 biases, each padded to 4 floats, then z's weights the same way
RECON_WIDE_BIAS_FLOATS = sum(-(-o // _BIAS_ALIGN) * _BIAS_ALIGN
                             for o, _ in RECON_WIDE_SHAPES)      # 1,924


def recon_wide_weight_image(packed: Sequence[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2w's packed weights (pack_recon_weights of PIFu's decoder) as the
    buffers its kernel reads (plain PyTorch, any device): (image, vecs),
    1-D bf16 and f32. ``image`` holds the chunks of _recon_wide_stream in
    order, then the head's h and feature weights; ``vecs`` the five f32
    biases, each padded to 4 floats, then each layer's weights of z (its
    last input column) as f32, padded the same way."""
    w = packed[0::2]
    parts = [w[layer][r0:r0 + o, c0:c0 + CHUNK_K].reshape(o, 2, 8)
             .permute(1, 0, 2).reshape(-1)
             for layer, r0, o, c0 in _recon_wide_stream()]
    parts.append(w[4][0, :-1])
    return (torch.cat(parts), torch.cat([
        _padded_biases(packed), _padded_vectors([t[:, -1].float()
                                                 for t in w])]))


def unpack_recon_wide_weight_image(image: torch.Tensor, vecs: torch.Tensor
                                   ) -> List[torch.Tensor]:
    """The five (O, I) weights read back from K2w's image and vectors (the
    inverse of ``recon_wide_weight_image``; z's weights are exact in
    f32)."""
    out = [image.new_zeros(s) for s in RECON_WIDE_SHAPES]
    pos = 0
    for layer, r0, o, c0 in _recon_wide_stream():
        out[layer][r0:r0 + o, c0:c0 + CHUNK_K] = (
            image[pos:pos + o * CHUNK_K].reshape(2, o, 8).permute(1, 0, 2)
            .reshape(o, CHUNK_K))
        pos += o * CHUNK_K
    out[4][0, :-1] = image[pos:]
    z0 = RECON_WIDE_BIAS_FLOATS
    for t in out:
        o = t.shape[0]
        t[:, -1] = vecs[z0:z0 + o].to(t.dtype)
        z0 += -(-o // _BIAS_ALIGN) * _BIAS_ALIGN
    return out


# images of the packed sets seen lately: the key names each packed tensor's
# storage and version, and the entry keeps the tensors alive, so a key
# cannot come to name other weights
_IMAGES: "OrderedDict[tuple, tuple]" = OrderedDict()
_MAX_IMAGES = 32


def _tensor_version(t: torch.Tensor) -> int:
    try:
        return t._version
    except RuntimeError:            # inference tensors track no version
        return -1


def _cached_image(build, kind, tensors: tuple, *args):
    """``build(*args)`` for the packed tensors, built once per set and
    kind; ``build.builds`` counts the builds."""
    key = (kind,) + tuple((t.data_ptr(), _tensor_version(t))
                          for t in tensors)
    hit = _IMAGES.get(key)
    if hit is None:
        with torch.no_grad():
            hit = build(*args) + (tensors,)
        _IMAGES[key] = hit
        while len(_IMAGES) > _MAX_IMAGES:
            _IMAGES.popitem(last=False)
        build.builds += 1
    else:
        _IMAGES.move_to_end(key)
    return hit[0], hit[1]


def _cached_weight_image(packed_offset, packed_template):
    """``weight_image`` of the packed set(s), built once per set."""
    return _cached_image(
        weight_image, ("chain", packed_offset is None,
                       packed_template is None),
        tuple(packed_offset or ()) + tuple(packed_template or ()),
        packed_offset, packed_template)


def _cached_recon_image(packed):
    """``recon_weight_image`` of a packed set, built once per set."""
    return _cached_image(recon_weight_image, "recon", tuple(packed), packed)


def _cached_recon_wide_image(packed):
    """``recon_wide_weight_image`` of a packed set, built once per set."""
    return _cached_image(recon_wide_weight_image, "recon_wide",
                         tuple(packed), packed)


weight_image.builds = 0
recon_weight_image.builds = 0
recon_wide_weight_image.builds = 0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _leaky(x: torch.Tensor, slope: float = 0.02) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _dot(w: torch.Tensor, h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-valued operands, f32 products and accumulation, f32 bias."""
    return h.float() @ w.float().T + b


def _offset_plain(v: Sequence[torch.Tensor], x: torch.Tensor
                  ) -> torch.Tensor:
    """OffsetDecoder + head on bf16 inputs x (N, 67) -> (N, 3) f32."""
    h = x
    for i in range(4):
        h = _softplus(_dot(v[2 * i], h, v[2 * i + 1])).to(torch.bfloat16)
    h = torch.cat([x, h], dim=-1)                                # (N, 323)
    for i in range(4, 7):
        h = _softplus(_dot(v[2 * i], h, v[2 * i + 1])).to(torch.bfloat16)
    return _dot(v[14], h, v[15])


def _template_plain(w: Sequence[torch.Tensor], pts: torch.Tensor):
    """DoubleTNet on f32 points (N, 3) -> (geo (N, 2), rgb (N, 3)), f32."""
    bf = torch.bfloat16
    pe = positional_encoding(pts, NUM_FREQS).to(bf)              # (N, 63)
    h = pe
    for i in range(4):
        h = torch.relu(_dot(w[2 * i], h, w[2 * i + 1])).to(bf)
    h = torch.cat([h, pe], dim=-1)                               # (N, 319)
    for i in range(4, 6):
        h = torch.relu(_dot(w[2 * i], h, w[2 * i + 1])).to(bf)
    feat = _dot(w[12], h, w[13]).to(bf)

    g = _leaky(_dot(w[14], feat, w[15])).to(bf)
    geo = _dot(w[16], g, w[17])                                  # (N, 2)
    c = torch.relu(_dot(w[18], feat, w[19])).to(bf)
    c = torch.relu(_dot(w[20], c, w[21])).to(bf)
    return geo, torch.sigmoid(_dot(w[22], c, w[23]))


def warp_template_query_plain(packed_offset: Sequence[torch.Tensor],
                              packed_template: Sequence[torch.Tensor],
                              pts: torch.Tensor, pose_feat: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel (same arithmetic, any device).

    Args:
      pts: (N, 3) canonical points; pose_feat: (N, 64) pose features.
    Returns:
      dict(occ (N, 1), alpha (N, 1), rgb (N, 3), offset (N, 3)), f32.
    """
    bf = torch.bfloat16
    pts = pts.float()
    off = _offset_plain(packed_offset,
                        torch.cat([pts.to(bf), pose_feat.to(bf)], dim=-1))
    geo, rgb = _template_plain(packed_template, pts + off)
    return {"occ": geo[:, 0:1], "alpha": torch.relu(geo[:, 1:2]),
            "rgb": rgb, "offset": off}


def template_query_plain(packed_template: Sequence[torch.Tensor],
                         pts: torch.Tensor):
    """Plain PyTorch version of K4 (same arithmetic, any device).

    Args:
      pts: (N, 3) canonical points (the PE is built from them in f32).
    Returns:
      (rgb (N, 3), alpha (N, 1), occ (N, 1)), f32.
    """
    geo, rgb = _template_plain(packed_template, pts.float())
    return rgb, torch.relu(geo[:, 1:2]), geo[:, 0:1]


def offset_query_plain(packed_offset: Sequence[torch.Tensor],
                       feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 (same arithmetic, any device).

    Args:
      feats: (N, 67) [pts (3), pose features (64)], all rounded to bf16.
    Returns:
      (N, 3) f32 offsets.
    """
    return _offset_plain(packed_offset, feats.float().to(torch.bfloat16))


def _f32(x) -> float:
    """x rounded to float32, as a Python float (exact in f32 arithmetic)."""
    return float(np.float32(x))


def ray_constants(n_samples: int, n_anchors: int, near: float, far: float):
    """K3's scalar constants as the TPU kernel's weak-typed f32 scalars:
    (near, gap = (far - near) / (S - 1), anchor step (A - 1) / (S - 1)),
    each a quotient of Python floats rounded once to f32."""
    return (_f32(near), _f32((far - near) / (n_samples - 1)),
            _f32((n_anchors - 1) / (n_samples - 1)))


def ray_color_query_plain(packed_offset: Sequence[torch.Tensor],
                          packed_template: Sequence[torch.Tensor],
                          ro: torch.Tensor, rd: torch.Tensor,
                          pf0: torch.Tensor, pf1: torch.Tensor,
                          danch: torch.Tensor, bounds: torch.Tensor,
                          n_samples: int, near: float, far: float,
                          threshold: float, chunk: int = 65536
                          ) -> torch.Tensor:
    """Plain PyTorch version of K3 (same arithmetic, any device), over
    chunks of ``chunk`` rays so that a full-size launch stays within a few
    GB. See ``ray_color_query`` for the arguments; returns (R, 3) f32."""
    near32, gap, step = ray_constants(n_samples, danch.shape[1], near, far)
    thr = _f32(threshold)
    bmin, bmax = bounds[0].float(), bounds[1].float()
    f32 = np.float32
    out = []
    for c0 in range(0, ro.shape[0], chunk):
        roc, rdc = ro[c0:c0 + chunk].float(), rd[c0:c0 + chunk].float()
        p0 = pf0[c0:c0 + chunk].to(torch.bfloat16).float()
        p1 = pf1[c0:c0 + chunk].to(torch.bfloat16).float()
        dc = danch[c0:c0 + chunk].float()
        trans = torch.ones_like(roc[:, 0])
        acc = torch.zeros_like(roc)
        for s in range(n_samples):
            sf = f32(s)
            z = float(f32(near32) + f32(gap) * sf)
            w1 = f32(sf / f32(n_samples - 1))
            pts = roc + rdc * z
            pf = (p0 * float(f32(1.0) - w1) + p1 * float(w1)).to(
                torch.bfloat16)
            q = warp_template_query_plain(packed_offset, packed_template,
                                          pts, pf)
            pos = sf * f32(step)
            seg = min(np.floor(pos), f32(danch.shape[1] - 2))
            f = f32(pos - seg)
            a0 = int(seg)
            d = dc[:, a0] * float(f32(1.0) - f) + dc[:, a0 + 1] * float(f)
            wpts = pts + q["offset"]
            keep = ((d < thr) & (wpts > bmin).all(-1)
                    & (wpts < bmax).all(-1))
            sigma = torch.where(keep, q["alpha"][:, 0],
                                torch.zeros_like(d))
            alpha = 1.0 - torch.exp(-(sigma * gap))
            acc = acc + (alpha * trans)[:, None] * q["rgb"]
            trans = trans * ((1.0 - alpha) + 1e-10)
        out.append(acc)
    if not out:
        return torch.zeros((0, 3), dtype=torch.float32, device=ro.device)
    return torch.cat(out)


def recon_decode_plain(packed: Sequence[torch.Tensor], feats: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arithmetic, any device).

    Args:
      feats: (N, 33) [pixel-aligned feature (32), z].
    Returns:
      (N,) f32 occupancy in [0, 1].
    """
    bf = torch.bfloat16
    w = packed
    x = feats.float().to(bf)
    h = _leaky(_dot(w[0], x, w[1])).to(bf)
    h = _leaky(_dot(w[2], torch.cat([h, x], dim=-1), w[3])).to(bf)
    h = _leaky(_dot(w[4], torch.cat([h, x], dim=-1), w[5])).to(bf)
    return torch.sigmoid(_dot(w[6], h, w[7]))[:, 0]


def recon_decode_wide_plain(packed: Sequence[torch.Tensor],
                            feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2w (same arithmetic, any device).

    Args:
      feats: (N, 257) [pixel-aligned feature (256), z].
    Returns:
      (N,) f32 occupancy in [0, 1].
    """
    w = packed
    x = feats.float().to(torch.bfloat16)
    h = _leaky(_dot(w[0], x, w[1]), 0.01).to(torch.bfloat16)
    for i in range(1, 4):
        h = _leaky(_dot(w[2 * i], torch.cat([h, x], dim=-1), w[2 * i + 1]),
                   0.01).to(torch.bfloat16)
    return torch.sigmoid(_dot(w[8], torch.cat([h, x], dim=-1), w[9]))[:, 0]


def _check_weights(packed: Sequence[torch.Tensor], shapes, device) -> None:
    if len(packed) != 2 * len(shapes):
        raise ValueError(f"expected {2 * len(shapes)} packed tensors, "
                         f"got {len(packed)}")
    for (o, i), w, b in zip(shapes, packed[0::2], packed[1::2]):
        if (w.dtype != torch.bfloat16 or tuple(w.shape) != (o, i)
                or not w.is_contiguous() or w.device != device):
            raise ValueError(f"packed weight must be contiguous bf16 "
                             f"({o}, {i}) on {device}, got {w.dtype} "
                             f"{tuple(w.shape)} on {w.device}")
        if (b.dtype != torch.float32 or tuple(b.shape) != (o,)
                or not b.is_contiguous() or b.device != device):
            raise ValueError(f"packed bias must be contiguous f32 ({o},) on "
                             f"{device}, got {b.dtype} {tuple(b.shape)} on "
                             f"{b.device}")


def _launch(packed_offset, packed_template, pts, pose_feat):
    dev = pts.device
    n = pts.shape[0]
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (N, 3), got {tuple(pts.shape)}")
    if tuple(pose_feat.shape) != (n, POSE_FEAT_DIM) or pose_feat.device != dev:
        raise ValueError(f"pose_feat must be ({n}, {POSE_FEAT_DIM}) on {dev}, "
                         f"got {tuple(pose_feat.shape)} on {pose_feat.device}")
    if n >= 2 ** 31:
        raise ValueError("too many points for one launch")
    _check_weights(packed_offset, OFFSET_SHAPES, dev)
    _check_weights(packed_template, TEMPLATE_SHAPES, dev)
    pts = pts.to(torch.float32).contiguous()
    pf = pose_feat.to(torch.bfloat16).contiguous()
    occ = torch.empty((n, 1), dtype=torch.float32, device=dev)
    alpha = torch.empty((n, 1), dtype=torch.float32, device=dev)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    off = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out = {"occ": occ, "alpha": alpha, "rgb": rgb, "offset": off}
    if n == 0:
        return out
    launch, err_str = kernels.c_functions(
        "warp_template_query", "wtq",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7)
    image, bias = _cached_weight_image(packed_offset, packed_template)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(pts.data_ptr(), pf.data_ptr(), n, image.data_ptr(),
                     bias.data_ptr(), occ.data_ptr(), alpha.data_ptr(),
                     rgb.data_ptr(), off.data_ptr(), stream)
    kernels.raise_on(err, err_str, "warp_template_query")
    warp_template_query.launches += 1
    return out


def warp_template_query(packed_offset: Sequence[torch.Tensor],
                        packed_template: Sequence[torch.Tensor],
                        pts: torch.Tensor, pose_feat: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """One-kernel warp + template query (inference).

    CUDA tensors launch the Hopper kernel (counted in
    ``warp_template_query.launches``); CPU tensors run the plain version.
    Under a tracer (utils/timers), either is a span ``k1`` counting its
    ``rows``.

    Args:
      pts: (N, 3) canonical points; pose_feat: (N, 64) pose features
        (rounded to bf16, as the TPU kernel's wrapper does).
    Returns:
      dict(occ (N, 1), alpha (N, 1), rgb (N, 3), offset (N, 3)), f32.
    """
    with span("k1"):
        count("rows", pts.shape[0])
        if pts.device.type == "cuda":
            return _launch(packed_offset, packed_template, pts, pose_feat)
        if pts.device.type == "cpu":
            return warp_template_query_plain(packed_offset, packed_template,
                                             pts, pose_feat)
    raise ValueError(f"unsupported device {pts.device}")


warp_template_query.launches = 0


def _recon_launch(packed, feats):
    dev = feats.device
    if feats.dim() != 2 or feats.shape[1] != RECON_IN_DIM:
        raise ValueError(f"feats must be (N, {RECON_IN_DIM}), got "
                         f"{tuple(feats.shape)}")
    n = feats.shape[0]
    if n >= 2 ** 31:
        raise ValueError("too many points for one launch")
    _check_weights(packed, RECON_SHAPES, dev)
    feats = feats.to(torch.float32).contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch, err_str = kernels.c_functions(
        "recon_decode", "recon_decode",
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4)
    image, bias = _cached_recon_image(packed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(feats.data_ptr(), n, image.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), stream)
    kernels.raise_on(err, err_str, "recon_decode")
    recon_decode.launches += 1
    return out


def _recon_wide_launch(packed, feats):
    dev = feats.device
    if feats.dim() != 2 or feats.shape[1] != RECON_WIDE_IN_DIM:
        raise ValueError(f"feats must be (N, {RECON_WIDE_IN_DIM}), got "
                         f"{tuple(feats.shape)}")
    n = feats.shape[0]
    if n * RECON_WIDE_IN_DIM >= 2 ** 31:
        raise ValueError("too many points for one launch")
    _check_weights(packed, RECON_WIDE_SHAPES, dev)
    feats = feats.to(torch.float32).contiguous()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch, err_str = kernels.c_functions(
        "recon_decode_wide", "recon_decode_wide",
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4)
    image, vecs = _cached_recon_wide_image(packed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(feats.data_ptr(), n, image.data_ptr(), vecs.data_ptr(),
                     out.data_ptr(), stream)
    kernels.raise_on(err, err_str, "recon_decode_wide")
    recon_decode.wide_launches += 1
    return out


def recon_decode(packed: Sequence[torch.Tensor], feats: torch.Tensor
                 ) -> torch.Tensor:
    """ReconNet pixel-aligned occupancy decode (inference).

    The packed shapes pick the kernel (RECON_FORMS): AvatarCap's decoder
    runs on K2, PIFu's on K2w, and any other is a ValueError. CUDA tensors
    launch the Hopper kernel (counted in ``recon_decode.launches`` and
    ``recon_decode.wide_launches``); CPU tensors run the plain version.
    Under a tracer, either is a span ``k2`` or ``k2w`` counting its
    ``rows``.

    Args:
      packed: pack_recon_weights output on the feats' device.
      feats: (N, 33) [pixel-aligned feature (32), z], or (N, 257) for
        PIFu's decoder.
    Returns:
      (N,) f32 occupancy in [0, 1].
    """
    shapes = _recon_shapes(packed)
    if shapes not in RECON_FORMS:
        raise ValueError(f"no kernel runs a decoder of packed shapes "
                         f"{shapes}; the kernels run {list(RECON_FORMS)}")
    kernel = RECON_FORMS[shapes][0]
    with span(kernel):
        count("rows", feats.shape[0])
        if feats.device.type == "cuda":
            return _RECON_RUNS[kernel][0](packed, feats)
        if feats.device.type == "cpu":
            return _RECON_RUNS[kernel][1](packed, feats)
    raise ValueError(f"unsupported device {feats.device}")


# each ReconNet kernel's launch and plain version, by its span
_RECON_RUNS = {"k2": (_recon_launch, recon_decode_plain),
               "k2w": (_recon_wide_launch, recon_decode_wide_plain)}


recon_decode.launches = 0
recon_decode.wide_launches = 0


def _check_rays(ro, rd, pf0, pf1, danch, bounds, n_samples):
    dev = ro.device
    r = ro.shape[0]
    if ro.dim() != 2 or ro.shape[1] != 3 or tuple(rd.shape) != (r, 3):
        raise ValueError(f"ro, rd must be (R, 3), got {tuple(ro.shape)} and "
                         f"{tuple(rd.shape)}")
    for name, t in (("pf0", pf0), ("pf1", pf1)):
        if tuple(t.shape) != (r, POSE_FEAT_DIM):
            raise ValueError(f"{name} must be ({r}, {POSE_FEAT_DIM}), got "
                             f"{tuple(t.shape)}")
    if danch.dim() != 2 or danch.shape[0] != r:
        raise ValueError(f"danch must be ({r}, A), got {tuple(danch.shape)}")
    if not 2 <= danch.shape[1] <= MAX_ANCHORS:
        raise ValueError(f"the ray kernel takes 2 <= A <= {MAX_ANCHORS} "
                         f"anchors, got {danch.shape[1]}")
    if n_samples < 2:
        raise ValueError(f"n_samples must be >= 2 (the sample gap divides by "
                         f"n_samples - 1), got {n_samples}")
    if tuple(bounds.shape) != (2, 3):
        raise ValueError(f"bounds must be (2, 3), got {tuple(bounds.shape)}")
    for t in (rd, pf0, pf1, danch, bounds):
        if t.device != dev:
            raise ValueError(f"ray inputs must share one device, got "
                             f"{t.device} and {dev}")
    if r >= 2 ** 31 // 64:
        raise ValueError("too many rays for one launch")


def _ray_launch(packed_offset, packed_template, ro, rd, pf0, pf1, danch,
                bounds, n_samples, near, far, threshold):
    dev = ro.device
    _check_weights(packed_offset, OFFSET_SHAPES, dev)
    _check_weights(packed_template, TEMPLATE_SHAPES, dev)
    r = ro.shape[0]
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    f32 = [t.to(torch.float32).contiguous() for t in (ro, rd, danch, bounds)]
    bf = [t.to(torch.bfloat16).contiguous() for t in (pf0, pf1)]
    near32, gap, step = ray_constants(n_samples, danch.shape[1], near, far)
    launch, err_str = kernels.c_functions(
        "ray_color_query", "rcq",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
        + [ctypes.c_void_p] * 4)
    image, bias = _cached_weight_image(packed_offset, packed_template)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(f32[0].data_ptr(), f32[1].data_ptr(), bf[0].data_ptr(),
                     bf[1].data_ptr(), f32[2].data_ptr(), f32[3].data_ptr(),
                     r, n_samples, danch.shape[1], near32, gap, step,
                     _f32(threshold), image.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), stream)
    kernels.raise_on(err, err_str, "ray_color_query")
    ray_color_query.launches += 1
    return out


def ray_color_query(packed_offset: Sequence[torch.Tensor],
                    packed_template: Sequence[torch.Tensor],
                    ro: torch.Tensor, rd: torch.Tensor, pf0: torch.Tensor,
                    pf1: torch.Tensor, danch: torch.Tensor,
                    bounds: torch.Tensor, n_samples: int, near: float,
                    far: float, threshold: float) -> torch.Tensor:
    """Per-ray color integral (inference): S samples z = linspace(near,
    far, S) along each ray, pose features lerped between the ray's two
    ends, K1's warp + template query per sample, the anchored near-body
    flag and the strict bounds test on the warped point as masks, and the
    raw2outputs compositing recurrence.

    CUDA tensors launch the Hopper kernel (counted in
    ``ray_color_query.launches``); CPU tensors run the plain version.
    Under a tracer, either is a span ``k3`` counting its ``rows`` (rays).

    Args:
      ro, rd: (R, 3) ray origins / directions (canonical space).
      pf0, pf1: (R, 64) pose features at the ray's near / far ends
        (rounded to bf16).
      danch: (R, A) distances to the body at A uniform depth anchors,
        2 <= A <= MAX_ANCHORS.
      bounds: (2, 3) canonical bounds (min, max) for the warped points.
      n_samples (>= 2), near, far: the sample grid.
      threshold: the near-body distance (pipeline.avatar.NEAR_SMPL_DIST).
    Returns:
      (R, 3) composited colors, f32.
    """
    _check_rays(ro, rd, pf0, pf1, danch, bounds, n_samples)
    with span("k3"):
        count("rows", ro.shape[0])
        if ro.device.type == "cuda":
            return _ray_launch(packed_offset, packed_template, ro, rd, pf0,
                               pf1, danch, bounds, n_samples, near, far,
                               threshold)
        if ro.device.type == "cpu":
            return ray_color_query_plain(packed_offset, packed_template, ro,
                                         rd, pf0, pf1, danch, bounds,
                                         n_samples, near, far, threshold)
    raise ValueError(f"unsupported device {ro.device}")


ray_color_query.launches = 0


def _template_launch(packed_template, pts):
    dev = pts.device
    n = pts.shape[0]
    _check_weights(packed_template, TEMPLATE_SHAPES, dev)
    pts = pts.to(torch.float32).contiguous()
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((n, 1), dtype=torch.float32, device=dev)
    occ = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if n == 0:
        return rgb, alpha, occ
    launch, err_str = kernels.c_functions(
        "template_offset_query", "tq",
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6)
    image, bias = _cached_weight_image(None, packed_template)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(pts.data_ptr(), n, image.data_ptr(), bias.data_ptr(),
                     rgb.data_ptr(), alpha.data_ptr(), occ.data_ptr(), stream)
    kernels.raise_on(err, err_str, "template_query")
    template_query.launches += 1
    return rgb, alpha, occ


def template_query(packed_template: Sequence[torch.Tensor],
                   pts: torch.Tensor):
    """DoubleTNet query on unwarped points (inference).

    CUDA tensors launch the Hopper kernel (counted in
    ``template_query.launches``); CPU tensors run the plain version.

    Args:
      packed_template: pack_template_weights output on the points' device.
      pts: (N, 3) canonical points.
    Returns:
      (rgb (N, 3), alpha (N, 1), occ (N, 1)), f32.
    """
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (N, 3), got {tuple(pts.shape)}")
    if pts.shape[0] >= 2 ** 31:
        raise ValueError("too many points for one launch")
    if pts.device.type == "cuda":
        return _template_launch(packed_template, pts)
    if pts.device.type == "cpu":
        return template_query_plain(packed_template, pts)
    raise ValueError(f"unsupported device {pts.device}")


template_query.launches = 0


def _offset_launch(packed_offset, feats):
    dev = feats.device
    n = feats.shape[0]
    _check_weights(packed_offset, OFFSET_SHAPES, dev)
    feats = feats.to(torch.float32).contiguous()
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch, err_str = kernels.c_functions(
        "template_offset_query", "oq",
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4)
    image, bias = _cached_weight_image(packed_offset, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(feats.data_ptr(), n, image.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), stream)
    kernels.raise_on(err, err_str, "offset_query")
    offset_query.launches += 1
    return out


def offset_query(packed_offset: Sequence[torch.Tensor], feats: torch.Tensor
                 ) -> torch.Tensor:
    """Warp-offset decode (inference; BatchNorm from running stats).

    CUDA tensors launch the Hopper kernel (counted in
    ``offset_query.launches``); CPU tensors run the plain version.

    Args:
      packed_offset: pack_offset_weights output on the feats' device.
      feats: (N, 67) [pts (3), pose features (64)].
    Returns:
      (N, 3) f32 offsets.
    """
    if feats.dim() != 2 or feats.shape[1] != OFFSET_IN_DIM:
        raise ValueError(f"feats must be (N, {OFFSET_IN_DIM}), got "
                         f"{tuple(feats.shape)}")
    if feats.shape[0] >= 2 ** 31 // OFFSET_IN_DIM:
        raise ValueError("too many points for one launch")
    if feats.device.type == "cuda":
        return _offset_launch(packed_offset, feats)
    if feats.device.type == "cpu":
        return offset_query_plain(packed_offset, feats)
    raise ValueError(f"unsupported device {feats.device}")


offset_query.launches = 0
