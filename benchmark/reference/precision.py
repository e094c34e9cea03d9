"""The controls: the reference computed one precision below what the
configuration states, to show that the comparison catches it.

- ``fp8``: the point MLPs (offset decoder and head, template, ReconNet's
  decoder), which the configuration runs in bf16 with f32 accumulation,
  take inputs and weights rounded to float8 e4m3 (a per-tensor scale for
  the weights, a per-row scale for the inputs); the float32 rest
  (convolutions, matmuls) runs in TF32.
- ``tf32``: every float32 matmul and convolution in TF32 (the training
  step states float32 with TF32 off). cuBLAS keeps small products in
  float32 even where TF32 is allowed, so the einsums (the merge's) take
  operands rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import layers

E4M3_MAX = 448.0


def to_e4m3(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over ``dim``, or the whole tensor) to 448."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (10 mantissa bits); the
    gradient passes through unrounded."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    rounded = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def _fp8_linear(x, w, b):
    return F.linear(to_e4m3(x, dim=-1), to_e4m3(w), b)


@contextlib.contextmanager
def tf32():
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32, torch.einsum)
    einsum = torch.einsum
    m.allow_tf32 = c.allow_tf32 = True
    torch.einsum = lambda eq, *ops: einsum(eq, *(to_tf32(o) for o in ops))
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32, torch.einsum = saved


@contextlib.contextmanager
def fp8():
    pc, wn = layers.PointConv1d, layers.WeightNormPointConv1d
    saved = (pc.forward, wn.forward)
    pc.forward = lambda self, x: _fp8_linear(x, self.weight[:, :, 0],
                                             self.bias)
    wn.forward = lambda self, x: _fp8_linear(x, self.folded_weight(),
                                             self.bias)
    try:
        with tf32():
            yield
    finally:
        pc.forward, wn.forward = saved


@contextlib.contextmanager
def f32():
    """The reference's own precision: float32, TF32 off."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


CONTROLS = {"fp8": fp8, "tf32": tf32}
