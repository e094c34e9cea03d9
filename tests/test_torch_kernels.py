"""The one seam through which the port calls its hand-written kernels
(avatarcap_tpu_torch/kernels.py: ``launch``, which counts each call in
``launches``), on the CPU: every kernel wrapper of ops/fused_query.py
runs its plain version on CPU tensors, bit for bit, and counts no launch;
``launch`` refuses a device that is not CUDA before it loads or builds a
library; and every CUDA source is a library of the kernel table.
"""

import ctypes

import pytest
import torch

from avatarcap_tpu_torch import kernels
from avatarcap_tpu_torch.ops import fused_query as fq


@pytest.fixture(scope="module")
def packed():
    """Random weights at published widths: the avatar's offset and
    template networks (K1, K3, K4, K5), AvatarCap's ReconNet decoder (K2)
    and PIFu's (K2w)."""
    from avatarcap_tpu_torch.models.recon import PIFU_SHAPE_NETWORK
    from avatarcap_tpu_torch.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.tools.bench_workloads import (random_avatar,
                                                           random_recon)
    gen = torch.Generator().manual_seed(0)
    query = pack_fused_query_weights(random_avatar(gen))
    pifu = random_recon(gen, **PIFU_SHAPE_NETWORK)
    return {"offset": query["offset"], "template": query["template"],
            "recon": fq.pack_recon_weights(random_recon(gen).image_decoder),
            "pifu": fq.pack_recon_weights(pifu.image_decoder)}


def _calls(p):
    """Per kernel key: (its wrapper's call, its plain version's call) on
    the same CPU inputs (ray origins 1.5 m out, looking back at the
    template)."""
    gen = torch.Generator().manual_seed(1)
    n, r = 300, 16

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo
    pts, pf = rand(n, 3, lo=-0.8, hi=0.8), rand(n, fq.POSE_FEAT_DIM)
    feats = torch.cat([pts, pf], -1)
    recon_feats = rand(n, fq.RECON_IN_DIM)
    wide_feats = rand(n, fq.RECON_WIDE_IN_DIM)
    rd = torch.nn.functional.normalize(rand(r, 3), dim=-1)
    ro = rand(r, 3, lo=-0.1, hi=0.1) - 1.5 * rd
    ray = (p["offset"], p["template"], ro, rd,
           rand(r, fq.POSE_FEAT_DIM).to(torch.bfloat16),
           rand(r, fq.POSE_FEAT_DIM).to(torch.bfloat16),
           rand(r, 4, lo=0.0, hi=0.1),
           torch.tensor([[-0.9, -1.2, -0.5], [0.9, 1.2, 0.5]]))
    ray_kw = dict(n_samples=8, near=0.5, far=2.5, threshold=0.05)
    off, tpl = p["offset"], p["template"]
    return {
        "k1": (lambda: fq.warp_template_query(off, tpl, pts, pf),
               lambda: fq.warp_template_query_plain(off, tpl, pts, pf)),
        "k2": (lambda: fq.recon_decode(p["recon"], recon_feats),
               lambda: fq.recon_decode_plain(p["recon"], recon_feats)),
        "k2w": (lambda: fq.recon_decode(p["pifu"], wide_feats),
                lambda: fq.recon_decode_wide_plain(p["pifu"], wide_feats)),
        "k3": (lambda: fq.ray_color_query(*ray, **ray_kw),
               lambda: fq.ray_color_query_plain(*ray, **ray_kw)),
        "k4": (lambda: fq.template_query(tpl, pts),
               lambda: fq.template_query_plain(tpl, pts)),
        "k5": (lambda: fq.offset_query(off, feats),
               lambda: fq.offset_query_plain(off, feats)),
    }


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return list(out)


@pytest.mark.parametrize("kernel", ["k1", "k2", "k2w", "k3", "k4", "k5"])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(packed,
                                                               kernel):
    call, plain = _calls(packed)[kernel]
    before = dict(kernels.launches)
    got = call()
    assert kernels.launches == before
    want = plain()
    assert len(_tensors(got)) == len(_tensors(want))
    assert any(bool(g.abs().max() > 0) for g in _tensors(got))
    for g, w in zip(_tensors(got), _tensors(want)):
        assert g.device.type == "cpu" and g.numel() > 0
        assert torch.equal(g, w)


def test_launch_refuses_a_device_that_is_not_cuda(monkeypatch):
    """The device is checked before any library is loaded or built, and a
    refused call counts nothing."""
    def no_build(*args, **kw):
        raise AssertionError("a library was loaded or built")
    monkeypatch.setattr(kernels, "load", no_build)
    monkeypatch.setattr(kernels, "build_all", no_build)
    functions = dict(kernels._FUNCTIONS)
    before = dict(kernels.launches)
    for device in ("cpu", torch.device("cpu"), "meta"):
        with pytest.raises(ValueError, match="CUDA device"):
            kernels.launch("k1", [ctypes.c_void_p], (0,), device)
    assert kernels.launches == before
    assert kernels._FUNCTIONS == functions


def test_every_source_is_a_kernel_library():
    """Each csrc/*.cu is the library of at least one kernel key, and the
    counts start with every key."""
    cu = {p.stem for p in kernels.CSRC.glob("*.cu")}
    assert set(kernels.SOURCES) == cu
    assert set(kernels.launches) == set(kernels.KERNELS)
