"""Kernel K1 (warp + template point query) of the port.

On the CPU the port's plain version is held against the Pallas kernel run
in interpret mode, with the packers on both sides. Both take bf16 operands
with f32 accumulation and round every activation to bf16, so they differ
only where a different f32 summation order flips a bf16 rounding (~1/3 of
the points carry one such flip somewhere in the 20 layers; the PE's 2^9
frequency amplifies a flipped offset). Measured max differences at these
sizes: occ 2e-3, rgb 5e-4, alpha 8e-4, offset 1e-4. The tolerances below
(5e-3 and 5e-4) are 4x tighter than the 2e-2 at which
tests/test_pallas_query.py holds the kernel against the f32 path.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py (skipped without a card) and by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from avatarcap_tpu_torch import kernels

ATOL = {"occ": 5e-3, "alpha": 5e-3, "rgb": 5e-3, "offset": 5e-4}


@pytest.fixture(scope="module")
def weights():
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar as TGeoTex
    from avatarcap_tpu_torch.pipeline.avatar import (
        pack_fused_query_weights as tpack)
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax

    module = GeoTexAvatar()
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
                             jnp.zeros((1, 128, 128, 6)), jnp.zeros((1, 3))))
    rs = np.random.RandomState(0)
    stats = variables["batch_stats"]["warping_field"]["mlp"]
    for bn in stats.values():
        bn["mean"] = rs.uniform(-0.2, 0.2, bn["mean"].shape).astype(np.float32)
        bn["var"] = rs.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    # ~3 cm offsets (a trained warp's scale) and an O(0.1) geometry head
    variables["params"]["warping_field"]["out_layer_coord_affine"][
        "kernel"] = rs.uniform(-0.002, 0.002, (256, 3)).astype(np.float32)
    variables["params"]["cano_template"]["geo_mlp"]["fc1_kernel"] = \
        rs.uniform(-0.1, 0.1, (128, 2)).astype(np.float32)
    port = TGeoTex()
    port.load_state_dict(avatar_state_dict_from_jax(variables))
    port.eval()
    with torch.no_grad():
        tp = tpack(port)
    return pack_fused_query_weights(variables), tp


def _inputs(n, seed):
    rs = np.random.RandomState(seed)
    pts = rs.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    pf = rs.standard_normal((n, 64)).astype(np.float32)
    return pts, pf


def test_packers_match_jax(weights):
    jp, tp = weights
    for key in ("offset", "template"):
        assert len(jp[key]) == len(tp[key])
        for a, b in zip(jp[key], tp[key]):
            af = np.asarray(a.astype(jnp.float32))
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            # the BN fold runs in f32 on both sides (XLA may fuse it into
            # an FMA): f32 biases agree to an ulp, bf16 weights to the
            # rare rounding flip that such an ulp causes
            rtol = 2.0 ** -8 if b.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(b.float().numpy().reshape(af.shape),
                                       af, rtol=rtol, atol=1e-30)


def test_macs_per_point_from_packed_shapes(weights):
    from avatarcap_tpu_torch.ops.fused_query import MACS_PER_POINT
    _, tp = weights
    ws = tp["offset"][0::2] + tp["template"][0::2]
    assert MACS_PER_POINT == sum(w.shape[0] * w.shape[1] for w in ws) \
        == 985472


@pytest.mark.parametrize("n", [512, 1000, 4096])
def test_plain_matches_pallas_interpret(weights, n):
    """Ragged (1000) and tile-multiple point counts."""
    from avatarcap_tpu.ops.pallas_query import warp_template_query_fused
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    jp, tp = weights
    pts, pf = _inputs(n, seed=n)
    with pltpu.force_tpu_interpret_mode():
        ref = warp_template_query_fused(jp["offset"], jp["template"],
                                        jnp.asarray(pts), jnp.asarray(pf))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    before = kernels.launches["k1"]
    got = warp_template_query(tp["offset"], tp["template"],
                              torch.as_tensor(pts), torch.as_tensor(pf))
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launches["k1"] == before
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), v, atol=ATOL[k],
                                   err_msg=k)
    # most points agree to f32 rounding: the bf16 flips stay rare
    d = np.abs(got["occ"].numpy() - ref["occ"])
    assert np.median(d) < 1e-5


def test_wrapper_rejects_other_devices(weights):
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    _, tp = weights
    pts = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        warp_template_query(tp["offset"], tp["template"], pts,
                            torch.zeros((4, 64), device="meta"))


# ---- the weight image of K1, K3, K4 and K5 --------------------------------

def _cuh_constants():
    """The integer constants csrc/chunk_ring.cuh and
    csrc/warp_template_core.cuh state."""
    from avatarcap_tpu_torch.kernels import source_constants
    return source_constants("chunk_ring.cuh", "warp_template_core.cuh")


def test_weight_image_constants_match_cuh():
    from avatarcap_tpu_torch.ops import fused_query as fq
    k = _cuh_constants()
    assert k["kChunkK"] == fq.CHUNK_K == 16
    assert (k["kOffsetChunks"], k["kTemplateChunks"]) == (
        fq.OFFSET_CHUNKS, fq.TEMPLATE_CHUNKS) == (106, 152)
    assert k["kOffsetImageElems"] == fq.OFFSET_IMAGE_ELEMS
    assert k["kTemplateImageElems"] == fq.TEMPLATE_IMAGE_ELEMS
    assert k["kOffsetBiasFloats"] == fq.OFFSET_BIAS_FLOATS
    assert k["kTemplateBiasFloats"] == fq.TEMPLATE_BIAS_FLOATS
    # the heads follow the chunks; the stream of both halves is 258 chunks
    # of 8 KB (O = 256) or 4 KB (O = 128)
    assert k["kOffsetHeadElem"] == 106 * 4096
    assert k["kTemplateGeoHeadElem"] == 120 * 4096 + 32 * 2048
    assert k["kTemplateClrHeadElem"] == k["kTemplateGeoHeadElem"] + 256
    assert 2 * (k["kOffsetHeadElem"] + k["kTemplateGeoHeadElem"]) == 1982464
    # a joint image's template half starts 16-byte aligned
    assert (2 * fq.OFFSET_IMAGE_ELEMS) % 16 == 0
    assert (4 * fq.OFFSET_BIAS_FLOATS) % 16 == 0
    # a ring stage holds one chunk of the widest layers
    assert k["kStageBytes"] == 2 * 256 * fq.CHUNK_K


def test_weight_image_sizes_and_inverse(weights):
    from avatarcap_tpu_torch.ops import fused_query as fq
    _, tp = weights
    image, bias = fq.weight_image(tp["offset"], tp["template"])
    assert image.dtype == torch.bfloat16 and bias.dtype == torch.float32
    assert image.numel() == fq.OFFSET_IMAGE_ELEMS + fq.TEMPLATE_IMAGE_ELEMS \
        == 992640
    assert bias.numel() == fq.OFFSET_BIAS_FLOATS + fq.TEMPLATE_BIAS_FLOATS \
        == 1796 + 2312
    halves = {"offset": image[:fq.OFFSET_IMAGE_ELEMS],
              "template": image[fq.OFFSET_IMAGE_ELEMS:]}
    # each half alone is the matching part of the joint image
    for key, kw in (("offset", dict(packed_offset=tp["offset"])),
                    ("template", dict(packed_template=tp["template"]))):
        half, _ = fq.weight_image(**kw)
        assert torch.equal(half, halves[key])
        for w, back in zip(tp[key][0::2],
                           fq.unpack_weight_image(half, key)):
            assert back.shape == w.shape and torch.equal(back, w)
    # biases: packed order, each padded to 4 floats
    pos = 0
    for b in tp["offset"][1::2] + tp["template"][1::2]:
        assert torch.equal(bias[pos:pos + b.numel()], b)
        pos += -(-b.numel() // 4) * 4
        assert not bias[pos - (-b.numel()) % 4:pos].any()
    assert pos == bias.numel()


def _chunk_block(image, pos, o):
    """Chunk at element pos -> its (O, 16) weight block, decoded as the
    tensor core reads it: two groups of 8 k, each O rows of 8 contiguous
    bf16 (core matrices of 8 rows x 16 bytes, 128 bytes apart)."""
    chunk = image[pos:pos + o * 16].reshape(2, o, 8)
    block = torch.zeros((o, 16), dtype=image.dtype)
    for kg in range(2):
        for n in range(o):
            block[n, 8 * kg:8 * kg + 8] = chunk[kg, n]
    return block


def _walk_layer(image, pos, panel, ci, k_pad, o, bias):
    """f32 sums of one wide layer, chunk by chunk, from panel columns
    [ci, ci + k_pad); returns (pre-activation (N, O), next pos)."""
    acc = torch.zeros((panel.shape[0], o))
    for c in range(k_pad // 16):
        block = _chunk_block(image, pos, o)
        a = panel[:, ci + 16 * c:ci + 16 * c + 16]
        acc = acc + a.float() @ block.float().T
        pos += o * 16
    return acc + bias, pos


def _bias_slices(packed):
    out, pos = [], 0
    for b in packed[1::2]:
        out.append((pos, b.numel()))
        pos += -(-b.numel() // 4) * 4
    return out


def test_weight_image_pad_columns_are_zero(weights):
    from avatarcap_tpu_torch.ops import fused_query as fq
    _, tp = weights
    image, _ = fq.weight_image(tp["offset"], tp["template"])
    # decoder input 80-wide: columns 67..79 of chunks 4 (k 64..79); the skip
    # layer (chunks 53..73, K 336) has the same pad at its chunk 4
    pos = 4 * 4096
    assert not _chunk_block(image, pos, 256)[:, 3:].any()
    assert _chunk_block(image, pos, 256)[:, :3].any()
    pos = (5 + 3 * 16 + 4) * 4096
    assert not _chunk_block(image, pos, 256)[:, 3:].any()
    # template input 64-wide: column 63 (chunk 3); res concat 320: column 319
    t0 = fq.OFFSET_IMAGE_ELEMS
    blk = _chunk_block(image, t0 + 3 * 4096, 256)
    assert not blk[:, 15].any() and blk[:, 14].any()
    blk = _chunk_block(image, t0 + (4 + 3 * 16 + 19) * 4096, 256)
    assert not blk[:, 15].any() and blk[:, 14].any()


def test_weight_image_walk_matches_plain(weights):
    """The chain as the kernels walk the image: panels with the kernels'
    column blocks, chunk after chunk, bf16 operands and f32 sums. Every
    layer's sums agree with the direct product on the same inputs to f32
    rounding; end to end the outputs differ from the plain versions only
    where the chunked summation order flips a bf16 rounding."""
    from avatarcap_tpu_torch.ops import fused_query as fq
    from avatarcap_tpu_torch.ops.embed import positional_encoding
    _, tp = weights
    image, bias = fq.weight_image(tp["offset"], tp["template"])
    bf = torch.bfloat16
    pts, pf = (torch.as_tensor(a) for a in _inputs(24, seed=7))
    n = pts.shape[0]
    checked = []

    def layer(pos, panel, ci, k_pad, o, b, packed, idx, real_in):
        acc, pos = _walk_layer(image, pos, panel, ci, k_pad, o, b)
        direct = fq._dot(packed[2 * idx], real_in, packed[2 * idx + 1])
        torch.testing.assert_close(acc, direct, atol=1e-5, rtol=1e-5)
        checked.append(idx)
        return acc, pos

    # offset half: x in [0, 67), zeros to 80, hidden in [80, 336)
    off_b = [bias[p:p + m] for p, m in _bias_slices(tp["offset"])]
    x = torch.cat([pts.to(bf), pf.to(bf)], -1)
    pa = torch.zeros((n, 344), dtype=bf)
    pb = torch.zeros((n, 344), dtype=bf)
    pa[:, :67] = x
    pos = 0
    src, dst = pa, pb
    for idx in range(7):
        ci, k_pad = ((0, 80) if idx == 0 else (0, 336) if idx == 4
                     else (80, 256))
        real_in = (x if idx == 0 else
                   torch.cat([x, src[:, 80:336]], -1) if idx == 4
                   else src[:, 80:336])
        acc, pos = layer(pos, src, ci, k_pad, 256, off_b[idx], tp["offset"],
                         idx, real_in)
        dst[:, 80:336] = fq._softplus(acc).to(bf)
        src, dst = dst, src
    assert pos == fq.OFFSET_CHUNKS * 4096
    head = image[pos:pos + 768].reshape(3, 256)
    offset = fq._dot(head, src[:, 80:336], off_b[7])
    ref = fq._offset_plain(tp["offset"], x)
    d = (offset - ref).abs()
    assert float(d.median()) <= 1e-6 and float(d.max()) <= ATOL["offset"]

    # template half on the plain version's warped points
    tpl_b = [bias[fq.OFFSET_BIAS_FLOATS + p:fq.OFFSET_BIAS_FLOATS + p + m]
             for p, m in _bias_slices(tp["template"])]
    wpts = pts + ref
    pe = positional_encoding(wpts, fq.NUM_FREQS).to(bf)
    pa.zero_(), pb.zero_()
    pa[:, 256:319] = pe
    t0 = fq.OFFSET_IMAGE_ELEMS
    pos = t0
    src, dst = pa, pb
    acts = [torch.relu] * 6 + [lambda v: v]
    for idx in range(7):
        ci, k_pad = ((256, 64) if idx == 0 else (0, 320) if idx == 4
                     else (0, 256))
        real_in = (pe if idx == 0 else
                   torch.cat([src[:, :256], pe], -1) if idx == 4
                   else src[:, :256])
        acc, pos = layer(pos, src, ci, k_pad, 256, tpl_b[idx], tp["template"],
                         idx, real_in)
        dst[:, :256] = acts[idx](acc).to(bf)
        src, dst = dst, src
    feat = src[:, :256].clone()
    acc, pos = layer(pos, src, 0, 256, 128, tpl_b[7], tp["template"], 7, feat)
    g = fq._leaky(acc).to(bf)
    acc, pos = layer(pos, src, 0, 256, 256, tpl_b[9], tp["template"], 9, feat)
    dst[:, :256] = torch.relu(acc).to(bf)
    c0 = dst[:, :256].clone()
    acc, pos = layer(pos, dst, 0, 256, 128, tpl_b[10], tp["template"], 10, c0)
    c1 = torch.relu(acc).to(bf)
    assert pos - t0 == 120 * 4096 + 32 * 2048
    geo_w = image[pos:pos + 256].reshape(2, 128)
    clr_w = image[pos + 256:pos + 640].reshape(3, 128)
    assert pos + 640 == image.numel()
    geo = fq._dot(geo_w, g, tpl_b[8])
    rgb = torch.sigmoid(fq._dot(clr_w, c1, tpl_b[11]))
    ref_geo, ref_rgb = fq._template_plain(tp["template"], wpts)
    for got, want, tol in ((geo, ref_geo, ATOL["occ"]),
                           (rgb, ref_rgb, ATOL["rgb"])):
        d = (got - want).abs()
        assert float(d.median()) <= 1e-6 and float(d.max()) <= tol
    assert checked == list(range(7)) + list(range(7)) + [7, 9, 10]


def test_weight_image_built_once_per_packed_set(weights):
    from avatarcap_tpu_torch.ops import fused_query as fq
    _, tp = weights
    before = fq.weight_image.builds
    a = fq._cached_weight_image(tp["offset"], tp["template"])
    b = fq._cached_weight_image(tp["offset"], tp["template"])
    assert a[0] is b[0] and fq.weight_image.builds == before + 1
    # another packed set, or an updated one, gets its own image
    other = tuple(t.clone() for t in tp["offset"])
    c = fq._cached_weight_image(other, tp["template"])
    assert c[0] is not a[0] and fq.weight_image.builds == before + 2
    other[0].mul_(2.0)
    d = fq._cached_weight_image(other, tp["template"])
    assert fq.weight_image.builds == before + 3
    assert not torch.equal(c[0], d[0])
    # one half alone
    e = fq._cached_weight_image(None, tp["template"])
    assert torch.equal(e[0], a[0][fq.OFFSET_IMAGE_ELEMS:])
