"""ReconNet and kernel K2 of the port against the JAX package.

The same weights go to both sides: a JAX ReconNetwork init (its decoder
head given numpy-drawn O(1) values, so the occupancy is not ~0.5
everywhere) goes to numpy, then through ``recon_state_dict_from_jax`` into
the port. Modules run in float32 on the CPU on both sides (conftest pins
JAX matmuls to "highest"), so their tolerances are f32 rounding-order
ones: 1e-5 for the point networks, 1e-4 for the 60-conv HGFilter.

K2: ``recon_decode_plain`` and the port's packer against the Pallas
``recon_decode_fused`` in interpret mode. Both round the same values to
bf16 at the same points and sum bf16 products in f32 in different orders,
so a bf16 rounding of an activation can flip. Measured max differences
at these sizes: 9e-4 to 1.6e-3, median ~1e-8. The 5e-3 tolerance below is
4x tighter than the 2e-2 at which tests/test_recon_fused.py holds the
kernel against the f32 decoder.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from avatarcap_tpu_torch import kernels

K2_ATOL = 5e-3


@pytest.fixture(scope="module")
def env():
    from avatarcap_tpu.models.recon import ReconNetwork
    from avatarcap_tpu_torch.models.recon import ReconNetwork as TRecon
    from avatarcap_tpu_torch.weights import recon_state_dict_from_jax

    module = ReconNetwork()
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 6)),
                             jnp.zeros((1, 8, 3)), jnp.zeros((1, 3))))
    rs = np.random.RandomState(5)
    dec = variables["params"]["image_decoder"]
    dec["fc3"]["kernel"] = rs.uniform(-1.0, 1.0, (128, 1)).astype(np.float32)
    # weight-norm gains away from |v| so the fold is not the identity
    for i in range(3):
        g = dec[f"fc{i}"]["g"]
        dec[f"fc{i}"]["g"] = (g * rs.uniform(0.5, 1.5, g.shape)
                              ).astype(np.float32)
    port = TRecon()
    port.load_state_dict(recon_state_dict_from_jax(variables))
    port.eval()
    return module, variables, port, rs


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_weight_bridge_roundtrip(env):
    """JAX variables -> port state_dict -> convert_recon_network gives back
    the original tree, leaf for leaf, under the reference key names."""
    from avatarcap_tpu.tools.convert_torch_ckpt import convert_recon_network
    _, variables, port, _ = env
    sd = port.state_dict()
    assert sd["image_decoder.fc_list.1.0.weight_g"].shape == (256, 1, 1)
    assert sd["image_decoder.fc_list.1.0.weight_v"].shape == (256, 545, 1)
    assert "image_encoder.conv2.downsample.2.weight" in sd
    assert "image_encoder.m0.b2_plus_1.conv1.weight" in sd
    back = convert_recon_network(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=str(path))


def test_weight_norm_conv_and_mlp(env):
    from avatarcap_tpu.models.layers import Dense
    from avatarcap_tpu.models.mlp import MLP
    _, variables, port, rs = env
    dec = variables["params"]["image_decoder"]
    x = rs.standard_normal((2, 300, 33)).astype(np.float32)
    ref = np.asarray(Dense(512, use_weight_norm=True).apply(
        {"params": dec["fc0"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = port.image_decoder.fc_list[0][0](_t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    jmlp = MLP(out_channels=1, inter_channels=(512, 256, 128),
               res_layers=(1, 2), nlactv="leaky_relu", last_op="sigmoid",
               weight_norm=True)
    ref = np.asarray(jmlp.apply({"params": dec}, jnp.asarray(x)))
    with torch.no_grad():
        got = port.image_decoder(_t(x)).numpy()
    assert got.shape == (2, 300, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_bicubic_upsample(env):
    from avatarcap_tpu.models.layers import upsample_bicubic_x2_align_corners
    from avatarcap_tpu_torch.models.layers import upsample_bicubic_x2
    rs = env[-1]
    x = rs.standard_normal((2, 7, 9, 5)).astype(np.float32)   # NHWC
    ref = np.asarray(upsample_bicubic_x2_align_corners(jnp.asarray(x)))
    got = upsample_bicubic_x2(_t(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    assert got.shape == (2, 14, 18, 5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_conv_block(env):
    from avatarcap_tpu.models.hourglass import ConvBlock
    _, variables, port, rs = env
    enc = variables["params"]["image_encoder"]
    x = rs.standard_normal((1, 32, 32, 64)).astype(np.float32)
    ref = np.asarray(ConvBlock(64, 128).apply({"params": enc["conv2"]},
                                              jnp.asarray(x)))
    with torch.no_grad():
        got = port.image_encoder.conv2(_t(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_hgfilter_and_decode_points(env):
    """get_feat_maps at a 64^2 normal image, then the per-point decode on
    the JAX feature map (so the decode is compared on its own)."""
    from avatarcap_tpu.models.recon import ReconNetwork
    module, variables, port, rs = env
    img = rs.standard_normal((1, 64, 64, 6)).astype(np.float32)
    ref = np.asarray(module.apply(variables, jnp.asarray(img),
                                  method=ReconNetwork.get_feat_maps))
    with torch.no_grad():
        got = port.get_feat_maps(_t(img)).numpy()
    assert got.shape == ref.shape == (1, 32, 32, 32)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)

    pts = rs.uniform(-0.6, 0.6, (1, 700, 3)).astype(np.float32)
    center = rs.uniform(-0.1, 0.1, (1, 3)).astype(np.float32)
    ref_d = np.asarray(module.apply(variables, jnp.asarray(ref),
                                    jnp.asarray(pts), jnp.asarray(center),
                                    method=ReconNetwork.decode_points))
    with torch.no_grad():
        got_d = port.decode_points(_t(ref), _t(pts), _t(center)).numpy()
    assert got_d.shape == (1, 700)
    assert ref_d.min() < 0.4 and ref_d.max() > 0.6     # a real 0.5 crossing
    np.testing.assert_allclose(got_d, ref_d, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(down_type="ave_pool"),
                                dict(n_stack=2),
                                dict(use_sigmoid=True)],
                         ids=["ave_pool", "n_stack_2", "use_sigmoid"])
def test_hgfilter_rejects_other_down_types(kw):
    """The HGFilter forms ReconNet does not use (2x average pooling after
    conv2, a second stack fed through bl0 / al0, a tanh output) at depth 2
    on a 64^2 image against JAX's, the weights through
    hgfilter_state_dict_from_jax; a down type neither package has is
    refused."""
    from avatarcap_tpu.models.hourglass import HGFilter as JHG
    from avatarcap_tpu_torch.models.hourglass import HGFilter
    from avatarcap_tpu_torch.weights import hgfilter_state_dict_from_jax
    with pytest.raises(ValueError, match="down_type"):
        HGFilter(down_type="conv64")
    rs = np.random.RandomState(len(str(kw)))
    img = rs.standard_normal((1, 64, 64, 6)).astype(np.float32)
    module = JHG(depth=2, last_ch=16, **kw)
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(2), jnp.asarray(img)))
    port = HGFilter(depth=2, in_ch=6, last_ch=16, **kw)
    sd = hgfilter_state_dict_from_jax(variables, depth=2,
                                      n_stack=kw.get("n_stack", 1))
    port.load_state_dict(sd)
    assert ("bl0.weight" in sd and "al0.bias" in sd) == ("n_stack" in kw)
    ref_out, ref_normx = module.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got_out, got_normx = port(_t(img).permute(0, 3, 1, 2))
    side = 16 if "down_type" in kw else 32
    assert len(got_out) == len(ref_out) == kw.get("n_stack", 1)
    assert got_normx.shape == (1, 128, side, side)
    np.testing.assert_allclose(got_normx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_normx), atol=1e-4, rtol=1e-4)
    for g, r in zip(got_out, ref_out):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == (1, side, side, 16)
        if kw.get("use_sigmoid"):
            assert np.abs(g).max() <= 1.0
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=1e-4)


def test_recon_packer_matches_jax(env):
    from avatarcap_tpu.ops.pallas_query import pack_recon_weights
    from avatarcap_tpu_torch.ops.fused_query import (
        RECON_MACS_PER_POINT, RECON_SHAPES, pack_recon_weights as tpack)
    _, variables, port, _ = env
    jp = pack_recon_weights(variables["params"]["image_decoder"])
    with torch.no_grad():
        tp = tpack(port.image_decoder)
    assert len(jp) == len(tp) == 8
    for (o, i), w, b in zip(RECON_SHAPES, tp[0::2], tp[1::2]):
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == (o, i)
        assert b.dtype == torch.float32 and tuple(b.shape) == (o,)
    for a, b in zip(jp, tp):
        af = np.asarray(a.astype(jnp.float32)).reshape(tuple(b.shape))
        # the weight-norm fold runs in f32 on both sides in another
        # order, so a weight can round to the neighbouring bf16 value: bf16
        # weights agree to one bf16 ulp (2^-7 relative at most), f32
        # biases to 1e-6 relative
        rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(b.float().numpy(), af, rtol=rtol,
                                   atol=1e-30)
    assert RECON_MACS_PER_POINT == sum(
        w.shape[0] * w.shape[1] for w in tp[0::2]) == 193536


@pytest.mark.parametrize("n", [300, 2048, 5000])
def test_recon_plain_matches_pallas_interpret(env, n):
    """Ragged (300, 5000) and tile-multiple (2048) point counts."""
    from avatarcap_tpu.ops.pallas_query import (pack_recon_weights,
                                                recon_decode_fused)
    from avatarcap_tpu_torch.ops.fused_query import (
        pack_recon_weights as tpack, recon_decode)
    _, variables, port, _ = env
    jp = pack_recon_weights(variables["params"]["image_decoder"])
    with torch.no_grad():
        tp = tpack(port.image_decoder)
    rs = np.random.RandomState(n)
    feats = rs.standard_normal((n, 33)).astype(np.float32)
    feats[:, 32] *= 0.3                                       # z in metres
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(recon_decode_fused(jp, jnp.asarray(feats)))
    before = kernels.launches["k2"]
    got = recon_decode(tp, _t(feats))
    # CPU tensors take the plain version: no kernel launch is counted
    assert kernels.launches["k2"] == before
    assert got.shape == (n,) and got.dtype == torch.float32
    d = np.abs(got.numpy() - ref)
    assert d.max() < K2_ATOL, d.max()
    # most points agree to f32 rounding: the bf16 flips stay rare
    assert np.median(d) < 1e-5
    assert ref.min() < 0.2 and ref.max() > 0.8


def test_recon_wrapper_rejects_other_devices(env):
    from avatarcap_tpu_torch.ops.fused_query import (
        pack_recon_weights as tpack, recon_decode)
    _, _, port, _ = env
    with torch.no_grad():
        tp = tpack(port.image_decoder)
    with pytest.raises(ValueError):
        recon_decode(tp, torch.zeros((4, 33), device="meta"))


# ---- the weight image of K2 ------------------------------------------------

@pytest.fixture(scope="module")
def packed(env):
    from avatarcap_tpu_torch.ops.fused_query import pack_recon_weights
    _, _, port, _ = env
    with torch.no_grad():
        return pack_recon_weights(port.image_decoder)


def test_recon_image_constants_match_cu():
    from avatarcap_tpu_torch.kernels import source_constants
    from avatarcap_tpu_torch.ops import fused_query as fq
    k = source_constants("chunk_ring.cuh", "recon_decode.cu")
    assert k["kChunkK"] == fq.CHUNK_K == 16
    assert k["kXCols"] == fq.RECON_X_COLS == 48
    assert k["kReconHeadElem"] == fq.RECON_HEAD_ELEM == 206848
    assert k["kReconImageElems"] == fq.RECON_IMAGE_ELEMS
    assert k["kReconBiasFloats"] == fq.RECON_BIAS_FLOATS == 900
    # the stream as the kernel's producer sends it: per slice of layer 0,
    # 3 chunks of 4 KB (O = 128) and 8 of 8 KB (O = 256); layer 1's x
    # segment; layer 2's 19 chunks of 4 KB
    sizes = [o * fq.CHUNK_K * 2 for _, _, o, _ in fq._recon_stream()]
    runs = ([3 * [4096] + k["kSliceChunks"] * [8192]] * k["kSlices"]
            + [k["kXChunks"] * [8192], (k["kH2Chunks"] + 3) * [4096]])
    assert sizes == sum(runs, []) and len(sizes) == fq.RECON_CHUNKS == 66
    assert sum(sizes) == 2 * fq.RECON_HEAD_ELEM == 413696
    assert max(sizes) == k["kStageBytes"]


def test_recon_image_sizes_and_inverse(packed):
    from avatarcap_tpu_torch.ops import fused_query as fq
    image, bias = fq.recon_weight_image(packed)
    assert image.dtype == torch.bfloat16 and bias.dtype == torch.float32
    assert image.numel() == fq.RECON_IMAGE_ELEMS and 2 * image.numel() == 413952
    assert bias.numel() == fq.RECON_BIAS_FLOATS
    for w, back in zip(packed[0::2], fq.unpack_recon_weight_image(image)):
        assert back.shape == w.shape and torch.equal(back, w)
    # biases: packed order, each padded to 4 floats
    pos = 0
    for b in packed[1::2]:
        assert torch.equal(bias[pos:pos + b.numel()], b)
        pos += -(-b.numel() // 4) * 4
        assert not bias[pos - (-b.numel()) % 4:pos].any()
    assert pos == bias.numel()


def _recon_chunks(image):
    """(layer, first row, rows, k-chunk, (rows, 16) block) of each chunk,
    decoded as the tensor core reads it: two groups of 8 k, each `rows`
    rows of 8 contiguous bf16."""
    from avatarcap_tpu_torch.ops import fused_query as fq
    pos = 0
    for layer, r0, o, c in fq._recon_stream():
        chunk = image[pos:pos + o * 16].reshape(2, o, 8)
        yield layer, r0, o, c, torch.cat([chunk[0], chunk[1]], dim=1)
        pos += o * 16


def test_recon_image_pad_columns_are_zero(packed):
    from avatarcap_tpu_torch.ops import fused_query as fq
    image, _ = fq.recon_weight_image(packed)
    seen = 0
    for layer, _, _, c, block in _recon_chunks(image):
        # the x segment's last chunk: k 32-47 of layer 0, and of the x
        # segments after h1 (512) and h2 (256); x has 33 columns
        if (layer, c) in ((0, 2), (1, 34), (2, 18)):
            assert not block[:, 1:].any() and block[:, 0].any()
            seen += 1
        else:
            assert block.abs().sum(1).all()
    assert seen == 6                     # layer 0 comes in four slices


def test_recon_image_walk_matches_plain(packed):
    """K2 as its kernel walks the image: chunk after chunk in the stream's
    order, bf16 operands, f32 sums. Each chunk may only read activations
    whose layer sums are complete by then; each layer's sums agree with the
    direct product to f32 rounding, and the output with the plain version
    where the chunked summation order flips no bf16 rounding."""
    from avatarcap_tpu_torch.ops import fused_query as fq
    image, bias = fq.recon_weight_image(packed)
    bf = torch.bfloat16
    rs = np.random.RandomState(11)
    feats = torch.as_tensor(rs.standard_normal((40, 33)).astype(np.float32))
    n = feats.shape[0]
    x = feats.to(bf)
    xp = torch.zeros((n, fq.RECON_X_COLS), dtype=bf)
    xp[:, :33] = x
    b = [bias[0:512], bias[512:768], bias[768:896], bias[896:897]]
    widths = (512, 256, 128)
    acc = [torch.zeros((n, o)) for o in widths]
    steps = [torch.zeros(o, dtype=torch.long) for o in widths]
    k_steps = (3, 35, 19)

    def act(layer, cols):
        """bf16(leaky(sums + b)) of finished columns of a layer."""
        assert (steps[layer][cols] == k_steps[layer]).all(), (layer, cols)
        return fq._leaky(acc[layer][:, cols] + b[layer][cols]).to(bf)

    for layer, r0, o, c, block in _recon_chunks(image):
        if layer == 0:
            a = xp[:, 16 * c:16 * c + 16]
        else:
            hw = widths[layer - 1]
            a = (act(layer - 1, slice(16 * c, 16 * c + 16)) if 16 * c < hw
                 else xp[:, 16 * c - hw:16 * c - hw + 16])
        acc[layer][:, r0:r0 + o] += a.float() @ block.float().T
        steps[layer][r0:r0 + o] += 1
    h = [act(layer, slice(None)) for layer in range(3)]
    ins = [x, torch.cat([h[0], x], -1), torch.cat([h[1], x], -1)]
    for layer in range(3):
        direct = fq._dot(packed[2 * layer], ins[layer], packed[2 * layer + 1])
        torch.testing.assert_close(acc[layer] + b[layer], direct, atol=1e-5,
                                   rtol=1e-5)
    head = image[fq.RECON_HEAD_ELEM:].reshape(1, 128)
    occ = torch.sigmoid(fq._dot(head, h[2], b[3]))[:, 0]
    d = (occ - fq.recon_decode_plain(packed, feats)).abs()
    assert float(d.median()) <= 1e-6 and float(d.max()) <= K2_ATOL


def test_recon_image_built_once_per_packed_set(packed):
    from avatarcap_tpu_torch.ops import fused_query as fq
    before = fq.recon_weight_image.builds
    a = fq._cached_recon_image(packed)
    b = fq._cached_recon_image(packed)
    assert a[0] is b[0] and fq.recon_weight_image.builds == before + 1
    # another packed set, or an updated one, gets its own image
    other = tuple(t.clone() for t in packed)
    c = fq._cached_recon_image(other)
    assert c[0] is not a[0] and fq.recon_weight_image.builds == before + 2
    other[0].mul_(2.0)
    d = fq._cached_recon_image(other)
    assert fq.recon_weight_image.builds == before + 3
    assert not torch.equal(c[0], d[0])
    assert torch.equal(a[0], c[0])
