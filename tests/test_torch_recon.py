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


def test_hgfilter_rejects_other_down_types():
    from avatarcap_tpu_torch.models.hourglass import HGFilter
    with pytest.raises(NotImplementedError, match="no_down"):
        HGFilter(down_type="ave_pool")


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
    before = recon_decode.launches
    got = recon_decode(tp, _t(feats))
    # CPU tensors take the plain version: no kernel launch is counted
    assert recon_decode.launches == before
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
