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
    before = warp_template_query.launches
    got = warp_template_query(tp["offset"], tp["template"],
                              torch.as_tensor(pts), torch.as_tensor(pf))
    # CPU tensors take the plain version: no kernel launch is counted
    assert warp_template_query.launches == before
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
