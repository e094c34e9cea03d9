"""PIFu's shape network as the port's ReconNet (models/recon.ReconNetwork
with PIFU_SHAPE_NETWORK) and its kernel K2w's CPU pieces, held against
the benchmark's float32 reference written from PIFu's published code
(benchmark/reference/pifu.py), on seeded random weights at a small size
(64^2 normal images, 300 points). Each tolerance says why it is what it
is, and a case computed a precision lower fails it. Also: AvatarCap's
default ReconNetwork is the same network as before the keywords, and K2w's
weight image agrees with the numbers of csrc/recon_decode_wide.cu."""

import copy
import hashlib

import pytest
import torch

from avatarcap_tpu_torch.models.recon import PIFU_SHAPE_NETWORK, ReconNetwork
from avatarcap_tpu_torch.ops import fused_query as fq
from avatarcap_tpu_torch.tools.bench_workloads import random_recon

# the same float32 operations in the same order on both sides: they agree
# to the bit here; 1e-5 leaves room for another summation order only
F32_TOL = 1e-5
# K2w's plain version rounds each of its four hidden activations to bf16
# (2^-9 relative) where the reference keeps float32: up to ~1.2e-3 on an
# occupancy, ~1.3e-4 in the median on these draws; bounds 4x above
PLAIN_TOL, PLAIN_MEDIAN_TOL = 5e-3, 5e-4
# AvatarCap's ReconNetwork() under torch.manual_seed(0), before the
# keywords (its digest as benchmark/tests/test_networks.py computes one)
DEFAULT_DIGEST = "a560df4e419a0945"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


class _InBf16(torch.nn.Module):
    """A module run in bf16 on bf16 inputs, its output back in float32."""

    def __init__(self, module):
        super().__init__()
        self.module = module.to(torch.bfloat16)

    def forward(self, x):
        return self.module(x.to(torch.bfloat16)).float()


def _digest(state: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(state):
        v = state[k].detach().contiguous()
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


def _pifu(seed):
    from benchmark.reference.pifu import ReconNetwork as Reference
    port = random_recon(torch.Generator().manual_seed(seed),
                        **PIFU_SHAPE_NETWORK).eval()
    ref = Reference(**PIFU_SHAPE_NETWORK).eval()
    ref.load_state_dict(port.state_dict())
    return port, ref


def _frame(seed):
    g = torch.Generator().manual_seed(100 + seed)
    img = torch.nn.functional.normalize(torch.randn(1, 64, 64, 6, generator=g),
                                        dim=-1)
    pts = torch.rand(1, 300, 3, generator=g) - 0.5
    return img, pts, torch.zeros(1, 3)


def test_default_recon_network_is_avatarcaps():
    torch.manual_seed(0)
    net = ReconNetwork()
    assert _digest(net.state_dict()) == DEFAULT_DIGEST
    assert net.image_decoder.fc_list[0][1].negative_slope == 0.02
    assert net.image_decoder.fc_list[0][0].weight_v.shape == (512, 33, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_pifu_matches_reference(seed):
    from benchmark.reference.pifu import ReconNetwork as Reference
    port, ref = _pifu(seed)
    assert {k: v.shape for k, v in port.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    img, pts, c = _frame(seed)
    with torch.no_grad():
        fp, fr = port.get_feat_maps(img), ref.get_feat_maps(img)
        assert fp.shape == (1, 16, 16, 256)
        got = port.decode_points(fp, pts, c)
        want = ref.decode_points(fr, pts, c)
        assert float((fp - fr).abs().max()) <= F32_TOL
        assert float((got - want).abs().max()) <= F32_TOL
        # the reference's decoder a precision lower fails the tolerance
        low = copy.deepcopy(ref)
        low.image_decoder = _InBf16(low.image_decoder)
        got_low = low.decode_points(fr, pts, c)
    assert float((got_low - want).abs().max()) > 100 * F32_TOL


def _e4m3_plain(packed, feats):
    """K2w's plain arithmetic with every activation and the input rounded
    to float8 e4m3 instead of bf16 (the benchmark's fp8 control)."""
    from benchmark.reference.precision import to_e4m3
    w = packed
    x = to_e4m3(feats.float(), dim=-1)
    h = to_e4m3(fq._leaky(fq._dot(w[0], x, w[1]), 0.01), dim=-1)
    for i in range(1, 4):
        h = to_e4m3(fq._leaky(fq._dot(w[2 * i], torch.cat([h, x], -1),
                                      w[2 * i + 1]), 0.01), dim=-1)
    return torch.sigmoid(fq._dot(w[8], torch.cat([h, x], -1), w[9]))[:, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2w_plain_matches_reference_decoder(seed):
    port, ref = _pifu(seed)
    packed = fq.pack_recon_weights(port.image_decoder)
    assert tuple(tuple(w.shape) for w in packed[0::2]) == fq.RECON_WIDE_SHAPES
    g = torch.Generator().manual_seed(seed)
    feats = torch.cat([0.5 * torch.randn(300, 256, generator=g),
                       torch.rand(300, 1, generator=g) - 0.5], -1)
    # the reference on the kernel's operands: bf16 inputs and weights, in
    # float32 from there
    ref.image_decoder.load_state_dict({
        k: v.to(torch.bfloat16).float() if k.endswith("weight") else v
        for k, v in port.image_decoder.state_dict().items()})
    with torch.no_grad():
        want = ref.image_decoder(feats.to(torch.bfloat16).float())[:, 0]
    got = fq.recon_decode_wide_plain(packed, feats)
    assert got.dtype == torch.float32 and got.shape == (300,)
    d = (got - want).abs()
    assert float(d.max()) <= PLAIN_TOL
    assert float(d.median()) <= PLAIN_MEDIAN_TOL
    d_low = (_e4m3_plain(packed, feats) - want).abs()
    assert float(d_low.max()) > PLAIN_TOL
    assert float(d_low.median()) > PLAIN_MEDIAN_TOL


def test_recon_decode_sends_pifu_to_k2w_on_the_cpu():
    from avatarcap_tpu_torch.utils.timers import Tracer, live_rows
    port, _ = _pifu(0)
    packed = fq.pack_recon_weights(port.image_decoder)
    feats = torch.randn(200, 257, generator=torch.Generator().manual_seed(3))
    tracer = Tracer("cpu")
    with tracer("stage"), live_rows(150):
        got = fq.recon_decode(packed, feats)
    assert torch.equal(got, fq.recon_decode_wide_plain(packed, feats))
    (op,) = [s for s in tracer.collect() if s.kind == "op"]
    assert op.name == "k2w" and op.counts == {"rows": 200, "live": 150}
    with pytest.raises(ValueError):         # the kernel's slope is 0.01
        fq.pack_recon_weights(random_recon(
            torch.Generator().manual_seed(0),
            **dict(PIFU_SHAPE_NETWORK, leaky_slope=0.02)).image_decoder)


@pytest.mark.parametrize("widths", [(64, 32, 16, 8), (512, 256, 128, 64)])
def test_recon_decode_refuses_decoders_no_kernel_runs(widths):
    """Five layers of other widths than PIFu's (and four of other widths
    than AvatarCap's) are no kernel's: a ValueError on the CPU as on the
    card, not the plain version of another decoder."""
    from avatarcap_tpu_torch.models.mlp import MLP
    torch.manual_seed(0)
    dec = MLP(33, 1, widths, res_layers=(1, 2, 3, 4), nlactv="leaky_relu",
              last_op="sigmoid", leaky_slope=0.01)
    packed = fq.pack_recon_weights(dec)
    with pytest.raises(ValueError, match="no kernel runs"):
        fq.recon_decode(packed, torch.randn(10, 33))
    with pytest.raises(ValueError, match="no kernel runs"):
        fq.recon_decode(packed[2:], torch.randn(10, 33))


def _consumer_order():
    """(layer, first row, rows, first column) of each chunk in the order
    the kernel's consumers take them (recon_decode_wide.cu's kernel)."""
    order = []
    for hh in range(2):
        for j in range(8):
            order += [(0, 128 * j, 128, 16 * c) for c in range(16)]
            order += [(1, 256 * hh, 256, 128 * j + 16 * c) for c in range(8)]
        order += [(1, 256 * hh, 256, 1024 + 16 * c) for c in range(16)]
    order += [(2, 0, 256, 256 + 16 * c) for c in range(16)]       # h2b
    order += [(2, 0, 256, 16 * c) for c in range(16)]             # h2s
    order += [(2, 0, 256, 512 + 16 * c) for c in range(16)]       # xf
    order += [(3, 0, 128, 16 * c) for c in range(16)]
    order += [(3, 0, 128, 256 + 16 * c) for c in range(16)]
    return order


def test_k2w_image_matches_the_kernel_source():
    from avatarcap_tpu_torch.kernels import source_constants
    k = source_constants("chunk_ring.cuh", "recon_decode_wide.cu")
    assert k["kIn"] == fq.RECON_WIDE_IN_DIM == 257
    assert k["kXCols"] == fq.RECON_WIDE_X_COLS == 256
    assert k["kWideHeadElem"] == fq.RECON_WIDE_HEAD_ELEM == 1179648
    assert k["kWideImageElems"] == fq.RECON_WIDE_IMAGE_ELEMS
    assert k["kWideBiasFloats"] == fq.RECON_WIDE_BIAS_FLOATS == 1924
    assert (k["kStages"], k["kStageBytes"]) == (6, 16384)
    # K2 keeps its ring: the default of the shared header
    assert source_constants("chunk_ring.cuh", "recon_decode.cu")[
        "kStages"] == 21
    port, _ = _pifu(0)
    packed = fq.pack_recon_weights(port.image_decoder)
    image, vecs = fq.recon_wide_weight_image(packed)
    assert image.numel() == fq.RECON_WIDE_IMAGE_ELEMS
    assert vecs.numel() == 2 * fq.RECON_WIDE_BIAS_FLOATS
    back = fq.unpack_recon_wide_weight_image(image, vecs)
    assert all(torch.equal(a, b) for a, b in zip(back, packed[0::2]))
    # the producer's stream as produce_wide sends it (each region's start
    # from the source's sizes, a stage of 16 KB at a time) holds, stage by
    # stage, the blocks the consumers take in their order
    raw = image.view(torch.int16)
    l0, l1h = 0, k["kL0Elems"]
    l1x = l1h + k["kL1hElems"]
    l2 = l1x + k["kL1xElems"]
    l3 = l2 + k["kL2Elems"]
    stage = k["kStageBytes"] // 2
    runs = []
    for hh in range(2):
        for j in range(8):
            runs += [(l0 + 128 * 256 * j, 4),
                     (l1h + 256 * 128 * (8 * hh + j), 4)]
        runs += [(l1x + 256 * 256 * hh, 8)]
    runs += [(l2, 24), (l3, 8)]
    stream = torch.cat([raw[s:s + n * stage] for s, n in runs])
    pos = 0
    for layer, r0, o, c0 in _consumer_order():
        block = packed[2 * layer][r0:r0 + o, c0:c0 + 16]
        want = block.reshape(o, 2, 8).permute(1, 0, 2).reshape(-1)
        assert torch.equal(stream[pos:pos + o * 16], want.view(torch.int16))
        pos += o * 16
    assert pos == stream.numel()
    # the head [h4, xf] and z's weights (kept in f32 beside the biases)
    assert torch.equal(image[fq.RECON_WIDE_HEAD_ELEM:], packed[8][0, :-1])
    z0 = fq.RECON_WIDE_BIAS_FLOATS
    assert torch.equal(vecs[z0:z0 + 1024], packed[0][:, -1].float())
