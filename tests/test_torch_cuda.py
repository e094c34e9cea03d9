"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
without a CUDA device). This file imports neither JAX nor the JAX package,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

K1's, K2's, K4's and K5's tolerances against their plain versions are
those of the CPU tests against the Pallas kernels
(tests/test_torch_fused_query.py, tests/test_torch_recon.py,
tests/test_torch_nerf.py): both versions sum bf16 products in f32 in
different orders, so a bf16 rounding of an activation can flip. K3 sums
S such samples per ray: 2e-2 at most, and the median within 1e-4 (the
flips stay rare), as chip_smoke.py holds it.
"""

import pytest
import torch

ATOL = {"occ": 5e-3, "alpha": 5e-3, "rgb": 5e-3, "offset": 5e-4}
K2_ATOL = 5e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def packed(card):
    from avatarcap_tpu_torch.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.tools.bench_workloads import random_avatar
    model = random_avatar(torch.Generator().manual_seed(0)).to(card)
    with torch.no_grad():
        return pack_fused_query_weights(model)


@pytest.fixture(scope="module")
def packed_recon(card):
    from avatarcap_tpu_torch.ops.fused_query import pack_recon_weights
    from avatarcap_tpu_torch.tools.bench_workloads import random_recon
    model = random_recon(torch.Generator().manual_seed(0)).to(card)
    with torch.no_grad():
        return pack_recon_weights(model.image_decoder)


def _inputs(n, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    pts = torch.rand((n, 3), generator=gen) * 1.6 - 0.8
    pf = torch.randn((n, 64), generator=gen)
    return pts.to(device), pf.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 129, 5000])
def test_k1_kernel_matches_plain(card, packed, n):
    from avatarcap_tpu_torch.ops.fused_query import (
        warp_template_query, warp_template_query_plain)
    pts, pf = _inputs(n, card, seed=n)
    before = warp_template_query.launches
    got = warp_template_query(packed["offset"], packed["template"], pts, pf)
    torch.cuda.synchronize()
    assert warp_template_query.launches == before + 1
    ref = warp_template_query_plain(packed["offset"], packed["template"],
                                    pts, pf)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].device.type == "cuda"
        torch.testing.assert_close(got[k], v, atol=ATOL[k], rtol=0)


@pytest.mark.cuda
def test_two_packed_sets_in_a_row(card, packed):
    """Two launches in a row on one stream with different packed sets (an
    avatar's and its texture avatar's): each must run on its own weight
    image, built once per set."""
    from avatarcap_tpu_torch.ops import fused_query as fq
    from avatarcap_tpu_torch.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.tools.bench_workloads import (random_avatar,
                                                           random_tex_avatar)
    avatar = random_avatar(torch.Generator().manual_seed(0))
    tex = random_tex_avatar(avatar, torch.Generator().manual_seed(2)).to(card)
    with torch.no_grad():
        packed_tex = pack_fused_query_weights(tex)
    pts, pf = _inputs(1000, card, seed=3)
    rays = _rays(200, 4, card, seed=4)
    kw = dict(n_samples=8, near=0.98, far=1.05, threshold=0.08)
    builds = fq.weight_image.builds
    got, got_rays = [], []
    for _ in range(2):                    # second round: cached images
        for pk in (packed, packed_tex):
            got.append(fq.warp_template_query(pk["offset"], pk["template"],
                                              pts, pf))
            got_rays.append(fq.ray_color_query(pk["offset"], pk["template"],
                                               *rays, **kw))
    torch.cuda.synchronize()
    assert fq.weight_image.builds <= builds + 2
    for i, pk in enumerate((packed, packed_tex, packed, packed_tex)):
        ref = fq.warp_template_query_plain(pk["offset"], pk["template"],
                                           pts, pf)
        for k, v in ref.items():
            # the other set's weights would be off by O(1); the bound is
            # chip_smoke.py's for K1, scaled for the texture avatar's
            # density row (~10x the geometry head's)
            atol = 4 * ATOL[k] * max(1.0, float(v.abs().max()))
            torch.testing.assert_close(got[i][k], v, atol=atol, rtol=0)
        ref_rays = fq.ray_color_query_plain(pk["offset"], pk["template"],
                                            *rays, **kw)
        assert float((got_rays[i] - ref_rays).abs().max()) <= 2e-2
    # the two sets differ (the density row), so a stale image would show
    assert float((got[0]["alpha"] - got[1]["alpha"]).abs().max()) > 0.1


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(card, packed, packed_recon):
    """Every launch of a kernel on the same inputs gives the same bits: a
    consumer warp that read a weight chunk before it had landed would not.
    Enough tiles for several waves over the card's SMs."""
    from avatarcap_tpu_torch.ops import fused_query as fq
    pts, pf = _inputs(400000, card, seed=5)
    feats = torch.cat([pts, pf], -1)
    recon_feats = torch.randn((400000, 33),
                              generator=torch.Generator().manual_seed(6))
    recon_feats = recon_feats.to(card)
    first = None
    for _ in range(4):
        out = [*fq.warp_template_query(packed["offset"], packed["template"],
                                       pts, pf).values(),
               *fq.template_query(packed["template"], pts),
               fq.offset_query(packed["offset"], feats),
               fq.recon_decode(packed_recon, recon_feats)]
        torch.cuda.synchronize()
        if first is None:
            first = out
        for a, b in zip(out, first):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_pose_features_repeat_bit_for_bit(card):
    """The U-Net's pose features at the capture size (256^2 x 6) are the
    same bits on every call: the avatar mesh of two frames drifted while
    cuDNN ran a non-deterministic transposed convolution."""
    from avatarcap_tpu_torch.pipeline.avatar import compute_pose_features
    from avatarcap_tpu_torch.tools.bench_workloads import random_avatar
    gen = torch.Generator().manual_seed(9)
    model = random_avatar(gen).to(card)
    pos_map = (torch.randn((1, 256, 256, 6), generator=gen) * 0.1).to(card)
    with torch.inference_mode():
        first = compute_pose_features(model, pos_map)
        for _ in range(3):
            torch.empty(1 << 26, device=card)      # another memory state
            assert torch.equal(compute_pose_features(model, pos_map), first)


@pytest.mark.cuda
def test_k1_empty_and_invalid_inputs(card, packed):
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    pts, pf = _inputs(0, card)
    before = warp_template_query.launches
    out = warp_template_query(packed["offset"], packed["template"], pts, pf)
    assert out["occ"].shape == (0, 1)
    assert warp_template_query.launches == before
    pts, pf = _inputs(10, card)
    f32_template = tuple(t.float() for t in packed["template"])
    with pytest.raises(ValueError):
        warp_template_query(packed["offset"], f32_template, pts, pf)
    with pytest.raises(ValueError):
        warp_template_query(packed["offset"], packed["template"], pts,
                            pf[:, :32])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 128, 129, 300, 5000, 200003])
def test_k2_kernel_matches_plain(card, packed_recon, n):
    """One tile, one tile and a point, ragged and large ragged point counts
    (the kernel's tile is 128 points); the flips stay rare: the median
    difference stays within 1e-4."""
    from avatarcap_tpu_torch.ops.fused_query import (recon_decode,
                                                     recon_decode_plain)
    gen = torch.Generator().manual_seed(n)
    feats = torch.randn((n, 33), generator=gen).to(card)
    before = recon_decode.launches
    got = recon_decode(packed_recon, feats)
    torch.cuda.synchronize()
    assert recon_decode.launches == before + 1
    ref = recon_decode_plain(packed_recon, feats)
    assert got.shape == (n,) and got.device.type == "cuda"
    torch.testing.assert_close(got, ref, atol=K2_ATOL, rtol=0)
    assert float((got - ref).abs().median()) <= 1e-4


@pytest.mark.cuda
def test_two_packed_recon_sets_in_a_row(card, packed_recon):
    """K2 launches in a row on one stream with two packed sets: each runs
    on its own weight image, built once per set."""
    from avatarcap_tpu_torch.ops import fused_query as fq
    from avatarcap_tpu_torch.tools.bench_workloads import random_recon
    model = random_recon(torch.Generator().manual_seed(7)).to(card)
    with torch.no_grad():
        other = fq.pack_recon_weights(model.image_decoder)
    feats = torch.randn((3000, 33),
                        generator=torch.Generator().manual_seed(8)).to(card)
    builds = fq.recon_weight_image.builds
    got = [fq.recon_decode(pk, feats)
           for pk in (packed_recon, other, packed_recon, other)]
    torch.cuda.synchronize()
    assert fq.recon_weight_image.builds <= builds + 2
    for g, pk in zip(got, (packed_recon, other, packed_recon, other)):
        torch.testing.assert_close(g, fq.recon_decode_plain(pk, feats),
                                   atol=K2_ATOL, rtol=0)
    # the two sets differ, so a stale image would show
    assert float((got[0] - got[1]).abs().max()) > 1e-2


@pytest.mark.cuda
def test_k2_empty_and_invalid_inputs(card, packed_recon):
    from avatarcap_tpu_torch.ops.fused_query import recon_decode
    before = recon_decode.launches
    assert recon_decode(packed_recon,
                        torch.zeros((0, 33), device=card)).shape == (0,)
    assert recon_decode.launches == before
    feats = torch.randn((10, 33), device=card)
    with pytest.raises(ValueError):              # weights on another device
        recon_decode(tuple(t.cpu() for t in packed_recon), feats)
    with pytest.raises(ValueError):
        recon_decode(packed_recon, feats[:, :32])
    with pytest.raises(ValueError):
        recon_decode(tuple(t.float() for t in packed_recon), feats)


@pytest.mark.cuda
def test_avatar_frame_on_card(card):
    """The avatar-only frame on a small subject: two K1 launches, and the
    same mesh size as the plain version on the CPU."""
    from avatarcap_tpu_torch.ops.fused_query import warp_template_query
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.tools.bench_workloads import (
        build_capture_grid, random_avatar, toy_avatar_statics)
    tris = {}
    for dev in (card, torch.device("cpu")):
        params, statics, v = toy_avatar_statics(dense=False, device=dev)
        grid, _ = build_capture_grid(statics, (48, 48, 32), pad_to=4096)
        gen = torch.Generator().manual_seed(1)
        cap = AvatarCapture(random_avatar(gen), statics, grid,
                            options=CaptureOptions(max_tris=1 << 15,
                                                   max_active=1 << 13,
                                                   render_res=128),
                            device=dev)
        item = {"live_smpl_v": v,
                "cano2live_jnt_mats": torch.eye(4).repeat(
                    params.num_joints, 1, 1),
                "smpl_pos_map": torch.randn((128, 128, 6), generator=gen)
                * 0.1}
        before = warp_template_query.launches
        res = cap.process_frame(item, w_recon=False, w_nerf=False)
        launches = warp_template_query.launches - before
        assert launches == (2 if dev.type == "cuda" else 0)
        assert torch.isfinite(res["live_mesh"].vertices).all()
        tris[dev.type] = int(res["cano_mesh"].num_tris)
    assert tris["cuda"] > 0
    assert abs(tris["cuda"] - tris["cpu"]) <= 0.01 * tris["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 5000])
def test_k4_k5_kernels_match_plain(card, packed, n):
    """K1's two halves on ragged point counts."""
    from avatarcap_tpu_torch.ops.fused_query import (
        offset_query, offset_query_plain, template_query,
        template_query_plain)
    pts, pf = _inputs(n, card, seed=n)
    feats = torch.cat([pts, pf], -1)
    before = (template_query.launches, offset_query.launches)
    got = template_query(packed["template"], pts)
    off = offset_query(packed["offset"], feats)
    torch.cuda.synchronize()
    assert (template_query.launches, offset_query.launches) == (
        before[0] + 1, before[1] + 1)
    ref = template_query_plain(packed["template"], pts)
    for g, r, k in zip(got, ref, ("rgb", "alpha", "occ")):
        assert g.shape == r.shape and g.device.type == "cuda"
        torch.testing.assert_close(g, r, atol=ATOL[k], rtol=0)
    torch.testing.assert_close(off, offset_query_plain(packed["offset"], feats),
                               atol=ATOL["offset"], rtol=0)


def _rays(n, n_anchors, device, seed):
    gen = torch.Generator().manual_seed(seed)
    base = torch.rand((n, 3), generator=gen) * 1.2 - 0.6
    nrm = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                        dim=-1)
    pf = torch.randn((2, n, 64), generator=gen).to(torch.bfloat16)
    danch = torch.rand((n, n_anchors), generator=gen) * 0.16
    bounds = torch.tensor([[-0.7, -0.7, -0.7], [0.7, 0.7, 0.7]])
    return [t.to(device) for t in (base + nrm, -nrm, pf[0], pf[1], danch,
                                   bounds)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_samples,n_anchors",
                         [(1, 2, 2), (300, 5, 3), (2000, 64, 4),
                          (333, 2, 16)])
def test_k3_kernel_matches_plain(card, packed, n, n_samples, n_anchors):
    """Ragged ray counts, sample counts that do not divide the tile, the
    shortest ray (2 samples) and the widest anchor block (16)."""
    from avatarcap_tpu_torch.ops.fused_query import (ray_color_query,
                                                     ray_color_query_plain)
    args = _rays(n, n_anchors, card, seed=n)
    kw = dict(n_samples=n_samples, near=0.98, far=1.05, threshold=0.08)
    before = ray_color_query.launches
    got = ray_color_query(packed["offset"], packed["template"], *args, **kw)
    torch.cuda.synchronize()
    assert ray_color_query.launches == before + 1
    ref = ray_color_query_plain(packed["offset"], packed["template"], *args,
                                **kw)
    assert got.shape == (n, 3) and got.device.type == "cuda"
    d = (got - ref).abs()
    assert float(d.max()) <= 2e-2 and float(d.median()) <= 1e-4
    assert bool((ref > 1e-3).any()) or n == 1


@pytest.mark.cuda
def test_k3_k4_k5_empty_and_invalid_inputs(card, packed):
    from avatarcap_tpu_torch.ops.fused_query import (
        offset_query, ray_color_query, template_query)
    kw = dict(n_samples=4, near=0.98, far=1.05, threshold=0.08)
    before = (ray_color_query.launches, template_query.launches,
              offset_query.launches)
    assert ray_color_query(packed["offset"], packed["template"],
                           *_rays(0, 4, card, 0), **kw).shape == (0, 3)
    assert template_query(packed["template"],
                          torch.zeros((0, 3), device=card))[0].shape == (0, 3)
    assert offset_query(packed["offset"],
                        torch.zeros((0, 67), device=card)).shape == (0, 3)
    assert (ray_color_query.launches, template_query.launches,
            offset_query.launches) == before
    rays = _rays(10, 4, card, 0)
    with pytest.raises(ValueError):
        ray_color_query(packed["offset"], packed["template"], *rays,
                        **dict(kw, n_samples=1))
    with pytest.raises(ValueError):
        ray_color_query(packed["offset"], packed["template"], *rays[:4],
                        torch.zeros((10, 17), device=card), rays[5], **kw)
    with pytest.raises(ValueError):
        template_query(tuple(t.float() for t in packed["template"]),
                       rays[0])
    with pytest.raises(ValueError):
        offset_query(packed["offset"], torch.zeros((10, 66), device=card))
