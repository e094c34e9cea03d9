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

from avatarcap_tpu_torch import kernels

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


@pytest.fixture(scope="module")
def packed_recon_wide(card):
    from avatarcap_tpu_torch.models.recon import PIFU_SHAPE_NETWORK
    from avatarcap_tpu_torch.ops.fused_query import pack_recon_weights
    from avatarcap_tpu_torch.tools.bench_workloads import random_recon
    model = random_recon(torch.Generator().manual_seed(0),
                         **PIFU_SHAPE_NETWORK).to(card)
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
    before = kernels.launches["k1"]
    got = warp_template_query(packed["offset"], packed["template"], pts, pf)
    torch.cuda.synchronize()
    assert kernels.launches["k1"] == before + 1
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
    before = kernels.launches["k1"]
    out = warp_template_query(packed["offset"], packed["template"], pts, pf)
    assert out["occ"].shape == (0, 1)
    assert kernels.launches["k1"] == before
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
    before = kernels.launches["k2"]
    got = recon_decode(packed_recon, feats)
    torch.cuda.synchronize()
    assert kernels.launches["k2"] == before + 1
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
    before = kernels.launches["k2"]
    assert recon_decode(packed_recon,
                        torch.zeros((0, 33), device=card)).shape == (0,)
    assert kernels.launches["k2"] == before
    feats = torch.randn((10, 33), device=card)
    with pytest.raises(ValueError):              # weights on another device
        recon_decode(tuple(t.cpu() for t in packed_recon), feats)
    with pytest.raises(ValueError):
        recon_decode(packed_recon, feats[:, :32])
    with pytest.raises(ValueError):
        recon_decode(tuple(t.float() for t in packed_recon), feats)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 128, 129, 300, 5000, 200003])
def test_k2w_kernel_matches_plain(card, packed_recon_wide, n):
    """K2w (PIFu's decoder) against its plain version at K2's tolerances:
    the same contract (bf16 operands, f32 sums in another order, so an
    activation's bf16 rounding can flip) over one tile, a tile and a
    point, ragged and large ragged counts; only K2w launches."""
    from avatarcap_tpu_torch.ops.fused_query import (recon_decode,
                                                     recon_decode_wide_plain)
    gen = torch.Generator().manual_seed(n)
    feats = torch.randn((n, 257), generator=gen).to(card)
    before = (kernels.launches["k2"], kernels.launches["k2w"])
    got = recon_decode(packed_recon_wide, feats)
    torch.cuda.synchronize()
    assert (kernels.launches["k2"], kernels.launches["k2w"]) == (
        before[0], before[1] + 1)
    ref = recon_decode_wide_plain(packed_recon_wide, feats)
    assert got.shape == (n,) and got.device.type == "cuda"
    torch.testing.assert_close(got, ref, atol=K2_ATOL, rtol=0)
    assert float((got - ref).abs().median()) <= 1e-4


@pytest.mark.cuda
def test_k2w_repeats_bit_for_bit(card, packed_recon_wide):
    """Every K2w launch on the same inputs gives the same bits (a race in
    the ring or on the h2 panel would not), over several waves."""
    from avatarcap_tpu_torch.ops.fused_query import recon_decode
    feats = torch.randn((200000, 257),
                        generator=torch.Generator().manual_seed(6)).to(card)
    first = recon_decode(packed_recon_wide, feats)
    for _ in range(3):
        assert torch.equal(recon_decode(packed_recon_wide, feats), first)


@pytest.mark.cuda
def test_k2w_empty_and_invalid_inputs(card, packed_recon_wide):
    from avatarcap_tpu_torch.ops.fused_query import recon_decode
    before = kernels.launches["k2w"]
    assert recon_decode(packed_recon_wide,
                        torch.zeros((0, 257), device=card)).shape == (0,)
    assert kernels.launches["k2w"] == before
    feats = torch.randn((10, 257), device=card)
    with pytest.raises(ValueError):              # weights on another device
        recon_decode(tuple(t.cpu() for t in packed_recon_wide), feats)
    with pytest.raises(ValueError):
        recon_decode(packed_recon_wide, feats[:, :33])
    with pytest.raises(ValueError):
        recon_decode(tuple(t.float() for t in packed_recon_wide), feats)


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
        before = kernels.launches["k1"]
        res = cap.process_frame(item, w_recon=False, w_nerf=False)
        launches = kernels.launches["k1"] - before
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
    before = (kernels.launches["k4"], kernels.launches["k5"])
    got = template_query(packed["template"], pts)
    off = offset_query(packed["offset"], feats)
    torch.cuda.synchronize()
    assert (kernels.launches["k4"], kernels.launches["k5"]) == (
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
    before = kernels.launches["k3"]
    got = ray_color_query(packed["offset"], packed["template"], *args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches["k3"] == before + 1
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
    before = (kernels.launches["k3"], kernels.launches["k4"],
              kernels.launches["k5"])
    assert ray_color_query(packed["offset"], packed["template"],
                           *_rays(0, 4, card, 0), **kw).shape == (0, 3)
    assert template_query(packed["template"],
                          torch.zeros((0, 3), device=card))[0].shape == (0, 3)
    assert offset_query(packed["offset"],
                        torch.zeros((0, 67), device=card)).shape == (0, 3)
    assert (kernels.launches["k3"], kernels.launches["k4"],
            kernels.launches["k5"]) == before
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


@pytest.fixture(scope="module")
def train_env(card):
    from avatarcap_tpu_torch.tools.bench_train import SMALL
    from avatarcap_tpu_torch.tools.bench_workloads import build_train_env
    return build_train_env(device=card, **SMALL)


@pytest.mark.cuda
def test_train_step_card_matches_cpu(card):
    """A small train step (batch 2, 32 rays x 8 samples, 128^2 maps) on
    the card and on the CPU from one state_dict with the same jitter:
    losses, gradients and parameters after the step within the
    tolerances of tools/bench_train (it raises otherwise)."""
    from avatarcap_tpu_torch.tools.bench_train import (CPU_GRAD_RTOL,
                                                       card_against_cpu)
    rec = card_against_cpu(card)
    assert rec["grad_rel_err_whole"] <= CPU_GRAD_RTOL


@pytest.mark.cuda
def test_epoch0_freeze_on_card(card, train_env):
    """lrs [1e-3, 0]: the warp field's parameters keep their bits, the
    template's and the BatchNorm statistics move."""
    from avatarcap_tpu_torch.tools.bench_train import epoch0_policy
    rec = epoch0_policy(train_env, card)
    assert rec["warp_params_bit_equal"] > 0


@pytest.mark.cuda
def test_finetune_keeps_warp_on_card(card, train_env):
    """Two finetune steps: the warp field's parameters keep their bits,
    the template's move, the losses stay finite."""
    from avatarcap_tpu_torch.tools.bench_train import finetune_steps
    rec = finetune_steps(train_env, card)
    assert len(rec["step_ms"]) == 2


@pytest.mark.cuda
def test_mesh_train_step_on_card_matches_one_device(card):
    """The small train step over two replicas on the card against the
    one-device step on the card from one state and generator (losses rtol
    1e-4, parameters by the step rule), the replicas bit-equal after 3
    steps, the epoch-0 freeze and a finetune step over the mesh
    (tools/bench_train.mesh_steps raises otherwise)."""
    from avatarcap_tpu_torch.parallel.mesh import make_mesh
    from avatarcap_tpu_torch.tools.bench_train import SMALL, mesh_steps
    from avatarcap_tpu_torch.tools.bench_workloads import build_train_env
    env = build_train_env(device=card, **SMALL)
    rec = mesh_steps(env, make_mesh([card] * 2), n_steps=2)
    assert rec["replicas_differ_after_3"] == []
    assert rec["busy_share"]["kernels"] > 0


@pytest.fixture(scope="module")
def cli_subject(card, tmp_path_factory):
    """A subject written by the port's writer (on the CPU) on the toy body
    at 3,202 vertices, its SMPL pkl and a random ReconNet checkpoint."""
    import numpy as np
    from avatarcap_tpu_torch.body.smpl import canonical_pose
    from avatarcap_tpu_torch.tools.bench_workloads import random_recon
    from avatarcap_tpu_torch.tools.gen_synthetic import generate_subject
    from avatarcap_tpu_torch.utils.toy_body import (make_toy_smpl_params,
                                                    write_smpl_pkl)
    root = tmp_path_factory.mktemp("cli_card")
    params = make_toy_smpl_params(n_lat=42, n_lon=80)
    (root / "smpl").mkdir()
    write_smpl_pkl(params, str(root / "smpl" /
                               "basicmodel_m_lbs_10_207_0_v1.0.0.pkl"))
    pose = canonical_pose().copy()
    pose[6:] += np.random.RandomState(0).uniform(
        -0.2, 0.2, pose.size - 6).astype(np.float32)
    generate_subject(str(root / "subject"), params, np.zeros(10, np.float32),
                     pose[None], n_views=1, img_size=128, pos_map_res=128,
                     sur_pts_count=1000, vol_pts_count=100, device="cpu")
    (root / "recon").mkdir()
    torch.save(random_recon(torch.Generator().manual_seed(1)).state_dict(),
               str(root / "recon" / "recon_net.pt"))
    return root, params


@pytest.mark.cuda
def test_test_grid_on_card_equals_cpu(card, cli_subject):
    """The dataset's test-mode grid (KNN band, inside prior, compaction)
    built on the card equals the CPU's."""
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset
    root, params = cli_subject
    grids = [AvatarCapDataset(str(root / "subject"), training=False,
                              smpl_params=params, vol_res=(96, 96, 48),
                              device=dev) for dev in (card, "cpu")]
    assert grids[0].valid_pts.device.type == "cuda"
    assert grids[0].num_valid_pts == grids[1].num_valid_pts > 0
    for name in ("infer_pts_flag", "valid_pts_idx", "prior_volume",
                 "valid_pts"):
        a, b = (getattr(g, name).cpu() for g in grids)
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.cuda
def test_cli_frame_on_card_matches_cpu(card, cli_subject, tmp_path):
    """run_avatarcap's textured frame through the kernels, on the card
    and (their plain versions) on the CPU: the triangle counts within 1%,
    as chip_smoke.py's small frames."""
    import yaml
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.config import load_config
    root, _ = cli_subject
    cfg = {"training": {"training_data_dir": str(root / "subject")},
           "testing": {"vol_res": [64, 64, 32],
                       "testing_data_dir": str(root / "subject"),
                       "recon_net_ckpt": str(root / "recon"),
                       "render_res": 128,
                       "capture_options": {
                           "max_tris": 1 << 15, "max_active": 1 << 13,
                           "refine_capacity": 1 << 16,
                           "nerf_unique_capacity": 1 << 14,
                           "recon_unique_capacity": 1 << 14,
                           "recon_color_mode": "direct", "n_samples": 16,
                           "fusion_iters": 10}},
           "smpl_model_dir": str(root / "smpl")}
    records = {}
    for dev in ("cuda", "cpu"):
        cfg["testing"]["output_dir"] = str(tmp_path / dev)
        path = str(tmp_path / f"{dev}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        (records[dev],) = cli.run_avatarcap(
            load_config(path), w_nerf=True, save_avatar_mesh=True,
            save_final_mesh=True, frame_idx=0, device=dev)
    for key in ("num_tris", "recon_num_tris"):
        a, b = records["cuda"][key], records["cpu"][key]
        assert b > 0 and abs(a - b) <= 0.01 * b, (key, a, b)
    for dev in ("cuda", "cpu"):
        assert (tmp_path / dev / "0000_recon.ply").exists()


def _small_capture(device, **extra):
    """The small textured production subject of chip_smoke.py's card-vs-CPU
    phase (48 x 48 x 32 grid, 128^2 renders, the capture workload's
    texture options) on ``device``, and 3 items of distinct poses."""
    import numpy as np
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.tools.bench_workloads import (
        SMALL_CAPTURE_OPTIONS, bench_camera, build_capture_grid,
        random_avatar, random_recon, random_tex_avatar, toy_avatar_statics)
    params, statics, v = toy_avatar_statics(dense=False, device=device)
    grid, _ = build_capture_grid(statics, (48, 48, 32), pad_to=4096)
    gen = torch.Generator().manual_seed(1)
    avatar = random_avatar(gen)
    cap = AvatarCapture(avatar, statics, grid,
                        recon=random_recon(torch.Generator().manual_seed(2)),
                        tex_avatar=random_tex_avatar(
                            avatar, torch.Generator().manual_seed(3)),
                        options=CaptureOptions(**SMALL_CAPTURE_OPTIONS),
                        device=device,
                        **extra)
    w2c, camera, normal = bench_camera(128)
    rs = np.random.RandomState(0)
    items = []
    for k in range(3):
        jm = np.tile(np.eye(4, dtype=np.float32), (params.num_joints, 1, 1))
        jm[:, :3, 3] = rs.uniform(-0.05, 0.05, (params.num_joints, 3))
        items.append({"live_smpl_v": v.astype(np.float32),
                      "cano2live_jnt_mats": jm, "w2c_RT": w2c,
                      "smpl_pos_map": (rs.standard_normal((128, 128, 6))
                                       * 0.1).astype(np.float32)})
    kw = dict(inferred_normal=normal, neck_vertex_idx=0, camera=camera)
    return cap, items, kw


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _same_bits(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.cuda
def test_frame_body_makes_no_host_sync(card):
    """The sync-free compaction, and frame_body in its three forms after
    a warm-up frame, under torch.cuda.set_sync_debug_mode("error"): any
    call that makes the host wait for the card raises."""
    from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
    cap, items, kw = _small_capture(card)
    mask = torch.rand(100000, device=card) < 0.3
    forms = [dict(w_recon=False, w_nerf=False),
             dict(w_recon=True, w_nerf=False),
             dict(w_recon=True, w_nerf=True)]
    for form in forms:
        cap.process_frame(items[0], **form, **kw)
    frame, jnt, normal, w2c = cap.upload(items[1], kw["inferred_normal"])
    neck = cap._neck_xy(kw["neck_vertex_idx"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, count, _ = compact_mask_indices(mask, 20000)
        for form in forms:
            cap.frame_body(frame, jnt, normal, w2c, kw["camera"], neck,
                           **form)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = torch.nonzero(mask)[:, 0][:20000].to(torch.int32)
    assert int(count) == int(mask.sum())
    assert torch.equal(idx, ref)


@pytest.mark.cuda
def test_run_pipelined_equals_process_frame_on_card(card):
    """3 distinct poses of the textured production frame, streamed with
    lookahead 2 and one by one: the same bits."""
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    cap, items, kw = _small_capture(card)
    loop = [cap.process_frame(it, w_recon=True, w_nerf=True, **kw)
            for it in items]
    sc = StreamingCapture(cap, make_mesh([card]), camera=kw["camera"],
                          image_size=(128, 128), w_recon=True, w_nerf=True)
    streamed = sc.run_pipelined(items, [kw["inferred_normal"]] * 3,
                                lookahead=2)
    assert all(_same_bits(a, b) for a, b in zip(loop, streamed))
    assert int(loop[0]["cano_mesh"].num_tris) > 0


@pytest.mark.cuda
def test_two_slab_sharded_frame_equals_unsharded_on_card(card):
    """AvatarCapture(shard_mesh=[cuda:0, cuda:0]): both grid queries in
    two slabs on one card. Each point's kernel arithmetic does not depend
    on its tile, so the textured production frame keeps its bits."""
    cap, items, kw = _small_capture(card)
    ref = cap.process_frame(items[0], w_recon=True, w_nerf=True, **kw)
    dev = torch.device("cuda", torch.cuda.current_device())
    sharded, _, _ = _small_capture(card, shard_mesh=[dev, dev])
    got = sharded.process_frame(items[0], w_recon=True, w_nerf=True, **kw)
    assert _same_bits(got, ref)


def _small_subject(device, **options):
    from avatarcap_tpu_torch.tools.bench_workloads import (
        SMALL_CAPTURE_OPTIONS, SMALL_SUBJECT, build_capture_subject)
    return build_capture_subject(
        device, options=dict(SMALL_CAPTURE_OPTIONS, **options), fit=False,
        **SMALL_SUBJECT)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mc_edge", "sobel_sample"])
def test_normal_modes_on_card_match_cpu(card, mode):
    """The production frame with the Sobel normal modes on the small
    subject, card against CPU at chip_smoke.py's [small] tolerances
    (triangles within 1%, 99% of the avatar and merged normal pixels
    within 1e-2), two K1 and two K2 launches, and frame_body free of host
    syncs under set_sync_debug_mode("error")."""
    from avatarcap_tpu_torch.ops.fused_query import (recon_decode,
                                                     warp_template_query)
    out = {}
    for dev in (card, torch.device("cpu")):
        cap, item, kw, _ = _small_subject(dev, normal_mode=mode)
        k1, k2 = kernels.launches["k1"], kernels.launches["k2"]
        out[dev.type] = cap.process_frame(item, w_recon=True, **kw)
        if dev.type == "cuda":
            assert (kernels.launches["k1"] - k1,
                    kernels.launches["k2"] - k2) == (2, 2)
            frame, jnt, normal, w2c = cap.upload(item, kw["inferred_normal"])
            neck = cap._neck_xy(kw["neck_vertex_idx"])
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                cap.frame_body(frame, jnt, normal, w2c, kw["camera"], neck)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    a, b = out["cuda"], out["cpu"]
    for key in ("cano_mesh", "recon_mesh"):
        ta, tb = int(a[key].num_tris), int(b[key].num_tris)
        assert ta > 0 and abs(ta - tb) <= 0.01 * tb, key
    for key in ("front_avatar_normal", "front_merged_normal"):
        close = (a[key].cpu() - b[key]).abs().max(-1).values < 1e-2
        assert float(close.float().mean()) >= 0.99, key
    assert torch.isfinite(a["cano_mesh"].normals).all()


@pytest.mark.cuda
def test_fit_step_on_card_matches_cpu(card):
    """One template fit step and one decoder fit step on the card against
    the CPU from the same weights and points: losses within 1e-4
    relative; Adam's first step moves each weight by ~lr whatever its
    gradient's size, so an entry whose gradient is float32 noise may move
    the other way: every entry within 2 lr, 99% within 0.1 lr."""
    from avatarcap_tpu_torch.ops.adam import Adam
    from avatarcap_tpu_torch.tools import bench_workloads as bw
    _, statics, _ = bw.toy_avatar_statics(dense=False)
    grid, _ = bw.build_capture_grid(statics, (48, 48, 32), pad_to=4096)
    inferred = bw.bench_camera(128)[2]
    pts = bw.template_fit_points(statics, 4096,
                                 torch.Generator().manual_seed(0))
    idx = bw.recon_fit_indices(grid.valid_pts.shape[0], 4096,
                               torch.Generator().manual_seed(1))
    out = {}
    for dev in (card, torch.device("cpu")):
        st, g = statics.to(dev), grid.to(dev)
        avatar = bw.random_avatar(torch.Generator().manual_seed(0)).to(dev)
        recon = bw.random_recon(torch.Generator().manual_seed(1)).to(dev)
        lt = bw.template_fit_step(
            avatar, Adam(list(avatar.cano_template.parameters())), st,
            pts.to(dev), wrinkle_amp=0.006)
        feats = bw.recon_fit_features(recon, st, g, inferred)
        i = idx.to(dev)
        ld = bw.recon_fit_step(
            recon, Adam(list(recon.image_decoder.parameters())), st,
            feats[i], g.valid_pts[i], wrinkle_amp=0.006)
        out[dev.type] = (float(lt), float(ld), [
            p.detach().cpu() for p in list(avatar.cano_template.parameters())
            + list(recon.image_decoder.parameters())])
    (lt_a, ld_a, pa), (lt_b, ld_b, pb) = out["cuda"], out["cpu"]
    assert abs(lt_a - lt_b) <= 1e-4 * lt_b and abs(ld_a - ld_b) <= 1e-4 * ld_b
    d = torch.cat([(x - y).abs().reshape(-1) for x, y in zip(pa, pb)])
    assert float(d.max()) <= 2e-3
    assert float((d <= 1e-4).float().mean()) >= 0.99


def _sphere_cloud(n, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    p = rng.standard_normal((n, 3)).astype(np.float32)
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    p = p[p[:, 2] < 0.85]                       # a hole at the cap
    pts = 0.5 * p + 0.005 * rng.standard_normal(p.shape).astype(np.float32)
    return pts.astype(np.float32), p


@pytest.mark.cuda
def test_poisson_splat_repeats_bit_for_bit(card):
    """The splat's scatter-add is deterministic on the card: the screened
    solve at 128^3, run twice, gives the same soup's bits (an atomic
    float32 accumulate would move iso-crossings from run to run); and it
    agrees with the CPU in triangles within 1%."""
    from avatarcap_tpu_torch.ops.poisson import _splat, poisson_reconstruct
    pts, nrm = _sphere_cloud(200000, seed=0)
    runs = [poisson_reconstruct(pts, nrm, res=128, pad=0.15, device=card)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1] > 10000
    assert runs[0][0].tobytes() == runs[1][0].tobytes()
    _, nt_cpu = poisson_reconstruct(pts, nrm, res=128, pad=0.15,
                                    device="cpu")
    assert abs(runs[0][1] - nt_cpu) <= 0.01 * nt_cpu
    f = torch.rand((1 << 20, 3), generator=torch.Generator().manual_seed(1))
    f = (f * 62.999).to(card)          # corners up to node 63 of 64
    i0 = f.floor().long()
    vals = torch.randn((1 << 20, 3), device=card)
    a = _splat(vals, i0, f - i0, 64)
    b = _splat(vals, i0, f - i0, 64)
    assert torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.cuda
def test_bvh_agrees_with_card_signed_distance(card):
    """The host BVH and the card's signed_distance (KNN candidates +
    exact projection, ray-parity sign) on points near a closed mesh: the
    magnitudes within 1e-5, the signs on 99.9%."""
    import numpy as np
    from avatarcap_tpu_torch.native import MeshBVH
    from avatarcap_tpu_torch.ops.closest_point import signed_distance
    from avatarcap_tpu_torch.utils.toy_body import make_toy_smpl_params
    body = make_toy_smpl_params(n_lat=77, n_lon=90)
    verts, faces = body.v_template, body.faces
    rng = np.random.RandomState(2)
    tri = verts[faces[rng.randint(0, len(faces), 65536)]]
    w = rng.dirichlet(np.ones(3), 65536)[..., None]
    q = ((tri * w).sum(1) + 0.02 * rng.standard_normal((65536, 3))
         ).astype(np.float32)
    ref = MeshBVH(verts, faces).signed_distance(q)
    sdf, _ = signed_distance(torch.as_tensor(q, device=card),
                             torch.as_tensor(verts, device=card),
                             torch.as_tensor(faces, device=card))
    sdf = sdf.cpu().numpy()
    assert np.abs(np.abs(sdf) - np.abs(ref)).max() <= 1e-5
    assert (np.sign(sdf) == np.sign(ref)).mean() >= 0.999


@pytest.mark.cuda
def test_generator_on_card_matches_cpu(card):
    """A GlobalGenerator at the reference's define_G widths (64, 4 down,
    9 blocks) on a 256^2 input, on the card and on the CPU, under
    f32_convolutions: within 1e-3, and the card repeats its bits."""
    from avatarcap_tpu_torch.tools.bench_preprocess import random_generator
    gen = random_generator(seed=0)
    x = torch.rand((1, 3, 256, 256),
                   generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        ref = gen(x)
        gen_card = gen.to(card)
        got = gen_card(x.to(card))
        again = gen_card(x.to(card))
    assert torch.equal(got, again)
    assert float((got.cpu() - ref).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_occupancy_query_fused_on_card_matches_plain(card):
    """query_occupancy_fused of an occupancy avatar on the card (the
    per-point fetch, one K1 launch, the sigmoid after it) against its
    plain version (the same fetch, K1's plain version, the sigmoid) at
    K1's tolerances; values in (0, 1) on both sides of 0.5."""
    from avatarcap_tpu_torch.ops.fused_query import (
        warp_template_query, warp_template_query_plain)
    from avatarcap_tpu_torch.ops.grid_sample import (
        sample_feature_map_at_points)
    from avatarcap_tpu_torch.pipeline.avatar import (pack_fused_query_weights,
                                                     query_occupancy_fused)
    from avatarcap_tpu_torch.tools.bench_workloads import (random_avatar,
                                                           toy_avatar_statics)
    model = random_avatar(torch.Generator().manual_seed(5),
                          if_type="occupancy").to(card)
    _, statics, _ = toy_avatar_statics(dense=False, device=card)
    gen = torch.Generator().manual_seed(6)
    pts = (statics.cano_smpl_center.cpu()
           + torch.rand((1, 20000, 3), generator=gen) * 0.8 - 0.4).to(card)
    feat = torch.randn((1, 128, 128, 64), generator=gen).to(card)
    with torch.no_grad():
        pk = pack_fused_query_weights(model)
        before = kernels.launches["k1"]
        got = query_occupancy_fused(pk, pts, feat, statics)
        torch.cuda.synchronize()
        assert kernels.launches["k1"] == before + 1
        pf = sample_feature_map_at_points(feat.permute(0, 3, 1, 2),
                                          pts - statics.cano_smpl_center)
        ref = warp_template_query_plain(pk["offset"], pk["template"], pts[0],
                                        pf[0])
    assert pk["if_type"] == "occupancy"
    occ = got["cano_pts_ov"][0]
    torch.testing.assert_close(occ, torch.sigmoid(ref["occ"]),
                               atol=ATOL["occ"], rtol=0)
    torch.testing.assert_close(got["nonrigid_offset"][0], ref["offset"],
                               atol=ATOL["offset"], rtol=0)
    assert 0.0 < float(occ.min()) < 0.5 < float(occ.max()) < 1.0


@pytest.mark.cuda
def test_other_encodings_f32_frame_on_card_matches_cpu(card):
    """An avatar of positional encodings (8, 2) (the kernels take (10, 0)
    only) through the f32 module path's avatar-only frame on the small
    subject, card against CPU at chip_smoke.py's [small] tolerances; its
    kernel path refuses it."""
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    from avatarcap_tpu_torch.tools.bench_workloads import random_avatar
    model = random_avatar(torch.Generator().manual_seed(8),
                          pos_encoding_template=8, pos_encoding_warp=2)
    out = {}
    for dev in (card, torch.device("cpu")):
        cap, item, _, _ = _small_subject(dev, use_fused_query=False)
        cap = AvatarCapture(model, cap.statics, cap.grid, options=cap.opt,
                            device=dev)
        out[dev.type] = cap.process_frame(item, w_recon=False)
    with pytest.raises(ValueError, match="use_fused_query=False"):
        AvatarCapture(model, cap.statics, cap.grid, device="cpu")
    a, b = out["cuda"], out["cpu"]
    ta, tb = int(a["cano_mesh"].num_tris), int(b["cano_mesh"].num_tris)
    assert ta > 0 and abs(ta - tb) <= 0.01 * tb
    close = (a["front_avatar_normal"].cpu()
             - b["front_avatar_normal"]).abs().max(-1).values < 1e-2
    assert float(close.float().mean()) >= 0.99


@pytest.mark.cuda
def test_hgfilter_forms_on_card_match_cpu(card):
    """HGFilter with 2x average pooling, two stacks and the tanh output
    (depth 4, 256^2 input) on the card and on the CPU under
    f32_convolutions: within 1e-3."""
    from avatarcap_tpu_torch.models.hourglass import HGFilter
    from avatarcap_tpu_torch.models.layers import f32_convolutions
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        net = HGFilter(depth=4, in_ch=6, last_ch=32, down_type="ave_pool",
                       n_stack=2, use_sigmoid=True)
    x = torch.randn((1, 6, 256, 256),
                    generator=torch.Generator().manual_seed(12))
    with torch.no_grad(), f32_convolutions():
        ref, ref_normx = net(x)
        got, got_normx = net.to(card)(x.to(card))
    assert len(got) == 2 and got[1].shape == (1, 32, 64, 64)
    for g, r in zip(got + [got_normx], ref + [ref_normx]):
        assert float((g.cpu() - r).abs().max()) <= 1e-3


def _merge_pair(card, side, seed=0):
    from avatarcap_tpu_torch.tools.bench_kernels import merge_inputs
    return tuple(torch.as_tensor(a).to(card)
                 for a in merge_inputs(side, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("side", [512, 301])
@pytest.mark.parametrize("iter_num", [100, 7, 0])
@pytest.mark.parametrize("face_box", ["applied", "no-op", "outside"])
def test_merge_kernel_matches_plain(card, side, iter_num, face_box):
    """csrc/normal_merge.cu against merge_normal_images_plain (autograd)
    on the card (bench_kernels.merge_agreement), at test_merge_matches_jax's
    bounds: every pixel within 1e-3, 99% of them within 1e-4; at the
    capture's 512^2, equal to the bit (the kernel follows the plain path's
    rounding, and cuBLAS's K order at that size). The face box is applied
    (neck 40 pixels above the middle), a no-op (neck_y < 90) or past the
    image's edge (an empty slice).

    Bit equality is what the benchmark's merge_gap needs: Adam's first
    steps turn gradients near its eps (1e-8) into steps of lr, so a one-ulp
    change of the avatar normals moves a few pixels of the plain path's own
    result by up to 5.6e-3 on these pairs (PERF.md, section 6)."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    from avatarcap_tpu_torch.tools.bench_kernels import merge_agreement
    src, tar = _merge_pair(card, side, seed=side + iter_num)
    neck = {"applied": (side // 2, side // 2 - 40), "no-op": (side // 2, 60),
            "outside": (side + 50, side + 100)}[face_box]
    got = nf.merge_normal_images(src, tar, neck, iter_num)
    assert got.shape == src.shape and got.device.type == "cuda"
    if iter_num:
        assert float((got - src).abs().max()) > 1e-2     # the merge moved
    rec = merge_agreement(src, tar, neck, iter_num)
    assert rec["ok"], rec
    assert rec["bitwise"] or side != 512, rec
    x, y = neck
    box = (slice(y - 90, y), slice(x - 35, x + 35))
    if face_box == "applied":
        assert torch.equal(got[box], src[box])


@pytest.mark.cuda
def test_merge_kernel_repeats_bit_for_bit_without_sync(card):
    """Two calls at the frame's shapes give the same bits (the adjoint
    gathers in a fixed order, no atomics); the second runs under
    torch.cuda.set_sync_debug_mode("error"); each call is one launch, and
    under a tracer one ``merge_kernel`` span with the H x H pixels as
    ``rows`` and the valid ones as ``live``."""
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    from avatarcap_tpu_torch.utils.timers import Tracer
    src, tar = _merge_pair(card, 512)
    neck = (256, 216)
    first = nf.merge_normal_images(src, tar, neck)
    before = kernels.launches["merge"]
    tracer = Tracer(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with tracer("merge"):
            second = nf.merge_normal_images(src, tar, neck)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launches["merge"] == before + 1
    assert torch.equal(first, second)
    _, valid, n_pixels, _ = nf._merge_masks(src, tar)
    spans = [s for s in tracer.collect() if s.name == "merge_kernel"]
    assert len(spans) == 1
    assert spans[0].counts == {"rows": 512 * 512, "live": int(n_pixels)}


@pytest.mark.cuda
@pytest.mark.parametrize("iter_num,neck", [(4, (64, 120)), (20, (64, 120)),
                                           (4, (64, 50)), (100, (64, 120))],
                         ids=["4_iters", "20_iters", "face_box_noop",
                              "100_iters"])
def test_merge_kernel_matches_jax(card, iter_num, neck):
    """csrc/normal_merge.cu on test_merge_matches_jax's inputs against the
    JAX package's merge on them (tests/fixtures/merge_jax.npz, computed on
    the CPU; tests/test_torch_fusion.py holds the file to the JAX package),
    at that test's bounds: every pixel within 1e-3, 99% of them within
    1e-4, the face box kept where it lies inside the image."""
    import numpy as np
    from merge_cases import case_name, load_jax_fixture, merge_inputs
    from avatarcap_tpu_torch.fusion import normal_fusion as nf
    src, tar = merge_inputs()
    ref = load_jax_fixture()[case_name(iter_num, neck)]
    before = kernels.launches["merge"]
    with torch.inference_mode():            # as the capture frame calls it
        got = nf.merge_normal_images(torch.as_tensor(src).to(card),
                                     torch.as_tensor(tar).to(card), neck,
                                     iter_num=iter_num)
    assert kernels.launches["merge"] == before + 1
    got = got.cpu().numpy()
    assert np.all(np.isfinite(got))
    # the merge moved pixels by more than the bound, so returning the
    # input cannot pass (6.2e-3 after 100 steps: the rotation grid then
    # explains most of the tilt, and the merged normals stay near src)
    assert np.abs(ref - src).max() > 2e-3
    d = np.abs(got - ref).max(-1)
    assert d.max() <= 1e-3, d.max()
    assert (d <= 1e-4).mean() >= 0.99, (d <= 1e-4).mean()
    x, y = neck
    box = np.s_[max(y - 90, 0):y, max(x - 35, 0):x + 35]
    if y >= 90:
        np.testing.assert_array_equal(got[box], src[box])
    else:
        assert np.abs(got[box] - src[box]).max() > 1e-2


def _knn_agreement(q, v, chunk=16384):
    """csrc/nearest_vertex.cu (ops/knn.nearest_vertex) against knn_plain
    on the same card: d2 rows whose bits differ, indices that differ where
    the plain tile's minimum is unique, and rows tied at the minimum whose
    kernel index is not the first tied one."""
    from avatarcap_tpu_torch.ops import knn as K
    d, i = K.nearest_vertex(q, v)
    d_ref, i_ref = K.knn_plain(q, v, 1, chunk)
    assert d.shape == d_ref.shape and i.shape == i_ref.shape
    assert i.dtype == torch.int64 and d.dtype == torch.float32
    rec = {"d2_bits": int((d.view(torch.int32)
                           != d_ref.view(torch.int32)).sum()),
           "idx_unique": 0, "idx_tied": 0, "tied_rows": 0}
    v_sq = (v * v).sum(-1)
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk]
        tile = (qc * qc).sum(-1, keepdim=True) - 2.0 * (qc @ v.T) + v_sq
        low = tile == tile.min(-1, keepdim=True).values
        tied = low.sum(-1) > 1
        differ = (i[s:s + chunk] != i_ref[s:s + chunk])[:, 0]
        first = low.int().argmax(-1)
        rec["idx_unique"] += int((differ & ~tied).sum())
        rec["idx_tied"] += int((tied & (i[s:s + chunk, 0] != first)).sum())
        rec["tied_rows"] += int(tied.sum())
    return rec


def _body(card):
    from avatarcap_tpu_torch.tools.bench_workloads import toy_avatar_statics
    return toy_avatar_statics(dense=True, device=card)[1].cano_smpl_vertices


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 127, 128, 129, 5000, 200003])
def test_knn_kernel_matches_plain_on_random_points(card, n):
    """Points in and around the body's box against its 6,842 vertices:
    the plain path's bits in d2, its index everywhere (the first of tied
    minima, torch.min's choice); one launch a call."""
    from avatarcap_tpu_torch.ops import knn as K
    gen = torch.Generator().manual_seed(n)
    v = _body(card)
    q = ((torch.rand((n, 3), generator=gen) * 2.2 - 1.1).to(card)
         + v.mean(0))
    before = kernels.launches["knn"]
    rec = _knn_agreement(q, v)
    assert kernels.launches["knn"] == before + 1
    assert rec == {"d2_bits": 0, "idx_unique": 0, "idx_tied": 0,
                   "tied_rows": rec["tied_rows"]}, rec


@pytest.mark.cuda
def test_knn_kernel_single_query_and_single_point(card):
    """N = 1 and M = 1. For one query row (or one database point) cuBLAS
    takes a matrix-vector kernel that sums q.v in another order than its
    GEMM (on an H100, 2,174 of a row's 6,752 products with random points
    differ in the last bit), so the plain path's own result moves with the
    row count; the kernel's is the GEMM's, which knn_plain gives with the
    row doubled, or with far points added to the database."""
    from avatarcap_tpu_torch.ops import knn as K
    gen = torch.Generator().manual_seed(1)
    v = _body(card)
    for n in range(8):
        q = (torch.rand((1, 3), generator=gen) * 2 - 1).to(card) + v.mean(0)
        d, i = K.nearest_vertex(q, v)
        d_ref, i_ref = K.knn_plain(q.repeat(2, 1), v, 1)
        assert torch.equal(d, d_ref[:1]) and torch.equal(i, i_ref[:1])
        d_b, i_b = K.nearest_vertex(torch.cat([q, v[:5]]), v)
        assert torch.equal(d_b[:1], d) and torch.equal(i_b[:1], i)
    q = (torch.rand((3000, 3), generator=gen) * 2 - 1).to(card)
    d, i = K.nearest_vertex(q, v[7:8].contiguous())
    far = torch.cat([v[7:8], v + 100.0])
    d_ref, i_ref = K.knn_plain(q, far, 1)
    assert torch.equal(d, d_ref) and not i.any() and not i_ref.any()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [7169, 20000])
def test_knn_kernel_streams_a_database_above_one_stage(card, m):
    """Databases of more than one stage of the kernel (kStageVertices
    points; a last stage of one point; three stages) against knn_plain,
    with ties from repeated points across stages."""
    assert m > kernels.source_constants("nearest_vertex.cu")["kStageVertices"]
    gen = torch.Generator().manual_seed(m)
    v = torch.rand((m, 3), generator=gen) * 2 - 1
    v[-300:] = v[:300]                  # the same points in the last stage
    q = torch.rand((50001, 3), generator=gen) * 2.2 - 1.1
    q[:300] = v[:300]                   # d2 = 0 at two indices
    rec = _knn_agreement(q.to(card), v.to(card))
    assert rec["tied_rows"] >= 300, rec
    assert rec == {"d2_bits": 0, "idx_unique": 0, "idx_tied": 0,
                   "tied_rows": rec["tied_rows"]}, rec


@pytest.mark.cuda
def test_knn_kernel_keeps_the_first_of_duplicated_vertices(card):
    """The body's vertices twice and a third copy of some: every query's
    minimum is tied, and the kernel returns the first index, as
    knn_plain's min does; on a grid, queries at cell centres are tied
    between eight corners."""
    from avatarcap_tpu_torch.ops import knn as K
    v = _body(card)
    dup = torch.cat([v, v, v[1000:2000]])
    gen = torch.Generator().manual_seed(5)
    q = (v[torch.randint(0, v.shape[0], (100000,), generator=gen)
           .to(card)] + torch.randn((100000, 3), generator=gen).to(card)
         * 0.03)
    rec = _knn_agreement(q, dup)
    assert rec["tied_rows"] == 100000, rec
    assert rec["d2_bits"] == rec["idx_unique"] == rec["idx_tied"] == 0, rec
    _, i = K.nearest_vertex(q, dup)
    assert int(i.max()) < v.shape[0]
    ax = torch.arange(8.0, device=card) * 0.125
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)
    rec = _knn_agreement(grid[:343] + 0.0625, grid)
    assert rec["tied_rows"] > 0, rec
    assert rec["d2_bits"] == rec["idx_unique"] == rec["idx_tied"] == 0, rec


@pytest.mark.cuda
def test_knn_kernel_empty_other_paths_and_invalid_inputs(card):
    """N = 0 launches nothing; k > 1 and float64 keep the plain path on
    the card (no launch); the wrapper refuses an empty database, a
    database on another device, and the checks the CPU tests hold."""
    from avatarcap_tpu_torch.ops import knn as K
    v = _body(card)
    before = kernels.launches["knn"]
    d, i = K.knn(torch.empty((0, 3), device=card), v)
    assert d.shape == i.shape == (0, 1) and i.dtype == torch.int64
    q = torch.rand((1000, 3), device=card)
    for args in ((q, v, 4), (q.double(), v.double(), 1)):
        d, i = K.knn(*args)
        d_ref, i_ref = K.knn_plain(*args)
        assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    assert kernels.launches["knn"] == before
    with pytest.raises(ValueError, match="out of the kernel's range"):
        K.nearest_vertex(q, v[:0])
    with pytest.raises(ValueError, match="on cpu"):
        K.nearest_vertex(q, v.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        K.nearest_vertex(q.t().contiguous().t(), v)


@pytest.mark.cuda
def test_knn_kernel_on_the_small_textured_frame(card, monkeypatch):
    """The anchor distances of the small textured production frame (both
    soups' unique rays x 4 anchors against the body): every call through
    knn reaches the kernel, whose outputs are knn_plain's bits; under a
    tracer each launch is a ``knn_kernel`` span inside a ``knn`` span, its
    ``rows`` the call's queries."""
    from avatarcap_tpu_torch.ops import knn as K
    from avatarcap_tpu_torch.utils.timers import Tracer
    cap, items, kw = _small_capture(card)
    seen = []
    kernel = K.nearest_vertex

    def recording(queries, database):
        seen.append((queries.clone(), database.clone()))
        return kernel(queries, database)
    monkeypatch.setattr(K, "nearest_vertex", recording)
    tracer = Tracer(card)
    cap.process_frame(items[1], w_recon=True, w_nerf=True, timer=tracer,
                      **kw)
    torch.cuda.synchronize()
    monkeypatch.undo()
    spans = tracer.collect()
    by_id = {s.id: s for s in spans}
    launched = [s for s in spans if s.name == "knn_kernel"]
    assert len(seen) == len(launched) == 2
    assert [s.counts["rows"] for s in launched] == [q.shape[0]
                                                    for q, _ in seen]
    assert all(by_id[s.parent].name == "knn" for s in launched)
    for q, v in seen:
        assert q.shape[0] == 4 * (1 << 14)
        rec = _knn_agreement(q, v, chunk=65536)
        assert rec == {"d2_bits": 0, "idx_unique": 0, "idx_tied": 0,
                       "tied_rows": rec["tied_rows"]}, rec


@pytest.mark.cuda
def test_knn_kernel_repeats_bit_for_bit_without_sync(card):
    """Two calls at a train item's shape (65,536 posed samples against the
    body) give the same bits; the second runs under
    torch.cuda.set_sync_debug_mode("error"), as one launch."""
    from avatarcap_tpu_torch.ops import knn as K
    v = _body(card)
    gen = torch.Generator().manual_seed(7)
    q = (torch.rand((65536, 3), generator=gen) * 2 - 1).to(card) + v.mean(0)
    first = K.knn(q, v)
    before = kernels.launches["knn"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = K.knn(q, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launches["knn"] == before + 1
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])
