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
        k1, k2 = warp_template_query.launches, recon_decode.launches
        out[dev.type] = cap.process_frame(item, w_recon=True, **kw)
        if dev.type == "cuda":
            assert (warp_template_query.launches - k1,
                    recon_decode.launches - k2) == (2, 2)
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
