"""Every traffic generator and the seeded weights repeat by seed."""

import numpy as np
import pytest
import torch

from benchmark import generate, subject
from benchmark.harness import cell_files
from benchmark.tests.small import SPEC, small_cfg

SEED = 2 ** 31 + 17


def _body(cfg):
    params, statics, cano_v = subject.toy_avatar_statics(cfg["body"], "cpu")
    return params, statics, cano_v


@pytest.mark.parametrize("cell", ["sdf.textured", "occ.avatar_only"])
def test_capture_video_repeats_by_seed(cell):
    cfg = small_cfg(cell)
    mix = cell_files(SPEC, cell)[2]
    params, _, cano_v = _body(cfg)
    a, b, c = (generate.capture_video(mix, cfg, cano_v, params.num_joints, s)
               for s in (SEED, SEED, SEED + 1))
    assert len(a) == mix["frames"]
    for x, y, z in zip(a, b, c):
        for k in ("smpl_pos_map", "cano2live_jnt_mats", "inferred_normal"):
            if k in x:
                np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["smpl_pos_map"], c[0]["smpl_pos_map"])
    # distinct frames, and the joint shifts stay within their bound
    assert not np.array_equal(a[0]["smpl_pos_map"], a[1]["smpl_pos_map"])
    assert max(np.abs(f["cano2live_jnt_mats"][:, :3, 3]).max()
               for f in a) <= mix["joint_max"] + 1e-7


def test_train_pool_repeats_by_seed():
    cell = "sdf.train_b4"
    cfg, mix = small_cfg(cell), cell_files(SPEC, cell)[2]
    params, statics, cano_v = _body(cfg)
    center = statics.cano_smpl_center.numpy()
    a, b, c = (generate.train_pool(mix, cfg, params, cano_v, center, s)
               for s in (SEED, SEED, SEED + 1))
    assert len(a) == mix["pool"]
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["t_rand"], c[0]["t_rand"])
    assert not np.array_equal(a[0]["cano_pts"], a[1]["cano_pts"])


def test_train_weights_repeat_by_seed():
    cfg = small_cfg("sdf.train_b4")
    a, b, c = (subject.train_weights(cfg, s) for s in (SEED, SEED, SEED + 1))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].is_floating_point())


def test_seed_parts_take_large_seeds():
    parts = subject.seed_parts(2 ** 40 + 3, 5)
    assert len(set(parts)) == 5 and all(0 <= p < 2 ** 63 for p in parts)
    assert parts == subject.seed_parts(2 ** 40 + 3, 5)


def _tiny_fit(cfg):
    cfg["fit"].update(template_steps=3, decoder_steps=3, n_pts=256,
                      batch=256)
    return cfg


def test_capture_weights_repeat_by_seed():
    # the pose U-Net and warp follow the seed; the fitted template and
    # ReconNet are the configuration's, the same for every seed
    cfg = _tiny_fit(small_cfg("sdf.textured"))
    params, statics, _ = _body(cfg)
    grid = subject.build_capture_grid(statics, cfg["vol_res"])
    a, b, c = (subject.capture_weights(cfg, s, params, statics, grid, "cpu",
                                       use_cache=False)[0]
               for s in (SEED, SEED, SEED + 1))
    for net in a:
        for k in a[net]:
            assert torch.equal(a[net][k], b[net][k])
    for k in a["recon"]:
        assert torch.equal(a["recon"][k], c["recon"][k])
    for k in a["avatar"]:
        same = torch.equal(a["avatar"][k], c["avatar"][k])
        if k.startswith("cano_template."):
            assert same, k
        elif k.startswith("warping_field.unet.") and k.endswith(".weight"):
            assert not same, k


def test_body_normal_images_face_their_views():
    cfg = small_cfg("sdf.textured")
    params, statics, _ = _body(cfg)
    front, back = subject.body_normal_images(params, statics, 64, 0.0, 1.0)
    for img, sign in ((front, 1.0), (back, -1.0)):
        covered = img.norm(dim=-1) > 0.5
        assert covered.float().mean() > 0.05
        # outward normals: +z toward the front view, -z toward the back
        assert (sign * img[..., 2][covered] > 0).float().mean() > 0.9
