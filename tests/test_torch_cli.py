"""The port's CLI on the CPU (cli.main / train_avatar / run_avatarcap with
device "cpu"), on a subject written by the port's generate_subject: the
toy body at 3,202 vertices (the CLI's neck vertex is 3,068), 2 poses x 2
views, 64 px images, 64^2 position maps, a 32 x 32 x 16 test grid, 64^2
renders, the f32 path (use_fused_query off), 8 samples a ray, a 4 cm
skinning volume and 4,096 unique-vertex slots for the colors.

The CLI's frame is chained to the JAX package through what the other
files hold: its test item equals the JAX dataset's
(tests/test_torch_data.py), and process_frame equals the JAX frame
(tests/test_torch_capture.py); here the frame the CLI writes equals
process_frame's on the same item and weights.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

SMPL_FILE = "basicmodel_m_lbs_10_207_0_v1.0.0.pkl"
VOL_RES = (32, 32, 16)
CAPTURE = {"max_tris": 1 << 14, "max_active": 1 << 13,
           "refine_capacity": 1 << 15, "nerf_unique_capacity": 1 << 12,
           "recon_unique_capacity": 1 << 12, "recon_color_mode": "direct",
           "n_samples": 8, "fusion_iters": 10, "skin_voxel": 0.04,
           "use_fused_query": False}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Subject, SMPL pkl, a ReconNet checkpoint in the reference's
    {"network": state_dict} form, the config, and one epoch of training
    through cli.main."""
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.body.smpl import canonical_pose
    from avatarcap_tpu_torch.tools.bench_workloads import random_recon
    from avatarcap_tpu_torch.tools.gen_synthetic import generate_subject
    from avatarcap_tpu_torch.utils.toy_body import (make_toy_smpl_params,
                                                    write_smpl_pkl)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(min(n_threads, 4))
    root = tmp_path_factory.mktemp("cli")
    params = make_toy_smpl_params(n_lat=42, n_lon=80)
    os.makedirs(root / "smpl")
    write_smpl_pkl(params, str(root / "smpl" / SMPL_FILE))
    rng = np.random.RandomState(0)
    poses = [canonical_pose()]
    p = canonical_pose().copy()
    p[6:] += rng.uniform(-0.2, 0.2, p.size - 6).astype(np.float32)
    poses.append(p)
    subject = str(root / "subject")
    generate_subject(subject, params, np.zeros(10, np.float32),
                     np.stack(poses), n_views=2, img_size=64, pos_map_res=64,
                     sur_pts_count=1000, vol_pts_count=100, device="cpu")
    os.makedirs(root / "recon")
    torch.save({"network": random_recon(
        torch.Generator().manual_seed(1)).state_dict()},
        str(root / "recon" / "recon_net.pt"))
    cfg = {"training": {"training_data_dir": subject,
                        "net_ckpt_dir": str(root / "train"), "end_epoch": 1,
                        "batch_size": 2, "finetune_tex": False},
           "testing": {"vol_res": list(VOL_RES),
                       "testing_data_dir": subject,
                       "output_dir": str(root / "out"),
                       "net_ckpt": str(root / "train" / "epoch_latest"),
                       "recon_net_ckpt": str(root / "recon"),
                       "render_res": 64, "capture_options": CAPTURE},
           "smpl_model_dir": str(root / "smpl"), "n_samples": 8}
    cfg_path = str(root / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert cli.main(["-c", cfg_path, "-m", "train", "--device", "cpu"]) \
        is None
    yield dict(root=root, cfg_path=cfg_path, params=params, subject=subject)
    torch.set_num_threads(n_threads)


def test_train_writes_loadable_checkpoint(env):
    """One epoch writes epoch_0 and epoch_latest (net.pt, optm.pt); the
    test mode's loader reads net.pt back bit for bit."""
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.weights import load_reference_checkpoint
    ckpt = env["root"] / "train" / "epoch_latest"
    assert sorted(os.listdir(ckpt)) == ["net.pt", "optm.pt"]
    assert (env["root"] / "train" / "epoch_0" / "net.pt").exists()
    model = GeoTexAvatar()
    load_reference_checkpoint(model, str(ckpt / "net.pt"))
    saved = torch.load(str(ckpt / "net.pt"), weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_run_avatarcap_matches_process_frame(env):
    """-m test --nerf --save-avatar-mesh --save-final-mesh --frame-idx 0:
    the five outputs are written, the stage names are the textured
    production frame's, and the avatar PLY (vertices, normals, colors)
    equals the live mesh of process_frame run directly on the dataset's
    item with the checkpoint's weights."""
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.config import load_config
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset
    from avatarcap_tpu_torch.data.image_io import load_float_image
    from avatarcap_tpu_torch.data.mesh_io import load_ply
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureGrid,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.body.smpl import SmplParams

    records = cli.main(["-c", env["cfg_path"], "-m", "test", "--device",
                        "cpu", "--nerf", "--save-avatar-mesh",
                        "--save-final-mesh", "--frame-idx", "0"])
    out = env["root"] / "out"
    for name in ("cano_avatar/0000.jpg", "live_avatar/0000.jpg",
                 "live_recon/0000.jpg", "0000_avatar.ply", "0000_recon.ply"):
        assert (out / name).exists(), name
    (rec,) = records
    assert list(rec["stages"]) == [
        "geometry", "skinning", "lift", "cano_layers", "merge", "hgfilter",
        "recon_query_mc", "recon_skinning", "nerf_colors", "color_transfer"]
    assert rec["num_tris"] > 100 and rec["recon_num_tris"] > 0

    cfg = load_config(env["cfg_path"])
    params = SmplParams.load(str(env["root"] / "smpl" / SMPL_FILE))
    ds = AvatarCapDataset(env["subject"], training=False, smpl_params=params,
                          vol_res=VOL_RES, device="cpu")
    wv = np.load(os.path.join(env["subject"],
                              "cano_base_blend_weight_volume.npy"))
    statics = AvatarStatics(*(torch.as_tensor(np.asarray(a, np.float32))
                              for a in (wv, ds.cano_smpl_v, params.weights,
                                        ds.cano_bounds, ds.cano_smpl_center)))
    avatar = GeoTexAvatar()
    avatar.load_state_dict(torch.load(
        os.path.join(cfg.testing.net_ckpt, "net.pt"), weights_only=True))
    recon = ReconNetwork()
    recon.load_state_dict(torch.load(
        str(env["root"] / "recon" / "recon_net.pt"),
        weights_only=True)["network"])
    capture = AvatarCapture(
        avatar, statics, CaptureGrid(ds.valid_pts, ds.valid_pts_idx,
                                     ds.prior_volume, VOL_RES),
        recon=recon, device="cpu",
        options=CaptureOptions(render_res=64, **CAPTURE))
    item = ds[0]
    normal = load_float_image(os.path.join(env["subject"],
                                           "imgs/000/normal_view_000.exr"))
    res = capture.process_frame(item, w_recon=True, w_nerf=True,
                                inferred_normal=normal,
                                neck_vertex_idx=cli.NECK_VERTEX_IDX,
                                camera=ds.data_config["camera"])
    live = res["live_mesh"]
    n = 3 * int(live.num_tris)
    assert n == 3 * rec["num_tris"]
    v, f, nrm, col = load_ply(str(out / "0000_avatar.ply"))
    np.testing.assert_array_equal(v, live.vertices[:n].numpy())
    np.testing.assert_array_equal(nrm, live.normals[:n].numpy())
    np.testing.assert_array_equal(f.reshape(-1), np.arange(n))
    colors = np.clip(res["avatar_colors"][:n].numpy() * 255.0, 0, 255)
    np.testing.assert_array_equal(col, colors.astype(np.uint8))
    assert int(res["recon_mesh"].num_tris) == rec["recon_num_tris"]


def test_single_view_frame_through_main(env):
    """--view-idx / --frame-idx pick the frame; without --nerf the PLYs
    carry no colors."""
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.data.mesh_io import load_ply
    (rec,) = cli.main(["-c", env["cfg_path"], "-m", "test", "--device",
                       "cpu", "--view-idx", "1", "--frame-idx", "1",
                       "--save-final-mesh"])
    out = env["root"] / "out"
    assert rec["data_idx"] == 1
    assert (out / "live_recon" / "0001.jpg").exists()
    _, _, _, col = load_ply(str(out / "0001_recon.ply"))
    assert col is None
    assert not (out / "0001_avatar.ply").exists()


def test_stream_raises(env, monkeypatch):
    """--stream runs on the cards unless --device names the CPU: without
    a card it raises (nothing falls back to the CPU)."""
    from avatarcap_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", env["cfg_path"], "-m", "test", "--stream", "1"])


def _config_with_output(env, name):
    with open(env["cfg_path"]) as f:
        cfg = yaml.safe_load(f)
    cfg["testing"]["output_dir"] = str(env["root"] / name)
    path = str(env["root"] / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_stream_writes_the_same_files(env):
    """-m test --nerf --stream 2 over both frames (one pipelined batch on
    one device) writes the files of the run without --stream: the same
    JPEG bytes and the same PLY triangles, vertices and colors."""
    from avatarcap_tpu_torch import cli
    from avatarcap_tpu_torch.data.mesh_io import load_ply
    flags = ["-m", "test", "--device", "cpu", "--nerf", "--save-avatar-mesh",
             "--save-final-mesh"]
    loop = cli.main(["-c", _config_with_output(env, "loop")] + flags)
    streamed = cli.main(["-c", _config_with_output(env, "stream")] + flags
                        + ["--stream", "2"])
    assert [r["data_idx"] for r in streamed] == [0, 1]
    for a, b in zip(loop, streamed):
        assert (a["num_tris"], a["recon_num_tris"], a["overflow"]) == (
            b["num_tris"], b["recon_num_tris"], b["overflow"])
        assert list(b["stages"]) == list(a["stages"])
    names = [f"{sub}/{i:04d}.jpg" for sub in ("cano_avatar", "live_avatar",
                                              "live_recon") for i in (0, 1)]
    for name in names:
        assert ((env["root"] / "loop" / name).read_bytes()
                == (env["root"] / "stream" / name).read_bytes()), name
    for i in (0, 1):
        for kind in ("avatar", "recon"):
            a = load_ply(str(env["root"] / "loop" / f"{i:04d}_{kind}.ply"))
            b = load_ply(str(env["root"] / "stream" / f"{i:04d}_{kind}.ply"))
            assert len(a[1]) == len(b[1]) > 0
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_default_device_needs_a_card(env, monkeypatch):
    """Without --device the CLI runs on the card, and raises without one
    (nothing falls back to the CPU)."""
    from avatarcap_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", env["cfg_path"], "-m", "test"])
