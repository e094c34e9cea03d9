"""The port's training data path against the JAX package, on a subject
written by the JAX package's tools.gen_synthetic.generate_subject (the
fixture of tests/test_integration_train.py: the toy body, 2 poses x 2
views, 64 px images, 64^2 position maps).

Items and batches: the numpy RandomState calls are the same on both sides,
so every array equals the JAX dataset's exactly, except those computed from
the SMPL forward kinematics (torch on the port's side, XLA on JAX's: the
live vertices, the joint mats, the canonical joints, bounds and center,
and near / far, which come from the live bounds), held at 1e-5.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_toy_smpl_params

# arrays derived from the forward kinematics (see the module docstring)
FK_KEYS = {"live_smpl_v", "cano2live_jnt_mats", "cano_smpl_jnts",
           "cano_bounds", "cano_smpl_center", "near", "far"}
TEST_VOL_RES = (32, 32, 16)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Fewer torch threads beside XLA's in one process (see
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _port_params(params):
    from avatarcap_tpu_torch.body.smpl import SmplParams
    import dataclasses
    return SmplParams(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(SmplParams)})


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    from avatarcap_tpu.body.smpl import canonical_pose
    from avatarcap_tpu.data.dataset import AvatarCapDataset as JDataset
    from avatarcap_tpu.tools.gen_synthetic import generate_subject
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset

    out = str(tmp_path_factory.mktemp("subject"))
    params = make_toy_smpl_params()
    rng = np.random.RandomState(0)
    poses = []
    for _ in range(2):
        p = canonical_pose().copy()
        p[6:] += rng.uniform(-0.2, 0.2, p.size - 6).astype(np.float32)
        poses.append(p)
    generate_subject(out, params, np.zeros(10, np.float32), np.stack(poses),
                     n_views=2, img_size=64, pos_map_res=64,
                     sur_pts_count=4000, vol_pts_count=500)
    jds = JDataset(out, training=True, smpl_params=params)
    tds = AvatarCapDataset(out, training=True,
                           smpl_params=_port_params(params))
    test_mode = (AvatarCapDataset(out, training=False,
                                  smpl_params=_port_params(params),
                                  vol_res=TEST_VOL_RES, device="cpu"),
                 JDataset(out, training=False, smpl_params=params,
                          vol_res=TEST_VOL_RES))
    yield dict(dir=out, params=params, jds=jds, tds=tds,
               test_mode=test_mode)
    tds.close()


def _assert_items_equal(got, ref):
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k, a in ref.items():
        b = np.asarray(got[k])
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == a.dtype, (k, b.dtype)
        if k in FK_KEYS:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_dataset_layout(subject):
    jds, tds = subject["jds"], subject["tds"]
    assert len(tds) == len(jds) == 4
    assert tds.img_num_per_pose == 2 and tds.data_indices == jds.data_indices
    for name in ("cano_smpl_v", "cano_bounds", "cano_smpl_center",
                 "inv_cano_jnt_mats"):
        np.testing.assert_allclose(getattr(tds, name), getattr(jds, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tds.cano2posmap_jnt_mats,
                                  jds.cano2posmap_jnt_mats)
    # test mode: the port's grid (built on the CPU) against JAX's
    tgrid, jgrid = subject["test_mode"]
    _assert_test_grids_equal(tgrid, jgrid)


def _assert_test_grids_equal(tds, jds):
    """The test-mode grids of two datasets on one subject: flags, compacted
    indices, counts and priors equal; the grid points (from the canonical
    bounds, which come from the forward kinematics) within 1e-6."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    assert tds.num_valid_pts == jds.num_valid_pts > 0
    assert tds.vol_res == jds.vol_res
    for name in ("infer_pts_flag", "valid_pts_idx", "prior_volume",
                 "invalid_pts_ov"):
        a, b = host(getattr(tds, name)), np.asarray(getattr(jds, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("valid_pts", "infer_pts"):
        np.testing.assert_allclose(host(getattr(tds, name)),
                                   np.asarray(getattr(jds, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("light", [False, True])
def test_getitem_matches_jax(subject, light):
    for index in range(4):
        ref = subject["jds"].__getitem__(
            index, np.random.RandomState(10 + index), light=light)
        got = subject["tds"].__getitem__(
            index, np.random.RandomState(10 + index), light=light)
        _assert_items_equal(got, ref)


def test_test_items_match_jax(subject):
    """Test-mode items (every view of every pose): the position map read
    from disk, all-ones color and mask, all box and body rays of the view,
    equal to JAX's; the arrays computed from the forward kinematics at
    1e-6 (the position map and extrinsics exactly); the grid by
    reference."""
    tds, jds = subject["test_mode"]
    assert len(tds) == len(jds) == 4
    for index in range(4):
        got, ref = tds[index], jds[index]
        assert set(got) == set(ref), set(got) ^ set(ref)
        assert got["cano_pts"] is tds.infer_pts
        assert got["valid_pts_flag"] is tds.infer_pts_flag
        for k, a in ref.items():
            if k in ("cano_pts", "valid_pts_flag"):
                continue
            b = np.asarray(got[k])
            a = np.asarray(a)
            assert b.shape == a.shape and b.dtype == a.dtype, (k, b.dtype)
            if k in FK_KEYS:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
    with pytest.raises(ValueError, match="training-mode"):
        next(tds.device_batches(2, device="cpu"))


@pytest.mark.parametrize("num_workers,workers", [(0, "thread"),
                                                 (2, "thread"),
                                                 (2, "process")])
def test_batches_match_jax(subject, num_workers, workers):
    kw = dict(shuffle=True, seed=7, num_workers=num_workers)
    ref = list(subject["jds"].batches(2, **kw))
    got = list(subject["tds"].batches(2, workers=workers, **kw))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_items_equal(g, r)


def test_device_batches_on_cpu_equal_batches(subject):
    """device_batches (per-pose arrays kept on the device, gathered by
    pose index; per-view arrays uploaded one batch ahead) yields the same
    keys and values as batches, here on the CPU."""
    tds = subject["tds"]
    host = list(tds.batches(2, shuffle=True, seed=3, num_workers=2))
    dev = list(tds.device_batches(2, shuffle=True, seed=3, num_workers=2,
                                  device="cpu"))
    assert len(dev) == len(host) == 2
    for h, d in zip(host, dev):
        assert set(h) == set(d), set(h) ^ set(d)
        for k, a in h.items():
            assert isinstance(d[k], torch.Tensor) and d[k].device.type == \
                "cpu", k
            np.testing.assert_array_equal(d[k].numpy(), a, err_msg=k)


def _statics(ds, params, module):
    wv = np.load(os.path.join(ds.data_dir,
                              "cano_base_blend_weight_volume.npy"))
    return module.AvatarStatics(
        weight_volume=wv, cano_smpl_vertices=ds.cano_smpl_v,
        smpl_skinning_weights=np.asarray(params.weights),
        cano_bounds=ds.cano_bounds, cano_smpl_center=ds.cano_smpl_center)


def test_fit_one_epoch(subject, tmp_path):
    """AvatarTrainer.fit for one epoch on the CPU beside the JAX
    trainer's: epoch_0 and epoch_latest, the same JSONL records (keys,
    batches, epochs), two steps, and the epoch-0 warp freeze."""
    import jax
    from avatarcap_tpu.models.avatar import GeoTexAvatar as JAvatar
    from avatarcap_tpu.pipeline import avatar as japi
    from avatarcap_tpu.train.trainer import AvatarTrainer as JTrainer
    from avatarcap_tpu_torch.pipeline import avatar as tapi
    from avatarcap_tpu_torch.tools.bench_workloads import random_avatar
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer

    jds, tds, params = subject["jds"], subject["tds"], subject["params"]
    js = _statics(jds, params, japi)
    module = JAvatar(if_type="sdf")
    item = jds[0]
    variables = jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
        jnp.asarray(item["smpl_pos_map"])[None],
        jnp.asarray(js.cano_smpl_center)[None])
    jt = JTrainer(module=module,
                  statics=japi.AvatarStatics(*map(jnp.asarray, js)),
                  net_ckpt_dir=str(tmp_path / "jax"), n_samples=8)
    jt.fit(jds, 0, 1, batch_size=2, state=jt.init_state(variables),
           log_fn=lambda *_: None)

    ts = tapi.AvatarStatics(*(torch.from_numpy(np.asarray(a, np.float32))
                              for a in _statics(tds, params, tapi)))
    trainer = AvatarTrainer(statics=ts, net_ckpt_dir=str(tmp_path / "port"),
                            n_samples=8, device="cpu")
    model = random_avatar(torch.Generator().manual_seed(0))
    state = trainer.fit(tds, 0, 1, batch_size=2,
                        state=trainer.init_state(model),
                        log_fn=lambda *_: None)
    assert state.step == 2
    for d in ("epoch_0", "epoch_latest"):
        assert sorted(os.listdir(tmp_path / "port" / d)) == ["net.pt",
                                                              "optm.pt"]

    def records(name):
        with open(tmp_path / name / "train_loss.jsonl") as f:
            return [json.loads(line) for line in f]
    ref, got = records("jax"), records("port")
    assert [sorted(r) for r in got] == [sorted(r) for r in ref]
    assert [(r["epoch"], r["batch"]) for r in got] == \
        [(r["epoch"], r["batch"]) for r in ref]
    assert all(np.isfinite(v) for r in got for v in r.values())

    init = model.state_dict()
    for n, p in state.model.named_parameters():
        if n.startswith("warping_field."):
            assert torch.equal(p, init[n]), n
    assert any(not torch.equal(p, init[n])
               for n, p in state.model.named_parameters()
               if n.startswith("cano_template."))


def test_finetune_loop(subject, tmp_path):
    """finetune_texture_template for one epoch on the CPU: one batch of
    the scan's two views, epoch_latest and loss.jsonl written, the warp
    field's parameters unchanged, the template's moved."""
    from types import SimpleNamespace
    from avatarcap_tpu_torch.pipeline import avatar as tapi
    from avatarcap_tpu_torch.tools.bench_workloads import random_avatar
    from avatarcap_tpu_torch.train.finetune import finetune_texture_template
    from avatarcap_tpu_torch.train.trainer import TrainState

    tds, params = subject["tds"], subject["params"]
    ts = tapi.AvatarStatics(*(torch.from_numpy(np.asarray(a, np.float32))
                              for a in _statics(tds, params, tapi)))
    model = random_avatar(torch.Generator().manual_seed(1))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = SimpleNamespace(n_samples=4, training=SimpleNamespace(
        finetune_tex_data_idx=tds.data_indices[1],
        net_ckpt_dir=str(tmp_path)))
    ft = finetune_texture_template(cfg, ts, tds, TrainState(model, {}, 0),
                                   end_epoch=1, log_fn=lambda *_: None,
                                   batch_size=4, num_workers=2,
                                   device="cpu")
    assert ft.step == 1
    out = tmp_path / "finetune_tex"
    assert sorted(os.listdir(out / "epoch_latest")) == ["net.pt", "optm.pt"]
    recs = [json.loads(line) for line in open(out / "loss.jsonl")]
    assert len(recs) == 1 and set(recs[0]) == {
        "epoch", "batch", "tex_loss", "geo_loss", "total_loss"}
    for n, p in ft.model.named_parameters():
        if n.startswith("warping_field."):
            assert torch.equal(p, init[n]), n
    assert any(not torch.equal(p, init[n])
               for n, p in ft.model.named_parameters()
               if n.startswith("cano_template."))
    for k, v in model.state_dict().items():         # the caller's model
        assert torch.equal(v, init[k]), k


def test_smpl_forward_batch():
    from avatarcap_tpu.body.smpl import smpl_forward_batch as jfk
    from avatarcap_tpu_torch.body.smpl import smpl_forward_batch
    params = make_toy_smpl_params()
    rs = np.random.RandomState(2)
    poses = rs.uniform(-0.3, 0.3, (3, 75)).astype(np.float32)
    shape = rs.uniform(-1, 1, 10).astype(np.float32)
    ref = jfk(params, jnp.asarray(poses), jnp.asarray(shape))
    got = smpl_forward_batch(_port_params(params), torch.from_numpy(poses),
                             torch.from_numpy(shape))
    for a, b, name in zip(ref, got, ref._fields):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   err_msg=name)


def test_rays_and_near_far():
    """get_rays / get_near_far: numpy exactly as the JAX package's numpy
    path; torch against its jnp path at 1e-6 (rays) and 1e-5 (depths)."""
    from avatarcap_tpu.ops import rays as jr
    from avatarcap_tpu_torch.ops import rays as tr
    K = np.array([[80, 0, 31.5], [0, 80, 32.5], [0, 0, 1]], np.float32)
    aa = np.array([0.1, -0.2, 0.05], np.float32)
    import cv2 as cv
    R = cv.Rodrigues(aa.astype(np.float64))[0].astype(np.float32)
    T = np.array([[0.1], [-0.05], [2.5]], np.float32)
    bounds = np.array([[-0.4, -0.9, -0.2], [0.4, 0.9, 0.2]], np.float32)
    o, d = tr.get_rays(48, 64, K, R, T)
    jo, jd = jr.get_rays(48, 64, K, R, T, xp=np)
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(d, jd)
    got = tr.get_near_far(bounds, o.reshape(-1, 3), d.reshape(-1, 3))
    ref = jr.get_near_far(bounds, jo.reshape(-1, 3), jd.reshape(-1, 3),
                          xp=np)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert 0 < ref[2].sum() < ref[2].size

    to, td = tr.get_rays(48, 64, *map(torch.from_numpy, (K, R, T)))
    jo, jd = jr.get_rays(48, 64, *map(jnp.asarray, (K, R, T)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    got = tr.get_near_far(torch.from_numpy(bounds), to.reshape(-1, 3),
                          td.reshape(-1, 3))
    ref = jr.get_near_far(jnp.asarray(bounds), jo.reshape(-1, 3),
                          jd.reshape(-1, 3))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_sample_rays_and_bound_mask(subject):
    """sample_rays (training draws) and get_bound_2d_mask on a subject
    image equal the JAX package's for one seed."""
    import cv2 as cv
    from avatarcap_tpu.data import ray_sampling as jrs
    from avatarcap_tpu_torch.data import ray_sampling as trs
    ds = subject["jds"]
    img = cv.imread(ds.color_img_list[1],
                    cv.IMREAD_UNCHANGED).astype(np.float32) / 255.0
    msk = cv.imread(ds.mask_img_list[1], cv.IMREAD_UNCHANGED)
    bounds = ds._live_fk(0)[3]
    R = np.eye(3, dtype=np.float32)
    T = np.array([[0.0], [0.0], [3.0]], np.float32)
    pose = np.concatenate([R, T], 1)
    np.testing.assert_array_equal(
        trs.get_bound_2d_mask(bounds, ds.K, pose, 64, 64),
        jrs.get_bound_2d_mask(bounds, ds.K, pose, 64, 64))
    np.testing.assert_array_equal(trs.project(ds.cano_smpl_v, ds.K, pose),
                                  jrs.project(ds.cano_smpl_v, ds.K, pose))
    for training in (True, False):
        got = trs.sample_rays(img, msk, ds.K, R, T, bounds, 256, training,
                              rng=np.random.RandomState(4))
        ref = jrs.sample_rays(img, msk, ds.K, R, T, bounds, 256, training,
                              rng=np.random.RandomState(4))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_image_and_mesh_io_round_trips(tmp_path):
    """Files written by the port read back by the JAX package's readers
    and the reverse."""
    from avatarcap_tpu.data import image_io as jio
    from avatarcap_tpu.data import mesh_io as jmesh
    from avatarcap_tpu_torch.data import image_io as tio
    from avatarcap_tpu_torch.data import mesh_io as tmesh
    rs = np.random.RandomState(6)
    img = rs.standard_normal((16, 24, 3)).astype(np.float32)
    p = tio.save_float_image(str(tmp_path / "a"), img)
    np.testing.assert_array_equal(jio.load_float_image(p), img)
    p = jio.save_float_image(str(tmp_path / "b"), img)
    np.testing.assert_array_equal(tio.load_float_image(
        str(tmp_path / "b.exr")), img)
    with pytest.raises(FileNotFoundError):
        tio.load_float_image(str(tmp_path / "missing.exr"))

    v = rs.standard_normal((30, 3)).astype(np.float32)
    f = rs.randint(0, 30, (20, 3)).astype(np.int32)
    n = rs.standard_normal((30, 3)).astype(np.float32)
    c = rs.uniform(0, 1, (30, 3)).astype(np.float32)
    tmesh.save_ply(str(tmp_path / "m.ply"), v, f, normals=n, colors=c)
    jmesh.save_ply(str(tmp_path / "j.ply"), v, f, normals=n, colors=c)
    assert (tmp_path / "m.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    for got, ref in zip(tmesh.load_ply(str(tmp_path / "j.ply")),
                        jmesh.load_ply(str(tmp_path / "m.ply"))):
        np.testing.assert_array_equal(got, ref)
    tmesh.save_obj(str(tmp_path / "m.obj"), v, f)
    jv, jf = jmesh.load_obj(str(tmp_path / "m.obj"))
    tv, tf = tmesh.load_obj(str(tmp_path / "m.obj"))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, v, atol=1e-6)
