"""Meshes and point sharding of the port (avatarcap_tpu_torch/parallel/,
AvatarCapture(shard_mesh=...)) against the JAX package on the CPU.

The port's meshes here are ``["cpu"] * n``: one process drives every
slab, as JAX's single-controller mesh over its 8 virtual CPU devices does.
Slabs of a different size may take a different BLAS blocking, so sharded
results are held to the JAX package's own bound for its sharded frame
(tests/test_sharded_frame.py: equal triangle counts, 1e-5), not to bit
equality; the card tests hold the kernels' slabs bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_toy_smpl_params



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: beside the other test workers and XLA's threads
    the frames' many small operators ran tens of times slower on all of
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def env():
    """The toy body on a 16^3 grid whose near-body point count is not a
    multiple of 4 (JAX's tests/test_sharded_query.py), and on a 32^3 grid
    with an inside prior for the production frame
    (tests/test_sharded_frame.py); GeoTexAvatar from PRNGKey(0) and
    ReconNet from PRNGKey(1), both sides from the same weights."""
    from avatarcap_tpu.body.smpl import canonical_pose, smpl_forward
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.models.recon import ReconNetwork
    from avatarcap_tpu.ops.inside import points_inside_mesh
    from avatarcap_tpu.ops.knn import knn
    from avatarcap_tpu_torch.tools.bench_workloads import bench_camera

    params = make_toy_smpl_params()
    cano = smpl_forward(params, jnp.asarray(canonical_pose()),
                        jnp.zeros(10))
    v = np.asarray(cano.vertices)
    lo = v.min(0) - np.array([0.05, 0.05, 0.15], np.float32)
    hi = v.max(0) + np.array([0.05, 0.05, 0.15], np.float32)
    wv = np.zeros((8, 8, 8, params.num_joints), np.float32)
    wv[..., 0] = 1.0
    statics = dict(weight_volume=wv, cano_smpl_vertices=v,
                   smpl_skinning_weights=np.asarray(params.weights),
                   cano_bounds=np.stack([lo, hi]),
                   cano_smpl_center=(0.5 * (lo + hi)).astype(np.float32))

    def grid(vol_res, radius, pad_to):
        lin = [np.linspace(0, 1, r, dtype=np.float32) for r in vol_res]
        g = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
        pts = g * (hi - lo) + lo
        d2, _ = knn(jnp.asarray(pts), cano.vertices, k=1)
        flag = np.asarray(d2[:, 0] < radius ** 2)
        inside = np.asarray(points_inside_mesh(jnp.asarray(pts),
                                               jnp.asarray(v[params.faces])))
        prior = np.where(flag, 0.0, 2.0 * inside - 1.0).astype(np.float32)
        idx = np.where(flag)[0].astype(np.int32)
        pad = (-len(idx)) % pad_to
        return (np.concatenate([pts[idx], np.zeros((pad, 3), np.float32)]),
                np.pad(idx, (0, pad), constant_values=len(pts)), prior,
                vol_res)

    module = GeoTexAvatar(if_type="sdf")
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
                             jnp.zeros((1, 64, 64, 6)),
                             jnp.asarray(statics["cano_smpl_center"])[None]))
    rs = np.random.RandomState(11)
    # an O(0.1) geometry head, so the iso-surface is a real crossing
    variables["params"]["cano_template"]["geo_mlp"]["fc1_kernel"] = \
        rs.uniform(-0.1, 0.1, (128, 2)).astype(np.float32)
    recon = ReconNetwork()
    recon_vars = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(recon.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 6)),
                            jnp.zeros((1, 8, 3)), jnp.zeros((1, 3))))
    recon_vars["params"]["image_decoder"]["fc3"]["kernel"] = \
        rs.uniform(-1.0, 1.0, (128, 1)).astype(np.float32)
    item = {"live_smpl_v": v.astype(np.float32),
            "cano2live_jnt_mats": np.tile(np.eye(4, dtype=np.float32),
                                          (params.num_joints, 1, 1)),
            "smpl_pos_map": (rs.standard_normal((64, 64, 6)) * 0.1
                             ).astype(np.float32)}
    item["w2c_RT"], camera, inferred = bench_camera(64)
    return dict(module=module, variables=variables, recon=recon,
                recon_vars=recon_vars, statics=statics, item=item,
                recon_kw=dict(inferred_normal=inferred, neck_vertex_idx=0,
                              camera=camera),
                query_grid=grid((16, 16, 16), 0.14, 1),
                frame_grid=grid((32, 32, 32), 0.12, 4096))


def _port_statics(env):
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    return AvatarStatics(**{k: torch.as_tensor(np.array(a))
                            for k, a in env["statics"].items()})


def _port_grid(g):
    from avatarcap_tpu_torch.pipeline.capture import CaptureGrid
    pts, idx, prior, vol_res = g
    return CaptureGrid(torch.as_tensor(pts), torch.as_tensor(idx),
                       torch.as_tensor(prior), vol_res)


def _port_avatar(env):
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax
    avatar = GeoTexAvatar()
    avatar.load_state_dict(avatar_state_dict_from_jax(env["variables"]))
    return avatar.eval()


def _port_capture(env, shard_mesh=None, **options):
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.weights import recon_state_dict_from_jax
    recon = ReconNetwork()
    recon.load_state_dict(recon_state_dict_from_jax(env["recon_vars"]))
    opts = dict(max_tris=1 << 14, max_active=1 << 12, render_res=64,
                fusion_iters=2, n_samples=2, refine_capacity=1 << 14,
                recon_refine_capacity=1 << 14, hierarchical_query=True)
    opts.update(options)
    return AvatarCapture(_port_avatar(env), _port_statics(env),
                         _port_grid(env["frame_grid"]), recon=recon,
                         options=CaptureOptions(**opts), device="cpu",
                         shard_mesh=shard_mesh)


def test_make_mesh(monkeypatch):
    from avatarcap_tpu_torch.parallel import make_mesh
    assert make_mesh(["cpu"] * 3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_mesh(["cpu"], axis="model")
    with pytest.raises(ValueError):
        make_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        make_mesh()


@pytest.mark.parametrize("dim", [0, 1])
def test_shard_batch_and_replicate_follow_jax(dim):
    """A leaf splits along ``dim`` exactly when JAX's shard_batch gives it
    the "data" axis there (its size divides by the mesh), and is copied
    whole otherwise; replicate copies every leaf whole."""
    from avatarcap_tpu.parallel.mesh import make_mesh as jax_mesh
    from avatarcap_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from avatarcap_tpu_torch.parallel import (make_mesh, replicate,
                                              shard_batch)
    rs = np.random.RandomState(dim)
    tree = {"even": rs.rand(4, 6).astype(np.float32),
            "odd": rs.rand(3, 5).astype(np.float32),
            "flat": rs.rand(4).astype(np.float32)}
    ref = jax_shard_batch(jax_mesh(jax.devices()[:2]),
                          {k: jnp.asarray(a) for k, a in tree.items()},
                          dim=dim)
    mesh = make_mesh(["cpu"] * 2)
    got = shard_batch(mesh, {k: torch.as_tensor(a) for k, a in tree.items()},
                      dim=dim)
    for k, a in tree.items():
        spec = tuple(ref[k].sharding.spec)
        split = len(spec) > dim and spec[dim] == "data"
        blocks = got[k]
        assert len(blocks) == 2
        if split:
            np.testing.assert_array_equal(
                torch.cat(blocks, dim).numpy(), a)
            assert blocks[0].shape[dim] == a.shape[dim] // 2
        else:
            for b in blocks:
                np.testing.assert_array_equal(b.numpy(), a)
    for blocks in replicate(mesh, [torch.as_tensor(tree["odd"])])[0]:
        np.testing.assert_array_equal(blocks.numpy(), tree["odd"])


def test_shard_points():
    from avatarcap_tpu_torch.parallel import make_mesh, shard_points
    pts = torch.arange(24.0).reshape(1, 8, 3)
    slabs = shard_points(make_mesh(["cpu"] * 4), pts)
    assert [tuple(s.shape) for s in slabs] == [(1, 2, 3)] * 4
    assert torch.equal(torch.cat(slabs, 1), pts)
    with pytest.raises(ValueError):
        shard_points(make_mesh(["cpu"] * 3), pts)


def test_sharded_grid_query_matches_jax_and_unsharded(env):
    """ShardedGridQuery over 4 slabs (the near-body points padded from a
    count that is not a multiple of 4) against JAX's on 4 virtual devices
    and against the port's unsharded f32 query."""
    from avatarcap_tpu.parallel.grid_query import ShardedGridQuery as JaxSGQ
    from avatarcap_tpu.parallel.mesh import make_mesh as jax_mesh
    from avatarcap_tpu.pipeline.avatar import AvatarStatics
    from avatarcap_tpu.pipeline.capture import CaptureGrid
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.parallel.grid_query import ShardedGridQuery
    from avatarcap_tpu_torch.pipeline.avatar import (compute_pose_features,
                                                     query_occupancy)
    from avatarcap_tpu_torch.pipeline.capture import _scatter_set
    pts, idx, prior, vol_res = env["query_grid"]
    assert len(idx) % 4 != 0                       # the pad path
    pos_map = env["item"]["smpl_pos_map"][None]
    jstatics = AvatarStatics(**{k: jnp.asarray(a)
                                for k, a in env["statics"].items()})
    jgrid = CaptureGrid(jnp.asarray(pts), jnp.asarray(idx),
                        jnp.asarray(prior), vol_res)
    ref = np.asarray(JaxSGQ(env["module"], env["variables"], jstatics, jgrid,
                            jax_mesh(jax.devices()[:4]))(pos_map))

    grid = _port_grid(env["query_grid"])
    statics = _port_statics(env)
    got = ShardedGridQuery(_port_avatar(env), statics, grid,
                           make_mesh(["cpu"] * 4))(torch.as_tensor(pos_map))
    assert got.shape == (int(np.prod(vol_res)),)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    avatar = _port_avatar(env)
    with torch.inference_mode():
        feat = compute_pose_features(avatar, torch.as_tensor(pos_map))
        occ = query_occupancy(avatar, grid.valid_pts[None], feat, statics)
        single = _scatter_set(grid.prior_volume, grid.valid_idx,
                              occ["cano_pts_ov"][0, :, 0])
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-5)
    # the field, not the prior, inside the band
    assert not np.allclose(got.numpy(), prior)


@pytest.fixture(scope="module")
def unsharded_frames(env):
    """The port's unsharded production frame per query path."""
    frames = {}

    def get(fused):
        if fused not in frames:
            frames[fused] = _port_capture(
                env, use_fused_query=fused).process_frame(
                    env["item"], w_recon=True, **env["recon_kw"])
        return frames[fused]
    return get


@pytest.mark.parametrize("fused", [False, True],
                         ids=["f32_path", "kernels_plain_versions"])
def test_point_sharded_frame_matches_unsharded(env, unsharded_frames, fused):
    """AvatarCapture(shard_mesh=["cpu"] * 2): the production frame's two
    grid queries (avatar and ReconNet, coarse and refine) in two slabs,
    against the unsharded frame at the JAX test's bound."""
    ref = unsharded_frames(fused)
    got = _port_capture(env, shard_mesh=["cpu"] * 2,
                        use_fused_query=fused).process_frame(
        env["item"], w_recon=True, **env["recon_kw"])
    for key in ("cano_mesh", "recon_mesh"):
        n = int(ref[key].num_tris)
        assert int(got[key].num_tris) == n > 50, key
        np.testing.assert_allclose(got[key].vertices[:3 * n].numpy(),
                                   ref[key].vertices[:3 * n].numpy(),
                                   atol=1e-5)
    np.testing.assert_allclose(got["front_merged_normal"].numpy(),
                               ref["front_merged_normal"].numpy(), atol=1e-5)
    assert bool(got["overflow"]) == bool(ref["overflow"])


def test_point_shard_mesh_checks(env):
    """JAX's three divisibility checks and its hierarchical-query
    requirement, as ValueErrors."""
    with pytest.raises(ValueError, match="coarse capacity"):
        _port_capture(env, shard_mesh=["cpu"] * 3)
    with pytest.raises(ValueError, match="^refine_capacity"):
        _port_capture(env, shard_mesh=["cpu"] * 2,
                      refine_capacity=(1 << 14) + 1)
    with pytest.raises(ValueError, match="recon_refine_capacity"):
        _port_capture(env, shard_mesh=["cpu"] * 2,
                      recon_refine_capacity=(1 << 14) + 1)
    with pytest.raises(ValueError, match="hierarchical_query"):
        _port_capture(env, shard_mesh=["cpu"] * 2, hierarchical_query=False)
    cap = _port_capture(env, shard_mesh=["cpu"] * 2)
    assert cap.shard_mesh == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="replicas"):
        cap.replica("meta")
