"""Streaming capture of the port (avatarcap_tpu_torch/pipeline/
streaming.py) against its own process_frame and against the JAX
package's StreamingCapture, on the CPU; and the frame's freedom from host
reads (``AvatarCapture.frame_body``, ``compact_mask_indices``).

Every streamed frame runs ``frame_body``, the code of process_frame, on
the same inputs, so the CPU results must be equal bit for bit, in all
three frame forms (avatar-only, production, textured production) and on
distinct poses. Against JAX both sides run the f32 module path and compare
at tests/capture_cases.py's mesh bounds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_toy_smpl_params
from capture_cases import env as capture_env  # noqa: F401

SMALL = dict(max_tris=1 << 14, max_active=1 << 12, render_res=64,
             fusion_iters=2, n_samples=2, refine_capacity=1 << 14,
             recon_refine_capacity=1 << 14, hierarchical_query=True)
# the texture path of the capture workload (K3 through its plain version)
TEXTURE = dict(nerf_unique_capacity=1 << 13, recon_unique_capacity=1 << 12,
               recon_color_mode="direct")
FORMS = {"avatar_only": dict(w_recon=False, w_nerf=False),
         "w_recon": dict(w_recon=True, w_nerf=False),
         "w_recon_w_nerf": dict(w_recon=True, w_nerf=True)}



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
    """The toy body on a 32^3 grid with an inside prior (JAX's
    tests/test_sharded_frame.py), GeoTexAvatar from PRNGKey(0) with an
    O(0.1) geometry head, ReconNet from PRNGKey(1), the bench camera at
    64^2, and 5 distinct poses: perturbed position maps, and joint mats
    rotated about y and shifted."""
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
    vol_res = (32, 32, 32)
    lin = [np.linspace(0, 1, r, dtype=np.float32) for r in vol_res]
    g = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    pts = g * (hi - lo) + lo
    d2, _ = knn(jnp.asarray(pts), cano.vertices, k=1)
    flag = np.asarray(d2[:, 0] < 0.12 ** 2)
    inside = np.asarray(points_inside_mesh(jnp.asarray(pts),
                                           jnp.asarray(v[params.faces])))
    prior = np.where(flag, 0.0, 2.0 * inside - 1.0).astype(np.float32)
    idx = np.where(flag)[0].astype(np.int32)
    pad = (-len(idx)) % 4096
    grid = (np.concatenate([pts[idx], np.zeros((pad, 3), np.float32)]),
            np.pad(idx, (0, pad), constant_values=len(pts)), prior, vol_res)

    module = GeoTexAvatar(if_type="sdf")
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
                             jnp.zeros((1, 64, 64, 6)),
                             jnp.asarray(statics["cano_smpl_center"])[None]))
    rs = np.random.RandomState(11)
    variables["params"]["cano_template"]["geo_mlp"]["fc1_kernel"] = \
        rs.uniform(-0.1, 0.1, (128, 2)).astype(np.float32)
    # a denser density row, so the color rays carry color
    variables["params"]["cano_template"]["geo_mlp"]["fc1_kernel"][:, 1] = \
        rs.uniform(-1.0, 1.0, 128).astype(np.float32)
    variables["params"]["cano_template"]["geo_mlp"]["fc1_bias"] = \
        np.array([0.0, 4.0], np.float32)
    recon = ReconNetwork()
    recon_vars = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(recon.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 6)),
                            jnp.zeros((1, 8, 3)), jnp.zeros((1, 3))))
    recon_vars["params"]["image_decoder"]["fc3"]["kernel"] = \
        rs.uniform(-1.0, 1.0, (128, 1)).astype(np.float32)
    w2c, camera, inferred = bench_camera(64)
    base = (rs.standard_normal((64, 64, 6)) * 0.1).astype(np.float32)
    items = []
    for k in range(5):
        ang = 0.15 * k
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]]
        jm = np.tile(m, (params.num_joints, 1, 1))
        jm[:, :3, 3] = rs.uniform(-0.05, 0.05, (params.num_joints, 3))
        items.append({
            "live_smpl_v": v.astype(np.float32), "cano2live_jnt_mats": jm,
            "smpl_pos_map": base + (0.05 * rs.standard_normal(base.shape)
                                    ).astype(np.float32),
            "w2c_RT": w2c})
    return dict(module=module, variables=variables, recon=recon,
                recon_vars=recon_vars, statics=statics, grid=grid,
                items=items, camera=camera, inferred=inferred,
                num_joints=params.num_joints)


def _port_capture(env, **options):
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureGrid,
                                                      CaptureOptions)
    from avatarcap_tpu_torch.weights import (avatar_state_dict_from_jax,
                                             recon_state_dict_from_jax)
    avatar = GeoTexAvatar()
    avatar.load_state_dict(avatar_state_dict_from_jax(env["variables"]))
    recon = ReconNetwork()
    recon.load_state_dict(recon_state_dict_from_jax(env["recon_vars"]))
    statics = AvatarStatics(**{k: torch.as_tensor(np.array(a))
                               for k, a in env["statics"].items()})
    pts, idx, prior, vol_res = env["grid"]
    grid = CaptureGrid(torch.as_tensor(pts), torch.as_tensor(idx),
                       torch.as_tensor(prior), vol_res)
    return AvatarCapture(avatar, statics, grid, recon=recon,
                         options=CaptureOptions(**{**SMALL, **options}),
                         device="cpu")


def _stream(env, capture, mesh, form, **kw):
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    return StreamingCapture(capture, mesh, camera=env["camera"],
                            image_size=env["inferred"].shape[:2],
                            **FORMS[form], **kw)


def _leaves(tree):
    """The tensors of a frame's results in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _assert_equal(got, ref):
    assert sorted(got) == sorted(ref)
    a, b = _leaves(got), _leaves(ref)
    assert len(a) == len(b) > 8
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.fixture(scope="module")
def frames(env):
    """process_frame's results per form and item, computed once."""
    cache = {}

    def get(form, i):
        if form not in cache:
            cache[form] = (_port_capture(env, **TEXTURE), {})
        cap, out = cache[form]
        if i not in out:
            f = FORMS[form]
            kw = (dict(inferred_normal=env["inferred"], neck_vertex_idx=0,
                       camera=env["camera"]) if f["w_recon"] else {})
            out[i] = cap.process_frame(env["items"][i], **f, **kw)
        return out[i]
    return get


@pytest.mark.parametrize("form", list(FORMS))
def test_streaming_equals_process_frame(env, frames, form):
    """run_pipelined (lookahead 2) and run (a 2-slab mesh, one frame per
    device: 3 frames pad a batch of 4) give process_frame's results, bit
    for bit, on 3 distinct poses."""
    items = env["items"][:3]
    normals = [env["inferred"]] * 3 if FORMS[form]["w_recon"] else None
    cap = _port_capture(env, **TEXTURE)
    pipelined = _stream(env, cap, ["cpu"], form).run_pipelined(
        items, inferred_normals=normals, lookahead=2)
    batched = _stream(env, cap, ["cpu"] * 2, form).run(
        items, inferred_normals=normals)
    assert len(pipelined) == len(batched) == 3
    for i in range(3):
        ref = frames(form, i)
        _assert_equal(pipelined[i], ref)
        _assert_equal(batched[i], ref)
    assert not torch.equal(pipelined[0]["live_mesh"].vertices,
                           pipelined[1]["live_mesh"].vertices)


def test_run_pads_the_last_batch_and_keeps_order(env, frames):
    """5 frames on a 2-slab mesh at 2 frames per device: a full batch of
    4, then one padded with its last frame; 5 results, in order."""
    cap = _port_capture(env, **TEXTURE)
    sc = _stream(env, cap, ["cpu"] * 2, "avatar_only", frames_per_device=2)
    assert sc.batch == 4
    got = sc.run(env["items"])
    assert len(got) == 5
    for i, res in enumerate(got):
        _assert_equal(res, frames("avatar_only", i))


def test_rotated_pose_rotates_live_normals(env):
    """Every joint shares one rotation R: the live normals are the
    canonical ones rotated, cn @ R.T (tests/test_streaming.py)."""
    ang = 0.7
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    item = dict(env["items"][0],
                cano2live_jnt_mats=np.tile(M, (env["num_joints"], 1, 1)))
    cap = _port_capture(env, **TEXTURE)
    res = _stream(env, cap, ["cpu"] * 2, "avatar_only").run([item])[0]
    n = int(res["cano_mesh"].num_tris)
    assert n > 0
    cn = res["cano_mesh"].normals[:3 * n].numpy()
    ln = res["live_mesh"].normals[:3 * n].numpy()
    np.testing.assert_allclose(ln, cn @ R.T, atol=1e-4)
    assert not np.allclose(ln, cn, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(ln, axis=-1),
                               np.linalg.norm(cn, axis=-1), atol=1e-4)


def test_pipelined_matches_jax_streaming(capture_env):
    """The production frame streamed by both packages on one device (JAX:
    a one-device mesh), 2 poses, f32 module path on both sides, on the
    fixture of tests/capture_cases.py and at its mesh bounds: the
    avatar and ReconNet meshes, the live ReconNet mesh, the overflow bit."""
    from avatarcap_tpu.parallel.mesh import make_mesh
    from avatarcap_tpu.pipeline.capture import AvatarCapture, CaptureOptions
    from avatarcap_tpu.pipeline.streaming import StreamingCapture
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture as TS
    from capture_cases import (OPTS, _close_mostly, _compare_mesh,
                               _port_capture)
    env = capture_env
    second = dict(env["item"], smpl_pos_map=env["item"]["smpl_pos_map"]
                  + np.float32(0.05) * np.random.RandomState(5)
                  .standard_normal((128, 128, 6)).astype(np.float32))
    items = [env["item"], second]
    kw = dict(camera=env["recon_kw"]["camera"],
              image_size=env["recon_kw"]["inferred_normal"].shape[:2],
              w_recon=True)
    normals = [env["recon_kw"]["inferred_normal"]] * 2
    jcap = AvatarCapture(env["module"], env["variables"], env["jstatics"],
                         env["jgrid"], recon=env["recon"],
                         recon_vars=env["recon_vars"],
                         options=CaptureOptions(use_fused_query=False,
                                                **OPTS))
    ref = StreamingCapture(jcap, make_mesh(jax.devices()[:1]),
                           **kw).run_pipelined(items, inferred_normals=normals)
    got = TS(_port_capture(env, fused=False), ["cpu"], **kw).run_pipelined(
        items, inferred_normals=normals)
    for g, r in zip(got, ref):
        for key in ("cano_mesh", "recon_mesh"):
            _compare_mesh(g[key], r[key])
        _close_mostly(g["live_recon_mesh"].vertices.numpy(),
                      np.asarray(r["live_recon_mesh"].vertices), 1e-5, 2e-4)
        assert bool(g["overflow"]) == bool(np.asarray(r["overflow"]))
    assert not torch.equal(got[0]["cano_mesh"].vertices,
                           got[1]["cano_mesh"].vertices)


def test_streaming_checks_its_arguments(env, monkeypatch):
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    cap = _port_capture(env)
    with pytest.raises(ValueError, match="camera"):
        StreamingCapture(cap, ["cpu"], w_recon=True)
    with pytest.raises(ValueError, match="inferred normals"):
        _stream(env, cap, ["cpu"], "w_recon").run(env["items"][:2],
                                                  [env["inferred"]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        StreamingCapture(cap, None)


# aten operators that read a device value back to the host on a card
_HOST_READS = {"_local_scalar_dense", "nonzero", "nonzero_static",
               "masked_select", "_unique2", "unique_dim",
               "unique_consecutive", "equal", "is_nonzero", "allclose",
               "item"}


class _HostReads(TorchDispatchMode):
    """Records the operators of a region that would make the host wait
    for a card: the value reads above, and indexing by a bool mask (its
    shape depends on the mask's values)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _HOST_READS or (
                name in ("index", "index_put", "index_put_")
                and any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                        for t in (args[1] if len(args) > 1 else ())
                        if t is not None)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_frame_body_reads_nothing_back(env):
    """The textured production frame's frame_body (the superset of the
    three forms) and its compaction make none of those reads; the
    uploads stay outside it."""
    from avatarcap_tpu_torch.ops.compaction import compact_mask_indices
    cap = _port_capture(env, **TEXTURE)
    frame, jnt, normal, w2c = cap.upload(env["items"][0], env["inferred"])
    neck = cap._neck_xy(0)
    with _HostReads() as reads:
        compact_mask_indices(torch.rand(1000) < 0.3, 100)
        res = cap.frame_body(frame, jnt, normal, w2c, env["camera"], neck,
                             w_recon=True, w_nerf=True)
    assert reads.seen == []
    assert int(res["recon_mesh"].num_tris) > 0
    # the detector sees a read where there is one
    with _HostReads() as reads:
        torch.nonzero(torch.rand(10) < 0.5)
        torch.rand(10)[torch.rand(10) < 0.5]
    assert reads.seen == ["nonzero", "index"]
