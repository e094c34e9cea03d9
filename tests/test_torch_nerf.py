"""The texture path's kernels and modules against the JAX package.

Kernels: the plain versions of K3 (ray_color_query), K4 (template_query)
and K5 (offset_query) against the Pallas kernels run in interpret mode,
with the weights carried across by weights.avatar_state_dict_from_jax and
packed on each side. Like K1 (tests/test_torch_fused_query.py), each pair
differs only where a different f32 summation order flips a bf16 rounding,
so K4 and K5 are held at K1's tolerances on K1's fixture, and K3 at the
2e-3 at which tests/test_pallas_query.py holds the JAX kernel against its
own chunked compositing (a K3 color sums S such samples).

Modules: the compositor, the masked query and render_rays, the anchored
near-body flags, the distance volume, the soup dedupe and the marching-tets
edge keys, all in float32 with the same formulas, so at float32-rounding
tolerances, and the dedupe and edge keys exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from avatarcap_tpu_torch import kernels
from conftest import make_toy_smpl_params
# K1's weights (BatchNorm statistics drawn, a trained warp's offset scale,
# an O(0.1) geometry head): the fixture K1's tolerances were measured on
from test_torch_fused_query import weights  # noqa: F401

# K1's tolerances (tests/test_torch_fused_query.py)
ATOL = {"occ": 5e-3, "alpha": 5e-3, "rgb": 5e-3, "offset": 5e-4}
K3_ATOL = 2e-3


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def env():
    """The fixture of tests/test_pallas_query.py (toy body, bounds +-0.1,
    GeoTexAvatar from PRNGKey(0)) with the geometry head's last layer drawn
    from numpy, N(0, 1) weights and a 0.5 bias, so that the rays carry
    density; the port's GeoTexAvatar loads the same weights."""
    from avatarcap_tpu.body.smpl import smpl_forward, canonical_pose
    from avatarcap_tpu.models.avatar import GeoTexAvatar
    from avatarcap_tpu.pipeline.avatar import AvatarStatics
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar as TGeoTex
    from avatarcap_tpu_torch.pipeline.avatar import (
        AvatarStatics as TStatics)
    from avatarcap_tpu_torch.weights import avatar_state_dict_from_jax

    params = make_toy_smpl_params()
    cano = smpl_forward(params, jnp.asarray(canonical_pose()), jnp.zeros(10))
    v = np.asarray(cano.vertices)
    lo, hi = v.min(0) - 0.1, v.max(0) + 0.1
    statics_np = dict(weight_volume=np.zeros((8, 8, 8, 24), np.float32),
                      cano_smpl_vertices=v,
                      smpl_skinning_weights=np.asarray(params.weights),
                      cano_bounds=np.stack([lo, hi]).astype(np.float32),
                      cano_smpl_center=(0.5 * (lo + hi)).astype(np.float32))
    module = GeoTexAvatar(if_type="sdf")
    rs = np.random.RandomState(5)
    pos_map = rs.standard_normal((1, 128, 128, 6)).astype(np.float32)
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 3)),
                             jnp.asarray(pos_map),
                             jnp.asarray(statics_np["cano_smpl_center"])[None]))
    geo = variables["params"]["cano_template"]["geo_mlp"]
    geo["fc1_kernel"] = rs.standard_normal((128, 2)).astype(np.float32)
    geo["fc1_bias"] = np.full((2,), 0.5, np.float32)
    port = TGeoTex()
    port.load_state_dict(avatar_state_dict_from_jax(variables))
    port.eval()
    return dict(module=module, variables=variables, port=port,
                pos_map=pos_map, statics_np=statics_np,
                jstatics=AvatarStatics(**{k: jnp.asarray(a)
                                          for k, a in statics_np.items()}),
                tstatics=TStatics(**{k: _t(a)
                                     for k, a in statics_np.items()}))


@pytest.fixture(scope="module")
def packed(env):
    from avatarcap_tpu.pipeline.avatar import pack_fused_query_weights
    from avatarcap_tpu_torch.pipeline.avatar import (
        pack_fused_query_weights as tpack)
    with torch.no_grad():
        return pack_fused_query_weights(env["variables"]), tpack(env["port"])


def _rays(env, n, seed):
    """Rays whose samples land within +-5 cm of random body vertices."""
    rs = np.random.RandomState(seed)
    v = env["statics_np"]["cano_smpl_vertices"]
    base = v[rs.randint(0, v.shape[0], n)]
    nrm = rs.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pf = rs.standard_normal((2, n, 64)).astype(np.float32)
    pf = np.asarray(jnp.asarray(pf).astype(jnp.bfloat16).astype(jnp.float32))
    return (base + nrm).astype(np.float32), -nrm, pf[0], pf[1]


@pytest.mark.parametrize("n_samples,n_anchors", [(8, 4), (5, 3)])
def test_k3_plain_matches_pallas_interpret(env, packed, n_samples,
                                           n_anchors):
    """K3 on 192 rays; (8, 4) is the JAX package's own fixture, (5, 3) a
    sample count whose anchor segments do not align with the samples."""
    from avatarcap_tpu.ops.pallas_query import ray_color_query_fused
    from avatarcap_tpu.pipeline.capture import anchor_distances
    from avatarcap_tpu_torch.ops.fused_query import ray_color_query
    from avatarcap_tpu_torch.pipeline.avatar import NEAR_SMPL_DIST
    jp, tp = packed
    near, far = 1.0 - 0.02, 1.0 + 0.05
    ro, rd, pf0, pf1 = _rays(env, 192, seed=n_samples)
    st = env["jstatics"]
    danch = np.asarray(anchor_distances(jnp.asarray(ro), jnp.asarray(rd),
                                        near, far, st.cano_smpl_vertices,
                                        n_anchors=n_anchors))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ray_color_query_fused(
            jp["offset"], jp["template"], jnp.asarray(ro), jnp.asarray(rd),
            jnp.asarray(pf0).astype(jnp.bfloat16),
            jnp.asarray(pf1).astype(jnp.bfloat16), jnp.asarray(danch),
            st.cano_bounds, n_samples=n_samples, near=near, far=far,
            tile=256))
    before = kernels.launches["k3"]
    got = ray_color_query(tp["offset"], tp["template"], _t(ro), _t(rd),
                          _t(pf0).to(torch.bfloat16),
                          _t(pf1).to(torch.bfloat16), _t(danch),
                          env["tstatics"].cano_bounds, n_samples=n_samples,
                          near=near, far=far, threshold=NEAR_SMPL_DIST)
    assert kernels.launches["k3"] == before          # CPU: plain version
    assert got.shape == (192, 3) and got.dtype == torch.float32
    assert (ref > 1e-3).any(), "degenerate case: all rays empty"
    np.testing.assert_allclose(got.numpy(), ref, atol=K3_ATOL)


def test_k4_k5_plain_match_pallas_interpret(weights):
    """K1's two halves on K1's fixture, at K1's tolerances."""
    from avatarcap_tpu.ops.pallas_query import (offset_query_fused,
                                                template_query_fused)
    from avatarcap_tpu_torch.ops.fused_query import (offset_query,
                                                     template_query)
    jp, tp = weights
    rs = np.random.RandomState(3)
    pts = rs.uniform(-0.8, 0.8, (1000, 3)).astype(np.float32)
    feats = np.concatenate([pts, rs.standard_normal((1000, 64))],
                           -1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in template_query_fused(
            jp["template"], jnp.asarray(pts))]
        ref_off = np.asarray(offset_query_fused(jp["offset"],
                                                jnp.asarray(feats)))
    before = (kernels.launches["k4"], kernels.launches["k5"])
    got = template_query(tp["template"], _t(pts))
    off = offset_query(tp["offset"], _t(feats))
    assert (kernels.launches["k4"], kernels.launches["k5"]) == before
    for g, r, k in zip(got, ref, ("rgb", "alpha", "occ")):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL[k], err_msg=k)
    assert off.shape == (1000, 3)
    np.testing.assert_allclose(off.numpy(), ref_off, atol=ATOL["offset"])
    # the bf16 rounding flips stay rare
    assert np.median(np.abs(got[2].numpy() - ref[2])) < 1e-5


def test_k3_wrapper_rejects_bad_sample_and_anchor_counts(packed):
    from avatarcap_tpu_torch.ops.fused_query import MAX_ANCHORS, \
        ray_color_query
    _, tp = packed
    ro = torch.zeros((4, 3))
    pf = torch.zeros((4, 64), dtype=torch.bfloat16)
    bounds = torch.tensor([[-1.0] * 3, [1.0] * 3])

    def call(n_samples, n_anchors):
        return ray_color_query(tp["offset"], tp["template"], ro, ro, pf, pf,
                               torch.zeros((4, n_anchors)), bounds,
                               n_samples=n_samples, near=0.98, far=1.05,
                               threshold=0.08)

    for n_samples, n_anchors in ((1, 4), (0, 4), (8, 1), (8, MAX_ANCHORS + 1)):
        with pytest.raises(ValueError):
            call(n_samples, n_anchors)
    assert call(2, MAX_ANCHORS).shape == (4, 3)


def test_compositor_matches_jax():
    from avatarcap_tpu.ops import volume_render as jvr
    from avatarcap_tpu_torch.ops import volume_render as tvr
    rs = np.random.RandomState(0)
    near = rs.uniform(0.5, 1.0, (3, 7)).astype(np.float32)
    far = near + rs.uniform(0.1, 0.5, (3, 7)).astype(np.float32)
    for S in (2, 7, 64):
        ref = np.asarray(jvr.stratified_z_vals(jnp.asarray(near),
                                               jnp.asarray(far), S, False))
        got = tvr.stratified_z_vals(_t(near), _t(far), S, False)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tvr.z_vals_to_dists(got).numpy(),
                                   np.asarray(jvr.z_vals_to_dists(
                                       jnp.asarray(ref))), atol=1e-6)
    # perturbed depths stay within each sample's bin, in order
    gen = torch.Generator().manual_seed(0)
    z = tvr.stratified_z_vals(_t(near), _t(far), 16, True, gen)
    plain = tvr.stratified_z_vals(_t(near), _t(far), 16, False)
    assert bool((z >= plain[..., :1] - 1e-6).all())
    assert bool((z.diff(dim=-1) >= -1e-6).all())
    assert not torch.equal(z, plain)
    raw = rs.uniform(0.0, 1.0, (21, 9, 4)).astype(np.float32)
    zv = np.sort(rs.uniform(0.5, 1.5, (21, 9)), -1).astype(np.float32)
    for white in (False, True):
        ref = jvr.raw2outputs(jnp.asarray(raw), jnp.asarray(zv), white)
        got = tvr.raw2outputs(_t(raw), _t(zv), white)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def test_render_rays_matches_jax(env):
    """The f32 module path of the color integral (cano points), and the
    masked query for template-space points."""
    from avatarcap_tpu.pipeline.avatar import (avatar_forward,
                                               compute_pose_features,
                                               render_rays)
    from avatarcap_tpu_torch.pipeline import avatar as tav
    ro, rd, _, _ = _rays(env, 64, seed=1)
    depth = np.ones((1, 64), np.float32)
    feat, _ = compute_pose_features(env["module"], env["variables"],
                                    jnp.asarray(env["pos_map"]))
    ref, _ = render_rays(env["module"], env["variables"],
                         jnp.asarray(ro)[None], jnp.asarray(rd)[None],
                         jnp.asarray(depth - 0.05), jnp.asarray(depth + 0.05),
                         jnp.asarray(depth), feat, None, env["jstatics"],
                         n_samples=8, pts_space="cano", near_dist=0.02,
                         far_dist=0.05)
    with torch.no_grad():
        tfeat = tav.compute_pose_features(env["port"], _t(env["pos_map"]))
        got = tav.render_rays(env["port"], _t(ro)[None], _t(rd)[None],
                              _t(depth - 0.05), _t(depth + 0.05), _t(depth),
                              tfeat, env["tstatics"], n_samples=8,
                              pts_space="cano", near_dist=0.02,
                              far_dist=0.05)
    assert np.asarray(ref["rgb_map"]).max() > 1e-2, "degenerate rays"
    for k in ("rgb_map", "acc_map", "depth_map", "raw", "nonrigid_offset"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)

    pts = np.asarray(ro + 0.95 * rd)[None]
    dists = np.full((1, 64), 0.01, np.float32)
    ref, _ = avatar_forward(env["module"], env["variables"], jnp.asarray(pts),
                            jnp.asarray(dists), feat, None, env["jstatics"],
                            pts_space="temp")
    with torch.no_grad():
        got = tav.avatar_forward(env["port"], _t(pts), _t(dists), tfeat,
                                 env["tstatics"], pts_space="temp")
        with pytest.raises(ValueError, match="frame"):   # posed: no frame
            tav.avatar_forward(env["port"], _t(pts), _t(dists), tfeat,
                               env["tstatics"], pts_space="posed")
    np.testing.assert_allclose(got["raw"].numpy(), np.asarray(ref["raw"]),
                               atol=1e-5)
    assert not got["nonrigid_offset"].any()


def test_anchor_distances_and_flags_match_jax(env):
    from avatarcap_tpu.pipeline import capture as jc
    from avatarcap_tpu_torch.pipeline import capture as tc
    ro, rd, _, _ = _rays(env, 300, seed=2)
    v = env["statics_np"]["cano_smpl_vertices"]
    near, far = 0.9, 1.2             # samples up to 20 cm from the body
    for A, S in ((4, 64), (3, 5)):
        ref = np.asarray(jc.anchor_distances(jnp.asarray(ro), jnp.asarray(rd),
                                             near, far, jnp.asarray(v),
                                             n_anchors=A))
        got = tc.anchor_distances(_t(ro), _t(rd), near, far, _t(v),
                                  n_anchors=A).numpy()
        # |q|^2 - 2 q.v + |v|^2 at metre coordinates: the squared distances
        # agree to f32 rounding of the terms (an anchor that sits on a
        # vertex reads ~1e-4 on either side, the root of that rounding)
        np.testing.assert_allclose(got ** 2, ref ** 2, atol=2e-7)
        flags_ref = np.asarray(jc.anchored_near_flags(
            jnp.asarray(ro), jnp.asarray(rd), near, far, S, jnp.asarray(v),
            n_anchors=A))
        flags = tc.anchored_near_flags(_t(ro), _t(rd), near, far, S, _t(v),
                                       n_anchors=A).numpy()
        assert flags.shape == (300, S) and 0 < flags.mean() < 1
        # equal away from the threshold (the f32 distances agree to ~1e-6)
        za = np.linspace(near, far, A)
        d_s = np.stack([np.interp(np.linspace(near, far, S), za, r)
                        for r in ref])
        clear = np.abs(d_s - 0.08) > 1e-4
        np.testing.assert_array_equal(flags[clear], flags_ref[clear])


def test_distance_volume_matches_jax(env):
    from avatarcap_tpu.ops.knn import (near_distance_volume,
                                       sample_distance_volume)
    from avatarcap_tpu_torch.ops import knn as tknn
    v = env["statics_np"]["cano_smpl_vertices"]
    bounds = env["statics_np"]["cano_bounds"]
    ref, res = near_distance_volume(jnp.asarray(v), jnp.asarray(bounds),
                                    voxel=0.05)
    got, tres = tknn.near_distance_volume(_t(v), _t(bounds), voxel=0.05)
    assert tres == tuple(res)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # samples inside the box and up to 0.5 m outside it
    rs = np.random.RandomState(4)
    span = bounds[1] - bounds[0]
    pts = (bounds[0] - 0.5 + rs.rand(2000, 3) * (span + 1.0)).astype(
        np.float32)
    ref_s = np.asarray(sample_distance_volume(ref, jnp.asarray(pts),
                                              jnp.asarray(bounds)))
    got_s = tknn.sample_distance_volume(got, _t(pts), _t(bounds)).numpy()
    np.testing.assert_allclose(got_s, ref_s, atol=1e-5)


def _soup(n_tris, n_keys, seed):
    """A soup whose slots share keys (~6 slots a key), some invalid
    triangles and some -1 keys."""
    rs = np.random.RandomState(seed)
    keys = rs.choice(1 << 20, n_keys, replace=False)
    edge_ids = keys[rs.randint(0, n_keys, 3 * n_tris)].astype(np.int32)
    edge_ids[rs.rand(3 * n_tris) < 0.05] = -1
    tri_valid = np.arange(n_tris) < int(0.8 * n_tris)
    return tri_valid, edge_ids


@pytest.mark.parametrize("capacity", [4096, 300], ids=["fits", "overflows"])
def test_dedupe_soup_equals_jax(capacity):
    from avatarcap_tpu.pipeline.capture import _dedupe_soup
    from avatarcap_tpu_torch.pipeline.capture import _dedupe_soup as tdd
    tri_valid, edge_ids = _soup(2000, 1000, seed=capacity)
    ref = _dedupe_soup(jnp.asarray(tri_valid), jnp.asarray(edge_ids),
                       capacity)
    got = tdd(_t(tri_valid), _t(edge_ids), capacity)
    for name, a, b in zip(("rep", "uo", "valid_v", "valid_u", "overflow"),
                          got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert bool(got[4]) == (capacity == 300)


def test_marching_tets_edge_ids_equal_jax():
    from avatarcap_tpu.ops.marching_cubes import marching_tets
    from avatarcap_tpu_torch.ops.marching_cubes import marching_tets as tmt
    from test_torch_geometry import _field
    vol = _field((22, 19, 17), seed=2)
    bmin = np.array([-0.4, -0.5, -0.3], np.float32)
    voxel = np.array([0.04, 0.05, 0.035], np.float32)
    ref = marching_tets(jnp.asarray(vol), 0.0, jnp.asarray(bmin),
                        jnp.asarray(voxel), max_tris=1 << 13,
                        max_active=1 << 12, gradient_normals=True,
                        with_edge_ids=True)
    got = tmt(_t(vol), 0.0, _t(bmin), _t(voxel), max_tris=1 << 13,
              max_active=1 << 12, gradient_normals=True,
              with_edge_ids=True)
    n = int(ref.num_tris)
    assert int(got.num_tris) == n > 100
    same = np.all(np.abs(got.vertices.numpy() - np.asarray(ref.vertices))
                  < 1e-5, axis=-1)
    assert same.mean() > 0.99
    ids, rids = got.edge_ids.numpy(), np.asarray(ref.edge_ids)
    assert got.edge_ids.dtype == torch.int32
    np.testing.assert_array_equal(ids[same], rids[same])
    assert (ids[3 * n:] == -1).all() and (ids[:3 * n] >= 0).all()
    # a shared vertex carries one key: ~6 slots a key on a closed surface
    assert 3 * n / len(np.unique(ids[:3 * n])) > 4
    assert tmt(_t(vol), 0.0, _t(bmin), _t(voxel), max_tris=1 << 13,
               max_active=1 << 12).edge_ids is None
