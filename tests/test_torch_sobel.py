"""The Sobel normals (ops/sobel.py), mesh_grid_coords and
marching_tets(normal_volume=) of the port against the JAX package, and the
capture's three normal modes through ``_extract_mesh``, on numpy-seeded
fields.

Both sides run the same float32 operations in the same order, so the
gradient volume agrees to float32 rounding (atol 1e-6 on gradients of
size ~10). Resampled normals are unit vectors from a trilinear fetch:
atol 1e-5. marching_tets carries the corner gradients as bf16 on both
sides (the same roundings of the same f32 values), so meshes and normals
agree slot by slot to float32 rounding: vertices atol 1e-6, normals 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_geometry import _field, _t

BMIN = np.array([-0.4, -0.5, -0.3], np.float32)
VOXEL = np.array([0.04, 0.05, 0.035], np.float32)


def test_extract_normal_volume_matches_jax():
    from avatarcap_tpu.ops.sobel import extract_normal_volume
    from avatarcap_tpu_torch.ops.sobel import extract_normal_volume as tnv
    vol = _field((22, 19, 17), seed=3)
    ref = np.asarray(extract_normal_volume(jnp.asarray(vol),
                                           jnp.asarray(VOXEL)))
    got = tnv(_t(vol), _t(VOXEL)).numpy()
    assert got.shape == (22, 19, 17, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the zero boundary: an x-gradient at x = 0 sees a zero plane below
    assert np.abs(got[0, ..., 0]).max() > 1.0


def test_sample_volume_normals_and_grid_coords_match_jax():
    from avatarcap_tpu.ops.marching_cubes import mesh_grid_coords
    from avatarcap_tpu.ops.sobel import sample_volume_normals
    from avatarcap_tpu_torch.ops.marching_cubes import (
        mesh_grid_coords as tgc)
    from avatarcap_tpu_torch.ops.sobel import sample_volume_normals as tsn
    vol = _field((22, 19, 17), seed=4)
    bounds = np.stack([BMIN, BMIN + VOXEL * [22, 19, 17]]).astype(np.float32)
    rs = np.random.RandomState(0)
    # points inside the bounds and a few past them (border padding)
    pts = (bounds[0] + rs.uniform(-0.1, 1.1, (500, 3))
           * (bounds[1] - bounds[0])).astype(np.float32)
    ref_g = np.asarray(mesh_grid_coords(jnp.asarray(pts),
                                        jnp.asarray(bounds)))
    got_g = tgc(_t(pts), _t(bounds)).numpy()
    np.testing.assert_allclose(got_g, ref_g, atol=1e-6)
    ref = np.asarray(sample_volume_normals(jnp.asarray(vol),
                                           jnp.asarray(VOXEL),
                                           jnp.asarray(ref_g)))
    got = tsn(_t(vol), _t(VOXEL), _t(ref_g)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("caps", [(1 << 13, 1 << 12), (600, 200)],
                         ids=["fits", "overflows"])
def test_marching_tets_normal_volume_matches_jax(caps):
    from avatarcap_tpu.ops.marching_cubes import marching_tets
    from avatarcap_tpu.ops.sobel import extract_normal_volume
    from avatarcap_tpu_torch.ops.marching_cubes import marching_tets as tmt
    from avatarcap_tpu_torch.ops.sobel import extract_normal_volume as tnv
    max_tris, max_active = caps
    vol = _field((22, 19, 17), seed=5)
    nvol = extract_normal_volume(jnp.asarray(vol), jnp.asarray(VOXEL))
    ref = marching_tets(jnp.asarray(vol), 0.0, jnp.asarray(BMIN),
                        jnp.asarray(VOXEL), max_tris=max_tris,
                        max_active=max_active, normal_volume=nvol,
                        with_edge_ids=True)
    got = tmt(_t(vol), 0.0, _t(BMIN), _t(VOXEL), max_tris=max_tris,
              max_active=max_active, normal_volume=tnv(_t(vol), _t(VOXEL)),
              with_edge_ids=True)
    assert int(got.num_tris) == int(ref.num_tris) > 100
    assert bool(got.overflow) == bool(ref.overflow)
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(ref.vertices), atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(ref.normals),
                               atol=1e-5)
    np.testing.assert_array_equal(got.edge_ids.numpy(),
                                  np.asarray(ref.edge_ids))
    # without a normal volume or gradient normals there are none
    assert tmt(_t(vol), 0.0, _t(BMIN), _t(VOXEL), max_tris=max_tris,
               max_active=max_active, gradient_normals=False).normals is None


@pytest.mark.parametrize("mode", ["trilinear", "mc_edge", "sobel_sample"])
def test_extract_mesh_normal_modes_match_jax(mode):
    """The capture's _extract_mesh in each normal mode, slot for slot
    (sobel_sample samples the padding slots too, at the grid point of the
    origin, as the JAX function does)."""
    from avatarcap_tpu.pipeline.capture import CaptureGrid, _extract_mesh
    from avatarcap_tpu_torch.pipeline.capture import (CaptureGrid as TGrid,
                                                      _extract_mesh as tex)
    res = (22, 19, 17)
    vol = _field(res, seed=6).reshape(-1)
    bounds = np.stack([BMIN, BMIN + VOXEL * np.array(res)]).astype(np.float32)
    empty = np.zeros((0,), np.int32)
    jg = CaptureGrid(jnp.zeros((0, 3)), jnp.asarray(empty),
                     jnp.asarray(vol), res)
    tg = TGrid(torch.zeros((0, 3)), _t(empty), _t(vol), res)
    ref = _extract_mesh(jnp.asarray(vol), jg, jnp.asarray(bounds), 0.0,
                        1 << 13, 1 << 12, mode)
    got = tex(_t(vol), tg, _t(bounds), 0.0, 1 << 13, 1 << 12, mode)
    n = int(ref.num_tris)
    assert int(got.num_tris) == n > 100
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(ref.vertices), atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(ref.normals),
                               atol=1e-5)


def test_normal_modes_agree_on_a_smooth_field():
    """On a smooth field the three modes' normals point the same way: the
    mean dot product of each Sobel mode with the trilinear gradient's over
    the soup is above 0.95 (the modes differ by the Sobel smoothing)."""
    from avatarcap_tpu_torch.pipeline.capture import (CaptureGrid,
                                                      _extract_mesh)
    res = (30, 30, 30)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, n) for n in res],
                             indexing="ij"), -1)
    vol = (0.7 - np.linalg.norm(g * [1.0, 1.3, 0.8], axis=-1)
           ).astype(np.float32).reshape(-1)
    bounds = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    grid = CaptureGrid(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32),
                       _t(vol), res)
    meshes = {m: _extract_mesh(_t(vol), grid, _t(bounds), 0.0, 1 << 14,
                               1 << 13, m)
              for m in ("trilinear", "mc_edge", "sobel_sample")}
    valid = meshes["trilinear"].valid.repeat_interleave(3)
    base = meshes["trilinear"].normals[valid]
    for mode in ("mc_edge", "sobel_sample"):
        assert int(meshes[mode].num_tris) == int(meshes["trilinear"].num_tris)
        dot = (meshes[mode].normals[valid] * base).sum(-1)
        assert float(dot.mean()) > 0.95, (mode, float(dot.mean()))
