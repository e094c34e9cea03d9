"""The port's Poisson reconstruction (ops/poisson.py) and the KNN-plane TSDF
(tools/preprocess.watertight_from_points), on the CPU, against the JAX
package's.

- ``_indicator_grid`` at res 32, unscreened and screened (10 CG steps),
  within 1e-4 of chi's range: both sum the splat in float32 in their own
  order, and the FFTs round differently.
- ``poisson_reconstruct`` and ``watertight_from_points`` on the noisy
  holey sphere cloud of tests/test_poisson.py: triangle counts within 1%,
  and every vertex of either mesh within 0.1 voxel of the other mesh's
  vertices (a sign flip of chi at one node moves its cells' triangles,
  so the soups are compared as point sets).
- The splat's accumulate is repeatable bit for bit, and leaves the
  caller's deterministic-algorithms setting as it was.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from test_poisson import _noisy_sphere_cloud


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def cloud():
    return _noisy_sphere_cloud(np.random.RandomState(31359), n=20000)


@pytest.mark.parametrize("point_weight", [0.0, 4.0],
                         ids=["unscreened", "screened"])
def test_indicator_grid_matches_jax(cloud, point_weight):
    import jax.numpy as jnp
    from avatarcap_tpu.ops.poisson import _indicator_grid as jgrid
    from avatarcap_tpu_torch.ops.poisson import _indicator_grid
    pts, nrm = cloud
    bmin, bmax = pts.min(0) - 0.15, pts.max(0) + 0.15
    ref = np.asarray(jgrid(jnp.asarray(pts), jnp.asarray(nrm),
                           jnp.asarray(bmin), jnp.asarray(bmax), 32, 1.5,
                           point_weight=point_weight, screen_iters=10))
    got = _indicator_grid(_t(pts), _t(nrm), _t(bmin), _t(bmax), 32, 1.5,
                          point_weight=point_weight,
                          screen_iters=10).numpy()
    scale = ref.max() - ref.min()
    assert got.shape == ref.shape == (32, 32, 32) and scale > 0
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale)


def _point_set_gap(a, b):
    """Largest distance from a point of either set to the other set."""
    return max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max())


@pytest.mark.parametrize("point_weight", [0.0, 4.0],
                         ids=["unscreened", "screened"])
def test_poisson_reconstruct_matches_jax(cloud, point_weight):
    from avatarcap_tpu.ops.poisson import poisson_reconstruct as jpr
    from avatarcap_tpu_torch.ops.poisson import poisson_reconstruct
    pts, nrm = cloud
    res, pad = 48, 0.15
    ref_v, ref_nt = jpr(pts, nrm, res=res, pad=pad,
                        point_weight=point_weight)
    got_v, got_nt, mesh = poisson_reconstruct(
        pts, nrm, res=res, pad=pad, point_weight=point_weight,
        device="cpu", return_mesh=True)
    assert ref_nt > 1000 and abs(got_nt - ref_nt) <= 0.01 * ref_nt
    assert got_v.shape == (3 * got_nt, 3) and not bool(mesh.overflow)
    voxel = ((pts.max(0) - pts.min(0) + 2 * pad) / res).max()
    assert _point_set_gap(got_v, np.asarray(ref_v)) <= 0.1 * voxel
    # the hole at the cap is closed, as the JAX test asks
    rad = np.linalg.norm(got_v, axis=-1)
    assert (got_v[:, 2] / np.maximum(rad, 1e-9) > 0.9).sum() > 50


def test_watertight_from_points_matches_jax(cloud):
    from avatarcap_tpu.tools.preprocess import watertight_from_points as jw
    from avatarcap_tpu_torch.tools.preprocess import watertight_from_points
    pts, nrm = cloud
    voxel = 0.04
    ref_v, ref_nt = jw(pts, nrm, voxel=voxel)
    got_v, got_nt = watertight_from_points(pts, nrm, voxel=voxel,
                                           device="cpu")
    assert ref_nt > 500 and abs(got_nt - ref_nt) <= 0.01 * ref_nt
    assert _point_set_gap(got_v, np.asarray(ref_v)) <= 0.1 * voxel


def test_splat_is_repeatable_and_restores_the_mode():
    from avatarcap_tpu_torch.ops.poisson import _splat
    rng = np.random.RandomState(0)
    n, res = 5000, 16
    f = rng.uniform(0, res - 1 - 1e-4, (n, 3)).astype(np.float32)
    i0 = torch.as_tensor(np.floor(f)).long()
    t = _t(f) - i0
    vals = _t(rng.standard_normal((n, 3)))
    before = torch.are_deterministic_algorithms_enabled()
    a = _splat(vals, i0, t, res)
    b = _splat(vals, i0, t, res)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert torch.equal(a, b)
    # every point's eight trilinear shares land, and sum to its value
    np.testing.assert_allclose(a.sum(0).numpy(), vals.sum(0).numpy(),
                               rtol=1e-4, atol=1e-3)
    ref = np.zeros((res ** 3, 3), np.float64)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                tt = t.double().numpy()
                w = ((tt[:, 0] if dx else 1 - tt[:, 0])
                     * (tt[:, 1] if dy else 1 - tt[:, 1])
                     * (tt[:, 2] if dz else 1 - tt[:, 2]))
                idx = (((i0[:, 0] + dx) * res + i0[:, 1] + dy) * res
                       + i0[:, 2] + dz).numpy()
                np.add.at(ref, idx, vals.double().numpy() * w[:, None])
    np.testing.assert_allclose(a.numpy(), ref, atol=1e-5)
