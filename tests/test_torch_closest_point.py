"""The port's closest point / signed distance (ops/closest_point.py, on the
CPU) against the JAX package's, on a UV sphere and on the small toy body,
at points within a few cm of the surface, N not a multiple of the chunk.
Both take their k = 32 candidates from a KNN over face centroids and
project exactly: distances within 1e-5; face ids equal for at least 99.9%
of the points that project inside a face (onto a shared edge or vertex
the faces tie, and rounding picks one on each side: the port's face is
then as near, within 1e-6), points and barycentric coordinates within
1e-4 where the faces agree; signs equal."""

import numpy as np
import pytest
import torch

from conftest import make_toy_smpl_params, uv_sphere


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _meshes():
    v, f = uv_sphere(n_lat=16, n_lon=24, radius=0.5)
    body = make_toy_smpl_params()
    return {"sphere": (v, f), "toy_body": (body.v_template, body.faces)}


def _near_surface(verts, faces, n, seed):
    """n points on random faces, moved by 2 cm N(0, 1) noise: the queries
    of the preprocessing (scan points near the body)."""
    rng = np.random.RandomState(seed)
    tri = verts[faces[rng.randint(0, len(faces), n)]]
    w = rng.dirichlet(np.ones(3), n)[..., None]
    return ((tri * w).sum(1)
            + 0.02 * rng.standard_normal((n, 3))).astype(np.float32)


def _face_distance(q, verts, faces, fids):
    from avatarcap_tpu_torch.ops.closest_point import \
        _point_triangle_closest
    t = _t(verts[faces[fids]])
    p, _ = _point_triangle_closest(_t(q), t[:, 0], t[:, 1], t[:, 2])
    return (p - _t(q)).norm(dim=-1).numpy()


@pytest.mark.parametrize("name", ["sphere", "toy_body"])
def test_closest_point_matches_jax(name):
    import jax.numpy as jnp
    from avatarcap_tpu.ops.closest_point import closest_point_on_mesh as jcp
    from avatarcap_tpu_torch.ops.closest_point import closest_point_on_mesh
    verts, faces = _meshes()[name]
    q = _near_surface(verts, faces, 1237, seed=3)
    ref = jcp(jnp.asarray(q), jnp.asarray(verts), jnp.asarray(faces),
              chunk=512)
    got = closest_point_on_mesh(_t(q), _t(verts), torch.as_tensor(faces),
                                chunk=512)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               atol=1e-5)
    fid, ref_fid = got.face_idx.numpy(), np.asarray(ref.face_idx)
    assert got.face_idx.dtype == torch.int32
    same = fid == ref_fid
    # a point may project onto an edge or vertex that several faces share
    # (or lie as near two faces): ties, decided by rounding on each side;
    # the face the port took is then as near as JAX's
    np.testing.assert_allclose(
        _face_distance(q[~same], verts, faces, fid[~same]),
        _face_distance(q[~same], verts, faces, ref_fid[~same]), atol=1e-6)
    interior = (np.asarray(ref.bary) > 1e-4).all(-1)
    assert interior.sum() > 300 and same[interior].mean() >= 0.999
    np.testing.assert_allclose(got.points.numpy()[same],
                               np.asarray(ref.points)[same], atol=1e-4)
    np.testing.assert_allclose(got.bary.numpy()[same],
                               np.asarray(ref.bary)[same], atol=1e-4)
    # the barycentric coordinates rebuild the point on its face
    tri = verts[faces[fid]]
    np.testing.assert_allclose((got.bary.numpy()[..., None] * tri).sum(1),
                               got.points.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["sphere", "toy_body"])
def test_signed_distance_matches_jax(name):
    import jax.numpy as jnp
    from avatarcap_tpu.ops.closest_point import signed_distance as jsd
    from avatarcap_tpu_torch.ops.closest_point import signed_distance
    verts, faces = _meshes()[name]
    q = _near_surface(verts, faces, 901, seed=4)
    ref, _ = jsd(jnp.asarray(q), jnp.asarray(verts), jnp.asarray(faces))
    got, cp = signed_distance(_t(q), _t(verts), torch.as_tensor(faces))
    ref = np.asarray(ref)
    assert (got.numpy() > 0).sum() > 50 and (got.numpy() < 0).sum() > 50
    np.testing.assert_array_equal(np.sign(got.numpy()), np.sign(ref))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    outside, _ = signed_distance(_t(q), _t(verts), torch.as_tensor(faces),
                                 inside_positive=False)
    np.testing.assert_array_equal(outside.numpy(), -got.numpy())


def test_point_triangle_regions_match_jax():
    """Every Voronoi region of a triangle (3 vertices, 3 edges, the
    interior) and degenerate triangles, against the JAX projection."""
    import jax.numpy as jnp
    from avatarcap_tpu.ops.closest_point import _point_triangle_closest as jp
    from avatarcap_tpu_torch.ops.closest_point import \
        _point_triangle_closest
    rng = np.random.RandomState(5)
    n = 4000
    a, b, c = (rng.standard_normal((3, n, 3)) * 0.2).astype(np.float32)
    b[:50] = a[:50]                          # degenerate: a == b
    c[50:100] = a[50:100] + 0.5 * (b[50:100] - a[50:100])  # collinear
    p = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    ref_pt, ref_bary = jp(*(jnp.asarray(x) for x in (p, a, b, c)))
    pt, bary = _point_triangle_closest(*(_t(x) for x in (p, a, b, c)))
    np.testing.assert_allclose(bary.numpy(), np.asarray(ref_bary),
                               atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(ref_pt), atol=1e-5)
    assert (bary.numpy() == 1.0).any(-1).sum() > 100   # vertex regions hit


def test_candidate_search_takes_no_gradient():
    """Gradients reach the query points through the exact projection."""
    from avatarcap_tpu_torch.ops.closest_point import closest_point_on_mesh
    verts, faces = _meshes()["sphere"]
    q = _t(np.array([[0.9, 0.1, 0.0], [0.0, 0.0, 0.2]])).requires_grad_()
    cp = closest_point_on_mesh(q, _t(verts), torch.as_tensor(faces))
    cp.dist.sum().backward()
    g = q.grad.numpy()
    assert np.isfinite(g).all()
    # d|q - c(q)|/dq is the unit direction away from the surface
    np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0, atol=1e-4)
