"""The port's host BVH (avatarcap_tpu_torch/native: its own copy of
bvh.cpp, built into build/native/) against the JAX package's, and against
the port's device path (ops/closest_point.py) on the CPU.

One source, one compiler and the same flags: the two libraries give the
same bits on the same queries. Against the device path (KNN candidates +
exact projection, ray-parity sign) the signed distance agrees within
1e-5. A build that cannot run raises with the reason; nothing falls back.
"""

import numpy as np
import pytest
import torch

from conftest import make_toy_smpl_params, uv_sphere


def _queries(n, seed, scale=0.6):
    return (np.random.RandomState(seed).standard_normal((n, 3))
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def jax_native():
    native = pytest.importorskip("avatarcap_tpu.native")
    if not native.available():
        pytest.skip("the JAX package's BVH did not build (g++)")
    return native


@pytest.mark.parametrize("mesh", ["sphere", "toy_body"])
def test_bvh_bit_equal_to_jax(jax_native, mesh):
    from avatarcap_tpu_torch.native import MeshBVH
    if mesh == "sphere":
        verts, faces = uv_sphere(n_lat=20, n_lon=28, radius=0.5)
    else:
        body = make_toy_smpl_params()
        verts, faces = body.v_template, body.faces
    q = _queries(3001, seed=1)
    ref = jax_native.MeshBVH(verts, faces)
    got = MeshBVH(verts, faces)
    for a, b in zip(got.closest_points(q), ref.closest_points(q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.signed_distance(q),
                                  ref.signed_distance(q))


def test_bvh_matches_device_path():
    from avatarcap_tpu_torch.native import MeshBVH
    from avatarcap_tpu_torch.ops.closest_point import signed_distance
    verts, faces = uv_sphere(n_lat=20, n_lon=28, radius=0.5)
    q = _queries(2000, seed=2, scale=0.4)
    bvh = MeshBVH(verts, faces)
    pts, fid, bary, dist = bvh.closest_points(q)
    sdf, cp = signed_distance(torch.as_tensor(q), torch.as_tensor(verts),
                              torch.as_tensor(faces))
    np.testing.assert_allclose(dist, cp.dist.numpy(), atol=1e-5)
    np.testing.assert_allclose(bvh.signed_distance(q), sdf.numpy(),
                               atol=1e-5)
    assert fid.dtype == np.int32 and (fid >= 0).all()
    np.testing.assert_allclose(
        (bary[..., None] * verts[faces[fid]]).sum(1), pts, atol=1e-5)


def test_library_named_by_source_and_built_outside_the_package():
    from avatarcap_tpu_torch import native
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert native.SOURCE.parent not in path.parents
    native.load()
    assert path.exists()


def test_missing_compiler_raises(monkeypatch, tmp_path):
    from avatarcap_tpu_torch import native
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.MeshBVH(*uv_sphere(n_lat=4, n_lon=6))
    assert native._lib is None and not (tmp_path / "native").exists()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from avatarcap_tpu_torch import native
    bad = tmp_path / "bvh.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.load()
    assert "error" in str(err.value)
    assert list((tmp_path / "native").iterdir()) == []


def test_bad_inputs_raise():
    from avatarcap_tpu_torch.native import MeshBVH
    verts, faces = uv_sphere(n_lat=4, n_lon=6)
    with pytest.raises(ValueError, match="out of range"):
        MeshBVH(verts, faces + len(verts))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        MeshBVH(verts, faces).signed_distance(np.zeros((4, 2), np.float32))
