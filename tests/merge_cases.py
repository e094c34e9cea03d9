"""The normal-fusion merge's test inputs and the JAX package's results on
them, shared by tests/test_torch_fusion.py (on the CPU, beside JAX) and
tests/test_torch_cuda.py (on the card, where JAX is not installed). This
module imports neither JAX nor the JAX package.

``JAX_FIXTURE`` holds avatarcap_tpu.fusion.normal_fusion's
merge_normal_images on ``merge_inputs()`` for each of ``JAX_CASES``,
computed on the CPU in float32 (JAX matmuls at "highest"), under the key
``case_name``. tests/test_torch_fusion.py::test_merge_jax_fixture_is_current
holds the file to the JAX package; regenerate it after a change there with

    JAX_PLATFORMS=cpu python -m tests.merge_cases
"""

import os

import numpy as np

JAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "merge_jax.npz")
# (iter_num, neck_xy): test_merge_matches_jax's cases and the capture's
# 100 steps
JAX_CASES = [(4, (64, 120)), (20, (64, 120)), (4, (64, 50)),
             (100, (64, 120))]


def case_name(iter_num, neck):
    return f"iters{iter_num}_neck{neck[0]}_{neck[1]}"


def merge_inputs(H=128, seed=0):
    """Avatar normals tilted from noisy image normals on overlapping discs
    (the image disc is smaller, so erosion and the distance blend act)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:H]
    c = H / 2
    src_disc = (yy - c) ** 2 + (xx - c) ** 2 < (0.4 * H) ** 2
    tar_disc = (yy - c - 3) ** 2 + (xx - c) ** 2 < (0.33 * H) ** 2
    n = rs.normal(0, 0.2, (H, H, 3)).astype(np.float32)
    n[..., 2] += 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tilt = np.array([[1, 0, 0], [0, 0.97, -0.24], [0, 0.24, 0.97]],
                    np.float32)
    src = np.where(src_disc[..., None], n @ tilt.T, 0).astype(np.float32)
    tar = np.where(tar_disc[..., None], n, 0).astype(np.float32)
    return src, tar


def jax_merge(iter_num, neck):
    """The JAX package's merge on merge_inputs() (needs JAX)."""
    import jax.numpy as jnp
    from avatarcap_tpu.fusion.normal_fusion import merge_normal_images
    src, tar = merge_inputs()
    return np.asarray(merge_normal_images(
        jnp.asarray(src), jnp.asarray(tar), jnp.asarray(neck, jnp.int32),
        iter_num=iter_num))


def load_jax_fixture():
    with np.load(JAX_FIXTURE) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    np.savez_compressed(JAX_FIXTURE, **{
        case_name(i, n): jax_merge(i, n) for i, n in JAX_CASES})
    print(JAX_FIXTURE, os.path.getsize(JAX_FIXTURE), "bytes")
