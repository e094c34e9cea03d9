"""Frozen copy of avatarcap_tpu_torch/utils/toy_body.py at commit 2621afd, the f32 reference path of the benchmark.

Toy body model: a closed capsule-like mesh with SMPL-like structure, so
nothing depends on the licensed SMPL files (a copy of
avatarcap_tpu/utils/toy_body.py for the port)."""

import numpy as np

from benchmark.reference.smpl import SmplParams


def uv_sphere(n_lat=9, n_lon=12, radius=1.0):
    """Closed UV-sphere triangle mesh (verts, faces)."""
    verts = [[0.0, radius, 0.0]]
    for i in range(1, n_lat):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append([radius * np.sin(theta) * np.cos(phi),
                          radius * np.cos(theta),
                          radius * np.sin(theta) * np.sin(phi)])
    verts.append([0.0, -radius, 0.0])
    south = len(verts) - 1
    faces = []
    for j in range(n_lon):
        faces.append([0, 1 + (j + 1) % n_lon, 1 + j])
    for i in range(n_lat - 2):
        a = 1 + i * n_lon
        b = 1 + (i + 1) * n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append([a + j, a + j2, b + j])
            faces.append([a + j2, b + j2, b + j])
    base = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append([south, base + j, base + (j + 1) % n_lon])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32))


def make_toy_smpl_params(num_joints=24, num_shapes=10, seed=0, n_lat=10,
                         n_lon=12):
    """A structurally valid fake body model: squashed UV sphere (~70 cm),
    joints along the vertical axis, Gaussian skinning weights. (77, 90)
    gives 6,752 vertices, close to real SMPL's 6,890."""
    rs = np.random.RandomState(seed)
    v_template, faces = uv_sphere(n_lat=n_lat, n_lon=n_lon)
    v_template[:, 1] *= 0.8
    v_template *= 0.35
    num_vertices = v_template.shape[0]
    joint_y = np.linspace(-0.25, 0.25, num_joints).astype(np.float32)
    joints = np.stack([np.zeros(num_joints), joint_y,
                       np.zeros(num_joints)], -1).astype(np.float32)
    parents = np.zeros(num_joints, np.int32)
    for j in range(1, num_joints):
        parents[j] = j - 1
    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)
    w = np.exp(-(d / 0.12) ** 2).astype(np.float32) + 1e-6
    w /= w.sum(-1, keepdims=True)
    j_reg = np.exp(-(d.T / 0.05) ** 2).astype(np.float32) + 1e-8
    j_reg /= j_reg.sum(-1, keepdims=True)
    shapedirs = 0.01 * rs.standard_normal(
        (num_vertices * 3, num_shapes)).astype(np.float32)
    return SmplParams(
        v_template=v_template, faces=faces, joints_template=joints,
        kintree_parents=parents, weights=w, j_regressor=j_reg,
        shapedirs=shapedirs)


def write_smpl_pkl(params: SmplParams, path: str) -> None:
    """Write ``params`` as an official-layout SMPL pkl (the fields
    SmplParams.load reads: kintree_table (2, J), shapedirs (V, 3, S)), so
    that a toy body goes through the loader real SMPL files take."""
    import pickle
    J = params.num_joints
    kintree = np.stack([np.asarray(params.kintree_parents, np.int64),
                        np.arange(J, dtype=np.int64)])
    data = {"v_template": params.v_template, "f": params.faces,
            "J": params.joints_template, "kintree_table": kintree,
            "weights": params.weights, "J_regressor": params.j_regressor,
            "shapedirs": params.shapedirs.reshape(
                params.num_vertices, 3, -1)}
    with open(path, "wb") as f:
        pickle.dump(data, f)
