"""Mesh file I/O (counterpart of avatarcap_tpu/data/mesh_io.py): text OBJ,
and binary little-endian PLY with optional per-vertex normals and uint8
colors, as the reference's utils/obj_io.py writes them. Host-side, numpy
only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: vertices + triangle faces (1-based -> 0-based)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:4]]
                faces.append([int(i) - 1 for i in idx])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32))


def save_obj(path: str, vertices: np.ndarray,
             faces: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write("v %f %f %f\n" % (v[0], v[1], v[2]))
        if faces is not None:
            for fc in np.asarray(faces):
                f.write("f %d %d %d\n" % (fc[0] + 1, fc[1] + 1, fc[2] + 1))


def save_ply(path: str, vertices: np.ndarray,
             faces: Optional[np.ndarray] = None,
             normals: Optional[np.ndarray] = None,
             colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY with optional per-vertex normals and colors
    (float colors in [0,1] are quantized to uint8, matching the reference
    writer, utils/obj_io.py:200-269)."""
    vertices = np.asarray(vertices, np.float32)
    n = vertices.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        cols = [vertices]
        if normals is not None:
            cols.append(np.asarray(normals, np.float32))
        fbytes = np.concatenate(cols, axis=-1).astype("<f4").tobytes()
        if colors is not None:
            c = np.asarray(colors)
            if c.dtype != np.uint8:
                c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
            # interleave: per-vertex float block then color block
            stride_f = 3 + (3 if normals is not None else 0)
            fview = np.frombuffer(fbytes, np.uint8).reshape(n, 4 * stride_f)
            rows = np.concatenate([fview, c], axis=-1)
            f.write(rows.tobytes())
        else:
            f.write(fbytes)
        if faces is not None:
            fc = np.asarray(faces, np.int32)
            counts = np.full((len(fc), 1), 3, np.uint8)
            rows = np.concatenate(
                [counts, fc.astype("<i4").view(np.uint8).reshape(len(fc), 12)],
                axis=-1)
            f.write(rows.tobytes())


def load_ply(path: str):
    """Binary little-endian PLY reader for files written by save_ply."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    n_vert = n_face = 0
    props = []
    cur = None
    for line in header:
        if line.startswith("element vertex"):
            n_vert = int(line.split()[-1])
            cur = "v"
        elif line.startswith("element face"):
            n_face = int(line.split()[-1])
            cur = "f"
        elif line.startswith("property") and cur == "v":
            props.append(tuple(line.split()[1:]))
    n_float = sum(1 for p in props if p[0] == "float")
    n_uchar = sum(1 for p in props if p[0] == "uchar")
    stride = 4 * n_float + n_uchar
    body = data[head_end:]
    vdata = np.frombuffer(body[:n_vert * stride], np.uint8).reshape(
        n_vert, stride)
    floats = vdata[:, :4 * n_float].copy().view("<f4")
    verts = floats[:, :3]
    normals = floats[:, 3:6] if n_float >= 6 else None
    colors = vdata[:, 4 * n_float:] if n_uchar else None
    faces = None
    if n_face:
        fdata = np.frombuffer(body[n_vert * stride:
                                   n_vert * stride + n_face * 13],
                              np.uint8).reshape(n_face, 13)
        faces = fdata[:, 1:].copy().view("<i4")
    return verts, faces, normals, colors
