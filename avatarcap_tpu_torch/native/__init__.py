"""Host C++ geometry: a BVH for exact closest-point and signed-distance
queries (counterpart of avatarcap_tpu/native/__init__.py: ``MeshBVH``).

``bvh.cpp`` (the JAX package's source and C interface, copied) is built
with ``g++ -O3 -march=native -fopenmp -shared -fPIC`` at first use into
``build/native/`` at the root of the checkout (listed in .gitignore), under
a name that carries a hash of the source, the flags and the host CPU's
model, and loaded with ctypes. Nothing is built at import time. A failed
build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bvh.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_model() -> str:
    """The host CPU's model line: ``-march=native`` ties the library to
    the CPU it was built on, and a checkout may be shared by machines."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.strip()
    except OSError:
        pass
    return platform.machine()


def library_path() -> Path:
    """The library's path, named by a hash of the source, the flags and
    the host CPU's model."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    return BUILD_DIR / f"libavatarbvh-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native BVH (avatarcap_tpu_"
                           "torch/native/bvh.cpp) builds with g++")
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so concurrent builders (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build the native BVH (exit "
                f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    """The BVH library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        lib.bvh_closest_points.restype = None
        lib.bvh_closest_points.argtypes = [
            ctypes.c_void_p, fp, ctypes.c_int, fp, ip, fp, fp]
        lib.bvh_signed_distance.restype = None
        lib.bvh_signed_distance.argtypes = [
            ctypes.c_void_p, fp, ctypes.c_int, fp]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _queries(queries) -> np.ndarray:
    q = np.ascontiguousarray(queries, np.float32)
    if q.ndim != 2 or q.shape[1] != 3:
        raise ValueError(f"queries must be (N, 3), got {q.shape}")
    return q


class MeshBVH:
    """BVH over a triangle mesh for batched host queries (OpenMP across
    queries)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self._lib = load()
        self._verts = np.ascontiguousarray(verts, np.float32)
        self._faces = np.ascontiguousarray(faces, np.int32)
        if self._verts.ndim != 2 or self._verts.shape[1] != 3:
            raise ValueError(f"verts must be (V, 3), got {self._verts.shape}")
        if self._faces.ndim != 2 or self._faces.shape[1] != 3:
            raise ValueError(f"faces must be (F, 3), got {self._faces.shape}")
        if len(self._faces) == 0:
            raise ValueError("a BVH needs at least one face")
        if (self._faces.min() < 0
                or self._faces.max() >= len(self._verts)):
            raise ValueError("face indices out of range")
        self._handle = self._lib.bvh_build(
            _fptr(self._verts), len(self._verts),
            _iptr(self._faces), len(self._faces))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.bvh_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def closest_points(self, queries: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """-> (points (N, 3), face_idx (N,), bary (N, 3), dist (N,))."""
        q = _queries(queries)
        n = len(q)
        pts = np.empty((n, 3), np.float32)
        fid = np.empty((n,), np.int32)
        bary = np.empty((n, 3), np.float32)
        dist = np.empty((n,), np.float32)
        self._lib.bvh_closest_points(self._handle, _fptr(q), n, _fptr(pts),
                                     _iptr(fid), _fptr(bary), _fptr(dist))
        return pts, fid, bary, dist

    def signed_distance(self, queries: np.ndarray) -> np.ndarray:
        """Inside-positive signed distance (N,)."""
        q = _queries(queries)
        sdf = np.empty((len(q),), np.float32)
        self._lib.bvh_signed_distance(self._handle, _fptr(q), len(q),
                                      _fptr(sdf))
        return sdf
