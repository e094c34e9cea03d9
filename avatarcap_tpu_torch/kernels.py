"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded through ``ctypes`` -- no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at
the root of the checkout (listed in .gitignore) under a name that carries
a hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so
a changed source or header is rebuilt. Builds
happen at first use, or all at once, in parallel, through ``build_all``.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
SOURCES = ("warp_template_query", "recon_decode", "ray_color_query",
           "template_offset_query", "normal_merge", "recon_decode_wide",
           "nearest_vertex")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def source_constants(*files: str) -> Dict[str, int]:
    """The integer ``constexpr`` constants that the given ``csrc`` files
    state, evaluated in order (each may use the ones before it); those of
    a type size are left out. An integer ``#define`` of any of the files
    is known to all of them; one inside ``#ifndef`` of its own name is a
    default, which a plain one overrides. The tests hold the Python side's
    numbers to them."""
    texts = [(CSRC / name).read_text() for name in files]
    env: Dict[str, int] = {}
    defaults: Dict[str, int] = {}
    for text in texts:
        for guard, key, value in re.findall(
                r"^(?:#ifndef (\w+)\n)?#define (\w+) (\d+)$", text, re.M):
            (defaults if guard == key else env).setdefault(key, int(value))
    for key, value in defaults.items():
        env.setdefault(key, value)
    for text in texts:
        for key, expr in re.findall(
                r"^constexpr (?:int|size_t) (k\w+) =\s*([^;]+);", text, re.M):
            if "sizeof" in expr:
                continue
            # C++ integer division
            env[key] = eval(expr.replace("/", "//"), {"__builtins__": {}},
                            env)  # noqa: S307 (integer arithmetic only)
    return env


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns {name: {"seconds", "log", "path"}} (log = ptxas
    resource report). Raises with the compiler output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        report[name] = {"seconds": secs, "log": log, "path": str(out)}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def c_functions(name: str, prefix: str, launch_argtypes):
    """(launch, error_string) C functions of the built library
    ``csrc/<name>.cu``, with their signatures declared."""
    lib = load(name)
    launch = getattr(lib, f"{prefix}_launch")
    launch.argtypes = launch_argtypes
    launch.restype = ctypes.c_int
    err_str = getattr(lib, f"{prefix}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return launch, err_str


def raise_on(err: int, err_str, what: str) -> None:
    """Raise with the CUDA error's text when a launch returned one."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + err_str(err).decode())
