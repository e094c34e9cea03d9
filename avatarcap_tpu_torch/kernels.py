"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded through ``ctypes`` -- no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at
the root of the checkout (listed in .gitignore) under a name that carries
a hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so
a changed source or header is rebuilt. Builds
happen at first use, or all at once, in parallel, through ``build_all``.
Nothing is built or loaded at import time.

Every kernel is called through ``launch``, by its key in ``KERNELS``,
which also counts the call in ``launches``.
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
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
# each kernel's key: (its source csrc/<library>.cu, the prefix of its
# <prefix>_launch and <prefix>_error_string C functions)
KERNELS = {"k1": ("warp_template_query", "wtq"),
           "k2": ("recon_decode", "recon_decode"),
           "k2w": ("recon_decode_wide", "recon_decode_wide"),
           "k3": ("ray_color_query", "rcq"),
           "k4": ("template_offset_query", "tq"),
           "k5": ("template_offset_query", "oq"),
           "merge": ("normal_merge", "nm"),
           "knn": ("nearest_vertex", "nearest_vertex")}
SOURCES = tuple(dict.fromkeys(lib for lib, _ in KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[str, tuple] = {}

# each kernel's launches in this process, by its key in KERNELS
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


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


def _functions(kernel: str, argtypes) -> tuple:
    """(launch, error_string) C functions of ``kernel``, with their
    signatures declared, loaded once."""
    fns = _FUNCTIONS.get(kernel)
    if fns is None:
        library, prefix = KERNELS[kernel]
        lib = load(library)
        fn = getattr(lib, f"{prefix}_launch")
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{prefix}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        fns = _FUNCTIONS[kernel] = (fn, err_str)
    return fns


def launch(kernel: str, argtypes: Sequence, args: Sequence, device) -> None:
    """Call ``kernel`` (a key of KERNELS) with ``args`` (of ctypes types
    ``argtypes``) and the current stream of the CUDA ``device``, built and
    loaded at its first call; raise with the kernel's error text if the
    launch failed, else count it in ``launches``. Nothing synchronises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{kernel} launches on a CUDA device, got {device}")
    fn, err_str = _functions(kernel, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           + err_str(err).decode())
    launches[kernel] += 1


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches since ``before``, a copy of ``launches``."""
    return {k: n - before[k] for k, n in launches.items()}
