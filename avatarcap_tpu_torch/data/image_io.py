"""Float image I/O with a format fallback (counterpart of
avatarcap_tpu/data/image_io.py).

The reference stores position and normal maps as EXR. An OpenCV build
without OpenEXR cannot write EXR, so the writer tries EXR, then float TIFF,
then .npy; the reader accepts any of the three for the same logical path.
"""

from __future__ import annotations

import os

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

import cv2 as cv  # noqa: E402
import numpy as np  # noqa: E402

_FALLBACK_EXTS = (".exr", ".tiff", ".npy")


def save_float_image(path_no_ext: str, img: np.ndarray) -> str:
    """Save (H, W, C) float32; returns the path written."""
    img = np.asarray(img, np.float32)
    for ext in _FALLBACK_EXTS:
        p = path_no_ext + ext
        if ext == ".npy":
            np.save(p, img)
            return p
        try:
            if cv.imwrite(p, img):
                return p
        except cv.error:
            continue
    raise RuntimeError(f"could not write float image {path_no_ext}")


def load_float_image(path_or_base: str) -> np.ndarray:
    """Load a float image; if the exact path is missing, try its sibling
    extensions (.exr, .tiff, .npy)."""
    candidates = [path_or_base]
    base, ext = os.path.splitext(path_or_base)
    candidates += [base + e for e in _FALLBACK_EXTS if e != ext]
    for p in candidates:
        if not os.path.exists(p):
            continue
        if p.endswith(".npy"):
            return np.load(p)
        img = cv.imread(p, cv.IMREAD_UNCHANGED)
        if img is not None:
            return img
    raise FileNotFoundError(path_or_base)
