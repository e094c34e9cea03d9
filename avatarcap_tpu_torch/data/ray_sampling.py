"""Host-side training ray sampling in numpy (counterpart of
avatarcap_tpu/data/ray_sampling.py; the reference's utils/nerf_util.py:
102-182).

Body-biased pixel sampling inside the projected bound mask, keeping only
rays that hit the (padded) box, and exactly ``nrays`` of them: one
oversampled vectorised draw, with a filter of the whole pool when the
margin runs out. The numpy RandomState calls are the JAX package's, in
its order, so one seed draws the same rays on both sides.
"""

from __future__ import annotations

import numpy as np
import cv2 as cv

from avatarcap_tpu_torch.ops.rays import get_near_far, get_rays


def project(xyz: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """World points -> pixel coordinates (reference
    utils/nerf_util.py:9-13)."""
    cam = xyz @ RT[:, :3].T + RT[:, 3:].T
    pix = cam @ K.T
    return pix[:, :2] / pix[:, 2:]


def _box_corners(bounds: np.ndarray) -> np.ndarray:
    """The 8 AABB corners, indexed by bits (x, y, z) with 0=min, 1=max."""
    lo, hi = bounds
    side = np.stack([lo, hi])
    bits = ((np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1)
    return side[bits, np.arange(3)]


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """Filled projection of the 3D bound box (reference utils/nerf_util.py:
    38-65): rasterize each of the 6 box faces as a filled polygon.

    Faces are generated by fixing one axis bit and walking the other two
    bits in ring (Gray-code) order, which reproduces the reference's
    hand-written quads exactly — pixel-exact output matters because this
    mask gates which pixels are sampleable.
    """
    corners_2d = np.round(
        project(_box_corners(bounds), K, pose)).astype(int)
    ring = (0b00, 0b01, 0b11, 0b10)  # closed ring over two free bits
    faces = []
    for axis in range(3):
        free = [a for a in range(3) if a != axis]
        shift = np.array([2 - free[0], 2 - free[1]])
        for side in (0, 1):
            base = side << (2 - axis)
            quad = [base | (((r >> 1) & 1) << shift[0])
                    | ((r & 1) << shift[1]) for r in ring]
            faces.append(corners_2d[quad])
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in faces:  # one call per face: multi-contour fillPoly XORs
        cv.fillPoly(mask, [face], 1)
    return mask


def _rays_at(coords, ray_o, kinvT_R):
    """Ray dirs for (y, x) pixel coords only — the training path never
    materializes the dense HxW ray grid (same math as ops/rays.get_rays:
    d = R^T K^{-1} (x, y, 1), normalized)."""
    xy1 = np.stack([coords[:, 1].astype(ray_o.dtype),
                    coords[:, 0].astype(ray_o.dtype),
                    np.ones(len(coords), ray_o.dtype)], axis=-1)
    rd = xy1 @ kinvT_R
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return np.broadcast_to(ray_o, rd.shape), rd


def _draw_hits(pool, ray_o, kinvT_R, bounds, n, rng):
    """Uniformly draw n pixels from ``pool`` whose rays hit the AABB.

    One oversampled vectorized draw covers the common case (acceptance is
    ~1: the pool already lies in the projected box mask); the rare
    undersupply falls back to filtering the whole pool once. No
    accumulate-while loop either way. Rays are computed sparsely at the
    candidate pixels only.
    """
    if n == 0:
        e = np.zeros((0,), np.float32)
        z3 = np.zeros((0, 3), np.float32)
        return np.zeros((0, 2), np.int64), e, e, z3, z3
    cand = pool[rng.randint(0, len(pool), n + n // 4 + 16)]
    ro, rd = _rays_at(cand, ray_o, kinvT_R)
    near, far, hit = get_near_far(bounds, ro, rd)
    ok = np.flatnonzero(hit)
    if len(ok) < n:  # rare: silhouette-boundary misses ate the margin
        ro, rd = _rays_at(pool, ray_o, kinvT_R)
        near, far, hit = get_near_far(bounds, ro, rd)
        cand, ok_pool = pool, np.flatnonzero(hit)
        if len(ok_pool) == 0:
            raise ValueError(
                f"no ray in a {len(pool)}-pixel pool intersects the AABB "
                f"bounds {np.asarray(bounds).tolist()} — the camera likely "
                "does not see the (padded) body box for this view")
        ok = ok_pool[rng.randint(0, len(ok_pool), n)]
    sel = ok[:n]
    return cand[sel], near[sel], far[sel], ro[sel], rd[sel]


def sample_rays(img, msk, K, R, T, bounds, nrays, training=True,
                body_sample_ratio=0.8, rng: np.random.RandomState = None):
    """Sample nrays (training) or all box&body rays (test) for one view.

    Training contract (reference utils/nerf_util.py:102-166): 80% of rays
    land on body-mask pixels, the rest anywhere in the projected bound
    mask; every returned ray intersects the (padded) canonical AABB; rgb is
    zeroed outside the bound mask.
    """
    if rng is None:
        rng = np.random
    H, W = img.shape[:2]
    pose = np.concatenate([R, T], axis=1)
    bound_mask = get_bound_2d_mask(bounds, K, pose, H, W)
    img = np.where(bound_mask[..., None] == 1, img, 0)
    msk = msk * bound_mask

    if training:
        # Sparse path: rays only at sampled pixels (~nrays of HxW).
        ray_o = -(R.T @ np.reshape(T, (3,))).astype(np.float32)
        kinvT_R = (np.linalg.inv(K).T @ R).astype(np.float32)
        bounds = np.asarray(bounds, np.float32)
        n_body = int(nrays * body_sample_ratio)
        body_pool = np.argwhere(msk > 0)
        bound_pool = np.argwhere(bound_mask > 0)
        cb, nb, fb, ob, db = _draw_hits(body_pool, ray_o, kinvT_R, bounds,
                                        n_body, rng)
        cr, nr, fr, orr, dr = _draw_hits(bound_pool, ray_o, kinvT_R, bounds,
                                         nrays - n_body, rng)
        coord = np.concatenate([cb, cr], axis=0)
        near = np.concatenate([nb, nr])
        far = np.concatenate([fb, fr])
        return {
            "rgb": img[coord[:, 0], coord[:, 1]].astype(np.float32),
            "body_mask": (msk[coord[:, 0], coord[:, 1]] > 0)
            .astype(np.float32),
            "ray_o": np.concatenate([ob, orr]).astype(np.float32),
            "ray_d": np.concatenate([db, dr]).astype(np.float32),
            "near": near.astype(np.float32),
            "far": far.astype(np.float32),
            "coord": coord,
        }

    rays_o, rays_d = get_rays(H, W, K, R, T)
    bounds = np.asarray(bounds, rays_o.dtype)

    # Test mode: every pixel whose ray hits the box AND lies on the body
    # mask, compacted. (The reference's test branch keeps near/far at
    # box-hit length while compacting rgb/rays to box&body — a latent
    # length mismatch in an unused path, utils/nerf_util.py:167-181; here
    # every output is filtered by the same final mask.)
    ro = rays_o.reshape(-1, 3)
    rd = rays_d.reshape(-1, 3)
    near, far, box_mask = get_near_far(bounds, ro, rd)
    final = box_mask & (msk.reshape(-1) > 0)
    keep = np.flatnonzero(final)
    return {
        "rgb": img.reshape(-1, 3)[keep].astype(np.float32),
        "body_mask": (msk.reshape(-1)[keep] > 0).astype(np.float32),
        "ray_o": ro[keep].astype(np.float32),
        "ray_d": rd[keep].astype(np.float32),
        "near": near[keep].astype(np.float32),
        "far": far[keep].astype(np.float32),
        "coord": np.stack(np.unravel_index(keep, (H, W)), axis=1),
    }
