"""AvatarCap dataset (counterpart of avatarcap_tpu/data/dataset.py; the
reference's dataset/avatarcap_dataset.py), in training and test mode.

The same on-disk layout (dataConfig.yaml, smpl/pose_*.txt, smpl/shape.txt,
smpl/smpl_pos_map_*.exr, imgs/..., cano_pts_ov/*.npz) and the same item
contract. An item is assembled on the host in numpy and OpenCV, with the
JAX package's numpy RandomState calls in its order, so one seed gives the
same rays and points on both sides. The SMPL forward kinematics runs once
per pose in torch on the host CPU and is cached.

Test mode builds the subject's canonical query grid once, on a device
(the card unless the caller names the CPU): the full grid, the near-body
band (within 10 cm of a canonical SMPL vertex), the inside / outside prior
of every other node from the ray-parity inside test, and the band's nodes
compacted in ascending order and padded to a multiple of 65,536 with the
out-of-range index.
"""

from __future__ import annotations

import glob
import math
import os
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

import cv2 as cv  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

from avatarcap_tpu_torch.body.smpl import (  # noqa: E402
    SmplParams, canonical_pose, smpl_forward_batch)
from avatarcap_tpu_torch.data.image_io import load_float_image  # noqa: E402
from avatarcap_tpu_torch.data.ray_sampling import sample_rays  # noqa: E402
from avatarcap_tpu_torch.device import resolve_device  # noqa: E402
from avatarcap_tpu_torch.ops.inside import points_inside_mesh  # noqa: E402
from avatarcap_tpu_torch.ops.knn import knn  # noqa: E402

SAMPLED_RAY_NUM = 1024       # reference dataset/avatarcap_dataset.py:239
SURFACE_PTS_PER_ITEM = 5000  # reference :285
VOLUME_PTS_PER_ITEM = SURFACE_PTS_PER_ITEM // 16  # reference :286
NEAR_BODY_DIST = 0.1         # the test grid's band, reference :114
GRID_PAD = 65536             # the compacted band's padding multiple

# per-pose arrays device_batches keeps on the device and gathers by pose
_PER_POSE = ("smpl_pos_map", "smpl_pose", "live_smpl_v",
             "cano2live_jnt_mats")
# per-subject arrays it broadcasts to the batch
_PER_SUBJECT = ("cano2posmap_jnt_mats", "cano_bounds", "cano_smpl_center",
                "cano_smpl_jnts")

# Forked process-pool workers inherit the dataset through this module
# global, set just before the fork: submitting a bound method would pickle
# the whole dataset (position maps and presampled points) per task.
_FORK_DATASET = None


def _fork_getitem(index: int, seed: int, light: bool):
    return _FORK_DATASET.__getitem__(
        index, np.random.RandomState(seed), light=light)


class AvatarCapDataset:
    """``training=False`` builds the test grid at ``vol_res`` on ``device``
    (None = the card; raises without one); training mode reads neither."""

    def __init__(self, data_dir: str, training: bool,
                 smpl_params: SmplParams, vol_res=(384, 384, 128),
                 training_data_ids=None, device=None):
        self.data_dir = data_dir
        self.training = training
        self.smpl_params = smpl_params

        with open(os.path.join(data_dir, "dataConfig.yaml"),
                  encoding="UTF-8") as f:
            self.data_config = yaml.safe_load(f)

        self.smpl_pose_list = sorted(
            glob.glob(os.path.join(data_dir, "smpl/pose_*.txt")))
        self.data_type = self.data_config.get("data_type", "synthetic")
        if self.data_type == "synthetic":
            self.color_img_list = sorted(glob.glob(
                os.path.join(data_dir, "imgs/*/color_view_*.jpg")))
            self.depth_img_list = sorted(glob.glob(
                os.path.join(data_dir, "imgs/*/depth_view_*.png")))
            self.mask_img_list = sorted(glob.glob(
                os.path.join(data_dir, "imgs/*/mask_view_*.png")))
        elif self.data_type == "real":
            self.color_img_list = sorted(glob.glob(
                os.path.join(data_dir, "imgs/color/color_*.jpg")))
            self.depth_img_list = []
            self.mask_img_list = sorted(glob.glob(
                os.path.join(data_dir, "imgs/mask/mask_*.png")))
        else:
            raise ValueError(f"Invalid data type: {self.data_type}")

        self.img_num_per_pose = max(
            1, len(self.color_img_list) // max(1, len(self.smpl_pose_list)))
        self.start_data_idx = self._pose_idx(self.smpl_pose_list[0])
        self.smpl_shape = np.loadtxt(
            os.path.join(data_dir, "smpl/shape.txt")).astype(np.float32)
        self._fk_cache = {}
        self._fk_lock = threading.Lock()

        # canonical SMPL (reference :61-70)
        cano_v, cano_j, cano_m = self._fk(canonical_pose()[None])
        self.cano_smpl_v = cano_v[0]
        self.cano_smpl_jnts = cano_j[0]
        self.inv_cano_jnt_mats = np.linalg.inv(cano_m[0])
        self.cano_smpl_center = 0.5 * (self.cano_smpl_v.min(0)
                                       + self.cano_smpl_v.max(0))

        # position-map pose transforms (reference :73-87)
        self.pos_map_name = self.data_config.get("pos_map_name", "cano")
        self.pos_map_res = self.data_config.get("pos_map_res", 256)
        J = smpl_params.num_joints
        if self.pos_map_name == "cano":
            self.cano2posmap_jnt_mats = np.tile(np.eye(4, dtype=np.float32),
                                                (J, 1, 1))
        elif self.pos_map_name == "A":
            pose = np.zeros(3 + 3 * J, np.float32)
            pose[3 + 16 * 3 + 2] = -math.radians(60)
            pose[3 + 17 * 3 + 2] = math.radians(60)
            amats = self._fk(pose[None])[2][0]
            self.cano2posmap_jnt_mats = amats @ self.inv_cano_jnt_mats
        else:
            raise ValueError(f"Invalid pos_map_name: {self.pos_map_name}")

        # canonical bounds: pad 5 cm in x, y and 15 cm in z
        # (reference :89-97)
        min_xyz = self.cano_smpl_v.min(0)
        max_xyz = self.cano_smpl_v.max(0)
        min_xyz[:2] -= 0.05
        max_xyz[:2] += 0.05
        min_xyz[2] -= 0.15
        max_xyz[2] += 0.15
        self.cano_bounds = np.stack([min_xyz, max_xyz]).astype(np.float32)

        cam = self.data_config["camera"]
        self.K = np.array([[cam["fx"], 0, cam["cx"]],
                           [0, cam["fy"], cam["cy"]],
                           [0, 0, 1]], np.float32)
        self.img_w = cam["img_width"]
        self.img_h = cam["img_height"]

        if not training:
            self._init_test_grid(vol_res, resolve_device(device))
            return

        if training_data_ids is not None:
            ids = set(int(i) for i in np.atleast_1d(training_data_ids))
            self.smpl_pose_list = [
                p for p in self.smpl_pose_list if self._pose_idx(p) in ids]

            def img_in(path):
                return int(os.path.basename(os.path.dirname(path))) in ids
            self.color_img_list = list(filter(img_in, self.color_img_list))
            self.depth_img_list = list(filter(img_in, self.depth_img_list))
            self.mask_img_list = list(filter(img_in, self.mask_img_list))

        self._preload_training_data()

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _pose_idx(pose_path: str) -> int:
        name = os.path.splitext(os.path.basename(pose_path))[0]
        return int(name.replace("pose_", ""))

    def _fk(self, poses: np.ndarray):
        """SMPL forward kinematics of (P, 75) poses on the host CPU:
        numpy (vertices, joints, joint affine mats)."""
        with torch.no_grad():
            out = smpl_forward_batch(self.smpl_params,
                                     torch.from_numpy(np.asarray(poses)),
                                     torch.from_numpy(self.smpl_shape))
        return (out.vertices.numpy(), out.joints.numpy(),
                out.jnt_affine_mats.numpy())

    def _init_test_grid(self, vol_res, device: torch.device):
        """The full static grid, its near-body flags, the inside prior of
        the other nodes and the compacted band (the reference's :109-125,
        static-shape form), as tensors on ``device``."""
        self.vol_res = tuple(int(r) for r in vol_res)
        lin = [np.linspace(0, 1, r, dtype=np.float32) for r in self.vol_res]
        bounds = torch.from_numpy(self.cano_bounds).to(device)
        g = torch.stack(torch.meshgrid(
            *[torch.from_numpy(x).to(device) for x in lin], indexing="ij"),
            dim=-1).reshape(-1, 3)
        pts = g * (bounds[1] - bounds[0]) + bounds[0]
        del g
        verts = torch.from_numpy(self.cano_smpl_v).to(device)
        d2, _ = knn(pts, verts, k=1, chunk=GRID_PAD)
        self.infer_pts_flag = d2[:, 0] < NEAR_BODY_DIST ** 2
        del d2
        self.infer_pts = pts                  # full grid, masked downstream
        tris = verts[torch.from_numpy(
            np.asarray(self.smpl_params.faces, np.int64)).to(device)]
        inside = points_inside_mesh(pts, tris)
        # occupancy in [-1, 1] (reference :124): +1 inside, -1 outside
        self.invalid_pts_ov = 2.0 * inside.float() - 1.0
        idx = torch.nonzero(self.infer_pts_flag)[:, 0]
        n = idx.shape[0]
        pad = (-n) % GRID_PAD
        self.valid_pts_idx = torch.cat([
            idx.to(torch.int32),
            torch.full((pad,), pts.shape[0], dtype=torch.int32,
                       device=device)])                 # out of range: drop
        self.valid_pts = torch.cat([pts[idx], pts.new_zeros((pad, 3))])
        self.num_valid_pts = int(n)
        # the prior everywhere; the band's entries come from the network
        self.prior_volume = torch.where(self.infer_pts_flag,
                                        torch.zeros_like(self.invalid_pts_ov),
                                        self.invalid_pts_ov)

    def _load_pos_map(self, data_idx: int) -> np.ndarray:
        """EXR position map -> (H, W, 6) front/back stack, channels last
        (reference :159-162)."""
        path = os.path.join(
            self.data_dir,
            f"smpl/smpl_pos_map_{data_idx:04d}_{self.pos_map_name}.exr")
        try:
            m = load_float_image(path)
        except FileNotFoundError:
            m = load_float_image(os.path.join(
                self.data_dir, f"smpl/smpl_pos_map_{data_idx:04d}.exr"))
        r = self.pos_map_res
        m = cv.resize(m, (2 * r, r), interpolation=cv.INTER_NEAREST)
        return np.concatenate([m[:, :r, :], m[:, r:, :]],
                              axis=-1).astype(np.float32)

    def _preload_training_data(self):
        # the forward kinematics of every training pose in one call, so
        # that items (and forked workers) never run it
        if self.smpl_pose_list:
            poses = np.stack([self._load_live_pose(i)
                              for i in range(len(self.smpl_pose_list))])
            with self._fk_lock:
                for i, e in enumerate(self._fk_entries(poses)):
                    self._fk_cache[i] = e

        self.pos_maps = []
        self.presampled_data = []
        self.data_indices = []
        for pose_file in self.smpl_pose_list:
            idx = self._pose_idx(pose_file)
            self.pos_maps.append(self._load_pos_map(idx))
            with np.load(os.path.join(self.data_dir,
                                      f"cano_pts_ov/{idx:03d}.npz")) as data:
                self.presampled_data.append({k: data[k].copy()
                                             for k in data})
            self.data_indices.append(idx)

    def __len__(self):
        return len(self.smpl_pose_list) * self.img_num_per_pose

    def _load_live_pose(self, pose_idx: int) -> np.ndarray:
        live_pose = np.loadtxt(
            self.smpl_pose_list[pose_idx]).astype(np.float32)
        live_pose[3 + 22 * 3: 6 + 22 * 3] = 0.0
        live_pose[3 + 23 * 3: 6 + 23 * 3] = 0.0
        return live_pose

    def _fk_entries(self, poses: np.ndarray):
        """Per-pose cache entries (pose, live vertices, cano->live joint
        mats, live bounds) of one batched forward-kinematics call. The
        arrays are read-only: items hand them out by reference."""
        live_vs, _, jnt_mats = self._fk(poses)
        entries = []
        for pose, live_v, mats in zip(poses, live_vs, jnt_mats):
            cano2live = (mats @ self.inv_cano_jnt_mats).astype(np.float32)
            live_bounds = np.stack([live_v.min(0) - 0.05,
                                    live_v.max(0) + 0.05]).astype(np.float32)
            entry = (pose, live_v.astype(np.float32), cano2live,
                     live_bounds)
            for a in entry:
                a.flags.writeable = False
            entries.append(entry)
        return entries

    def _live_fk(self, pose_idx: int):
        """(live_pose, live_v, cano2live_jnt_mats, live_bounds), computed
        at most once per pose (thread-safe)."""
        with self._fk_lock:
            hit = self._fk_cache.get(pose_idx)
        if hit is not None:
            return hit
        entry = self._fk_entries(self._load_live_pose(pose_idx)[None])[0]
        with self._fk_lock:
            return self._fk_cache.setdefault(pose_idx, entry)

    # -- item assembly ----------------------------------------------------

    def __getitem__(self, index: int, rng: np.random.RandomState = None,
                    light: bool = False):
        """Assemble one item. ``light`` leaves out the per-pose arrays
        (position map, live SMPL vertices, joint mats, pose) and the
        per-subject ones, and adds ``pose_idx``: device_batches keeps
        those on the device. A test item reads its position map from disk,
        has all-ones color and mask, carries every box and body ray of
        its view, and the grid (``cano_pts``, ``valid_pts_flag``, tensors
        on the grid's device) in place of sampled points."""
        if rng is None:
            rng = np.random
        pose_idx = index // self.img_num_per_pose
        view_idx = index % self.img_num_per_pose
        data_idx = self._pose_idx(self.smpl_pose_list[pose_idx])

        # live SMPL, hands zeroed (reference :194-198)
        live_pose, live_v, cano2live, live_bounds = self._live_fk(pose_idx)

        # image + mask (reference :216-225)
        if not self.training:
            color = np.ones((self.img_h, self.img_w, 3), np.float32)
            mask = np.ones((self.img_h, self.img_w), np.uint8)
        else:
            color = cv.imread(self.color_img_list[index],
                              cv.IMREAD_UNCHANGED).astype(np.float32) / 255.0
            if not self.mask_img_list:
                mask = (np.linalg.norm(color, axis=-1) > 0).astype(np.uint8)
            else:
                mask = cv.imread(self.mask_img_list[index],
                                 cv.IMREAD_UNCHANGED)

        # camera extrinsics (reference :227-237)
        cam_path = os.path.join(self.data_dir,
                                f"imgs/{data_idx:03d}/cams.mat")
        w2c_RT = np.identity(4, np.float32)
        if os.path.exists(cam_path):
            import scipy.io as sio
            cam_data = sio.loadmat(cam_path)
            aa = np.float64(cam_data["cam_rs"][view_idx]).reshape(3)
            w2c_RT[:3, :3] = cv.Rodrigues(aa)[0].astype(np.float32)
            w2c_RT[:3, 3] = np.float32(cam_data["cam_ts"][view_idx]).ravel()

        rays = sample_rays(color, mask, self.K, w2c_RT[:3, :3],
                           w2c_RT[:3, 3:], live_bounds, SAMPLED_RAY_NUM,
                           self.training, rng=rng)
        coord = rays["coord"]
        occupancy = mask[coord[:, 0], coord[:, 1]]
        if self.training and self.data_type == "synthetic" \
                and self.depth_img_list:
            depth_img = cv.imread(self.depth_img_list[index],
                                  cv.IMREAD_UNCHANGED)
            z = depth_img[coord[:, 0], coord[:, 1]] / 1000.0
            x = (coord[:, 1] + 0.5 - self.K[0, 2]) * z / self.K[0, 0]
            y = (coord[:, 0] + 0.5 - self.K[1, 2]) * z / self.K[1, 1]
            depth = np.sqrt(x * x + y * y + z * z).astype(np.float32)
        else:
            depth = np.zeros(occupancy.shape, np.float32)

        item = {
            "data_idx": data_idx,
            "view_idx": view_idx,
            "rgb": rays["rgb"],
            "depth": depth,
            "body_mask": rays["body_mask"],
            "occupancy": occupancy.astype(np.float32),
            "ray_o": rays["ray_o"],
            "ray_d": rays["ray_d"],
            "near": rays["near"],
            "far": rays["far"],
            "w2c_RT": w2c_RT,
        }
        if light:
            item["pose_idx"] = pose_idx
        else:
            item.update({
                "smpl_pose": live_pose,
                "smpl_pos_map": (self.pos_maps[pose_idx].copy()
                                 if self.training
                                 else self._load_pos_map(data_idx)),
                # (H, W, 6)
                "cano2live_jnt_mats": cano2live.astype(np.float32),
                "cano2posmap_jnt_mats": self.cano2posmap_jnt_mats,
                "cano_bounds": self.cano_bounds,
                "cano_smpl_center": self.cano_smpl_center.astype(np.float32),
                "cano_smpl_jnts": self.cano_smpl_jnts,
                "live_smpl_v": live_v.astype(np.float32),
            })

        if not self.training:
            item["cano_pts"] = self.infer_pts
            item["valid_pts_flag"] = self.infer_pts_flag
            return item
        pre = self.presampled_data[pose_idx]
        # clamp to the presampled population (tiny synthetic subjects)
        n_sur = min(SURFACE_PTS_PER_ITEM, pre["sur_pts"].shape[0])
        n_vol = min(VOLUME_PTS_PER_ITEM, pre["vol_pts"].shape[0])
        sid = rng.choice(pre["sur_pts"].shape[0], n_sur, replace=False)
        vid = rng.choice(pre["vol_pts"].shape[0], n_vol, replace=False)
        item["cano_pts"] = np.concatenate(
            [pre["sur_pts"][sid], pre["vol_pts"][vid]]).astype(np.float32)
        item["cano_pts_ov"] = np.concatenate(
            [pre["sur_pts_ov"][sid],
             pre["vol_pts_ov"][vid]]).astype(np.float32)
        return item

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 31359, drop_last: bool = True,
                num_workers: int = 0, prefetch_batches: int = 2,
                light: bool = False, workers: str = "thread"):
        """Epoch iterator of stacked numpy batches (the reference's torch
        DataLoader, dataset/avatarcap_dataset.py:349-359).

        ``num_workers`` > 0 assembles items on a pool and keeps
        ``prefetch_batches`` batches in flight; each item then draws from
        its own position-seeded RandomState, so the stream does not depend
        on worker timing (the serial path keeps one shared RandomState).
        ``workers``: ``thread`` or ``process`` (forked workers that inherit
        the dataset; items come back pickled). Both give the same batches
        for one seed.
        """
        if workers not in ("thread", "process"):
            raise ValueError(f"workers={workers!r}: 'thread' or 'process'")
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        n = len(order) // batch_size if drop_last else \
            -(-len(order) // batch_size)

        if num_workers <= 0:
            for b in range(n):
                idxs = order[b * batch_size:(b + 1) * batch_size]
                items = [self.__getitem__(int(i), rng, light=light)
                         for i in idxs]
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}
            return

        def item_seed(pos: int) -> int:
            return (seed + 1000003 * (pos + 1)) % (2 ** 31 - 1)

        if workers == "process":
            ex, get_fn = self._fork_pool(num_workers), _fork_getitem
            own_pool = False
        else:
            ex = ThreadPoolExecutor(max_workers=num_workers)
            own_pool = True

            def get_fn(i, s, lt):
                return self.__getitem__(i, np.random.RandomState(s), lt)

        try:
            pending = deque()

            def submit(b: int) -> None:
                idxs = order[b * batch_size:(b + 1) * batch_size]
                pending.append([
                    ex.submit(get_fn, int(i),
                              item_seed(b * batch_size + j), light)
                    for j, i in enumerate(idxs)])

            nxt = 0
            for _ in range(min(prefetch_batches + 1, n)):
                submit(nxt)
                nxt += 1
            while pending:
                futs = pending.popleft()
                items = [f.result() for f in futs]
                if nxt < n:
                    submit(nxt)
                    nxt += 1
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}
        finally:
            if own_pool:
                ex.shutdown(wait=False, cancel_futures=True)

    def _fork_pool(self, num_workers: int) -> ProcessPoolExecutor:
        """A process pool whose forked workers inherit this dataset, kept
        on the dataset and reused across epochs (close() shuts it down).
        Its workers are forked here, before the call returns: items are
        numpy and OpenCV only (the forward kinematics is cached for every
        training pose before), so a worker never touches torch's threads
        or the card, and device_batches forks them before it first touches
        the card."""
        import multiprocessing as mp
        pool = getattr(self, "_proc_pool", None)
        if pool is None or pool[1] != num_workers:
            self.close()
            global _FORK_DATASET
            _FORK_DATASET = self
            ex = ProcessPoolExecutor(max_workers=num_workers,
                                     mp_context=mp.get_context("fork"))
            ex.submit(int).result()         # fork every worker now
            self._proc_pool = pool = (ex, num_workers)
        return pool[0]

    def close(self) -> None:
        """Shut down the process pool of ``workers="process"``, if any."""
        pool = getattr(self, "_proc_pool", None)
        if pool is not None:
            pool[0].shutdown(wait=True, cancel_futures=True)
            self._proc_pool = None

    def device_batches(self, batch_size: int, shuffle: bool = True,
                       seed: int = 31359, drop_last: bool = True,
                       num_workers: int = 0, prefetch_batches: int = 2,
                       workers: str = "thread", device=None):
        """Training batches as tensors on ``device`` (the card unless the
        caller names the CPU), the same keys and values as ``batches``.

        The per-pose arrays (position maps, live SMPL vertices, joint
        mats, poses) go to the device once and each batch gathers them by
        pose index there; only the per-view arrays travel per batch, from
        pinned host memory with non-blocking copies, and the next batch's
        copies are started before the current batch is handed out.
        """
        if not self.training:
            raise ValueError("device_batches is a training-mode helper")
        device = resolve_device(device)
        if workers == "process" and num_workers > 0:
            self._fork_pool(num_workers)
        cache = getattr(self, "_dev_pose_cache", None)
        if cache is None or cache["cano_bounds"].device != device:
            entries = [self._live_fk(i)
                       for i in range(len(self.smpl_pose_list))]
            host = {"smpl_pos_map": np.stack(self.pos_maps),
                    "smpl_pose": np.stack([e[0] for e in entries]),
                    "live_smpl_v": np.stack([e[1] for e in entries]),
                    "cano2live_jnt_mats": np.stack([e[2] for e in entries]),
                    "cano2posmap_jnt_mats": self.cano2posmap_jnt_mats,
                    "cano_bounds": self.cano_bounds,
                    "cano_smpl_center":
                        self.cano_smpl_center.astype(np.float32),
                    "cano_smpl_jnts": self.cano_smpl_jnts}
            cache = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in host.items()}
            self._dev_pose_cache = cache
        pin = device.type == "cuda"

        def upload(batch):
            pose_ids = torch.from_numpy(batch.pop("pose_idx"))
            out = {}
            for k, v in batch.items():
                t = torch.from_numpy(v)
                out[k] = (t.pin_memory() if pin else t).to(
                    device, non_blocking=pin)
            ids = pose_ids.to(device)
            B = ids.shape[0]
            for k in _PER_POSE:
                out[k] = cache[k][ids]
            for k in _PER_SUBJECT:
                out[k] = cache[k][None].expand((B,) + cache[k].shape)
            return out

        prev = None
        for batch in self.batches(batch_size, shuffle=shuffle, seed=seed,
                                  drop_last=drop_last,
                                  num_workers=num_workers,
                                  prefetch_batches=prefetch_batches,
                                  light=True, workers=workers):
            dev = upload(batch)
            if prev is not None:
                yield prev
            prev = dev
        if prev is not None:
            yield prev
