"""Point-sharded single-frame grid query over a device mesh (counterpart
of avatarcap_tpu/parallel/grid_query.py).

The compacted near-body points of one frame split into one slab per mesh
device; each device evaluates the warp + template occupancy of its slab
on the f32 module path (``query_occupancy``), the pose features computed
once and copied to every device; the slabs are gathered in order onto the
first device and scattered into the prior volume.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
from avatarcap_tpu_torch.parallel.mesh import AXIS, make_mesh
from avatarcap_tpu_torch.pipeline.avatar import (AvatarStatics,
                                                 compute_pose_features,
                                                 query_occupancy)
from avatarcap_tpu_torch.pipeline.capture import (CaptureGrid, _on,
                                                  _scatter_set)


class ShardedGridQuery:
    """One-frame occupancy volume with points sharded over the mesh.

    Args:
      avatar, statics, grid: as in AvatarCapture (the avatar's weights
        loaded).
      mesh: parallel.mesh.make_mesh devices; points shard over ``axis``.
    """

    def __init__(self, avatar: GeoTexAvatar, statics: AvatarStatics,
                 grid: CaptureGrid, mesh, axis: str = AXIS):
        self.mesh = make_mesh(mesh, axis)
        first = self.mesh[0]
        n_dev = len(self.mesh)
        # pad the compacted point set to a multiple of the mesh size; the
        # pad scatters to the dropped out-of-range index
        pts = torch.as_tensor(grid.valid_pts).to(first)
        idx = torch.as_tensor(grid.valid_idx).to(first)
        pad = (-pts.shape[0]) % n_dev
        n_cells = int(np.prod(grid.vol_res))
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        self._idx = torch.cat([idx, idx.new_full((pad,), n_cells)])
        self._prior = torch.as_tensor(grid.prior_volume).to(first)
        n = pts.shape[0] // n_dev
        self._slabs = []
        models = {}
        for i, dev in enumerate(self.mesh):
            if dev not in models:
                models[dev] = (avatar.to(dev).eval() if dev == first
                               else copy.deepcopy(avatar).to(dev).eval(),
                               statics.to(dev))
            self._slabs.append((dev, *models[dev],
                                pts[i * n:(i + 1) * n].to(dev)))

    def __call__(self, pos_map: torch.Tensor) -> torch.Tensor:
        """pos_map: (1, H, W, 6) -> the flat occupancy volume (X*Y*Z,) on
        the mesh's first device."""
        first = self.mesh[0]
        _, avatar, _, _ = self._slabs[0]
        with torch.inference_mode():
            feat = compute_pose_features(
                avatar, torch.as_tensor(pos_map, dtype=torch.float32)
                .to(first))
            outs = []
            for dev, model, statics, pts in self._slabs:
                with _on(dev):
                    out = query_occupancy(model, pts[None],
                                          feat.to(dev, non_blocking=True),
                                          statics)
                    outs.append(out["cano_pts_ov"][0, :, 0])
            occ = torch.cat([o.to(first, non_blocking=True) for o in outs])
            return _scatter_set(self._prior, self._idx, occ)
