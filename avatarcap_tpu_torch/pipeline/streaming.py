"""Streaming multi-frame capture over a device mesh (counterpart of
avatarcap_tpu/pipeline/streaming.py).

Every frame runs ``AvatarCapture.frame_body``, the code of the
single-frame production path, so there is no second implementation to
drift. The frame reads nothing back to the host, so the host queues frame
after frame while the card works, and each frame's five per-frame arrays
are uploaded ahead of it from pinned host memory on a side copy stream,
overlapping the frames before it.

- ``run_pipelined``: one device, frames in order, ``lookahead`` frames'
  inputs uploaded ahead (the JAX package's single-chip streaming path).
- ``run``: batches of ``frames_per_device`` x mesh size frames, one
  contiguous block per device (JAX's ``P("data")``), each device working
  through its block on its own capture replica. The JAX package vmaps a
  batch into one program; its own note says a vmapped batch runs its
  stages one after another on one chip, so the port loops instead.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from avatarcap_tpu_torch.parallel.mesh import make_mesh
from avatarcap_tpu_torch.pipeline.avatar import FrameInputs
from avatarcap_tpu_torch.pipeline.capture import AvatarCapture, _on


class StreamingCapture:
    """Pipelined and frame-sharded capture over ``frame_body``.

    Args:
      capture: a constructed AvatarCapture (its options decide the query,
        skinning and texture paths, as for single frames); it serves the
        mesh devices it lives on, replicas (``AvatarCapture.replica``)
        the others.
      mesh: parallel.mesh.make_mesh devices; frames shard over them.
      camera: intrinsics dict (fx, fy, cx, cy) of the stream (fixed video
        intrinsics); required when ``w_recon``.
      image_size: (H, W) of the inferred normal images when ``w_recon``.
      frames_per_device: ``run``'s batch is frames_per_device x mesh size.
      w_recon / w_nerf: which tail of the frame runs.
      neck_vertex_idx: the neck seam vertex of the fusion merge.
    """

    def __init__(self, capture: AvatarCapture, mesh,
                 camera: Optional[dict] = None, image_size=(512, 512),
                 frames_per_device: int = 1, w_recon: bool = False,
                 w_nerf: bool = False, neck_vertex_idx: int = 0):
        if w_recon and (camera is None or capture.recon is None):
            raise ValueError("w_recon streaming needs the camera's "
                             "intrinsics and a capture with a ReconNetwork")
        self.capture = capture
        self.mesh = make_mesh(mesh)
        self.w_recon = w_recon
        self.w_nerf = w_nerf
        self.batch = frames_per_device * len(self.mesh)
        self._per_device = frames_per_device
        replicas: Dict[torch.device, AvatarCapture] = {}
        for dev in self.mesh:
            if dev not in replicas:
                replicas[dev] = capture.replica(dev)
        self._replicas = replicas
        self._copy_streams = {dev: torch.cuda.Stream(dev)
                              for dev in replicas if dev.type == "cuda"}
        self._cano_v = (capture.statics.cano_smpl_vertices.detach().cpu()
                        .numpy())
        if w_recon:
            self._camera = dict(camera)
            self._img_hw = tuple(image_size)
            # built once: the projection on every device, and the neck
            self._neck_xy = capture._neck_xy(neck_vertex_idx)
            for rep in replicas.values():
                rep._projection(self._camera, *self._img_hw)
        else:
            self._camera, self._img_hw, self._neck_xy = None, (1, 1), None

    def _upload_frame(self, item: dict, inferred_normal,
                      device: torch.device):
        """Fresh device buffers for one frame's five per-frame arrays (pos
        map, live SMPL vertices, joint mats, inferred normal, w2c), copied
        from pinned host memory on the device's side copy stream. Returns
        (tensors, the copies' event or None on the CPU)."""
        norm = (inferred_normal if inferred_normal is not None
                else np.zeros(self._img_hw + (3,), np.float32))
        host = [torch.as_tensor(np.asarray(a, np.float32)) for a in (
            item["smpl_pos_map"], item.get("live_smpl_v", self._cano_v),
            item["cano2live_jnt_mats"], norm,
            item.get("w2c_RT", np.eye(4, dtype=np.float32)))]
        stream = self._copy_streams.get(device)
        if stream is None:
            return [h.to(device) for h in host], None
        with torch.cuda.stream(stream):
            tensors = [h.pin_memory().to(device, non_blocking=True)
                       for h in host]
            event = torch.cuda.Event()
            event.record(stream)
        return tensors, event

    def _dispatch(self, staged, device: torch.device, timer=None) -> dict:
        """Queue one frame's frame_body behind its upload: the device's
        current stream waits on the upload's event, and the uploaded
        buffers are marked in use there, so the caching allocator keeps
        them until the frame is done with them. ``timer``: frame_body's
        stage hook."""
        (pos_map, lsv, jnt, norm, w2c), event = staged
        rep = self._replicas[device]
        with _on(device):
            if event is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(event)
                for t in (pos_map, lsv, jnt, norm, w2c):
                    t.record_stream(compute)
            frame = FrameInputs(live_smpl_v=lsv[None],
                                cano2live_jnt_mats=jnt[None],
                                smpl_pos_map=pos_map[None])
            return rep.frame_body(
                frame, jnt, norm if self.w_recon else None, w2c,
                self._camera, self._neck_xy, w_recon=self.w_recon,
                w_nerf=self.w_nerf, timer=timer)

    def run_pipelined(self, items: Iterable[dict], inferred_normals=None,
                      lookahead: int = 2, timer=None) -> List[dict]:
        """Frames in order on the mesh's first device: frame i's
        frame_body is queued behind its upload, then frame i + lookahead's
        upload is staged while the card works. Nothing is read back
        between frames. ``timer`` is each frame_body's stage hook (a
        utils/timers.Tracer gives each frame its root span). Returns
        per-frame dicts of device tensors."""
        items = list(items)
        norms = self._normals(items, inferred_normals)
        dev = self.mesh[0]
        staged = {i: self._upload_frame(items[i], norms[i], dev)
                  for i in range(min(lookahead, len(items)))}
        results = []
        for i in range(len(items)):
            results.append(self._dispatch(staged.pop(i), dev, timer))
            j = i + lookahead
            if j < len(items):
                staged[j] = self._upload_frame(items[j], norms[j], dev)
        return results

    def run(self, items: Iterable[dict], inferred_normals=None, timer=None
            ) -> List[dict]:
        """Frames in batches of ``batch``, the last padded with its last
        frame; device d takes the batch's d-th contiguous block of
        frames_per_device frames. Every batch's frames are uploaded first,
        then dispatched round by round over the devices; ``timer`` is
        each frame_body's stage hook, the padding's too. Returns one dict
        of tensors (on the device that ran it) per real frame, in order."""
        items = list(items)
        norms = self._normals(items, inferred_normals)
        results: List[dict] = []
        k = self._per_device
        for start in range(0, len(items), self.batch):
            chunk = list(range(start, min(start + self.batch, len(items))))
            real = len(chunk)
            chunk += [chunk[-1]] * (self.batch - real)
            staged = [self._upload_frame(items[i], norms[i],
                                         self.mesh[slot // k])
                      for slot, i in enumerate(chunk)]
            out = [None] * self.batch
            for r in range(k):
                for d, dev in enumerate(self.mesh):
                    slot = d * k + r
                    out[slot] = self._dispatch(staged[slot], dev, timer)
            results += out[:real]
        return results

    def _normals(self, items, inferred_normals) -> list:
        if inferred_normals is None:
            return [None] * len(items)
        norms = list(inferred_normals)
        if len(norms) != len(items):
            raise ValueError(f"{len(norms)} inferred normals for "
                             f"{len(items)} frames")
        return norms
