"""Command-line entry point (counterpart of avatarcap_tpu/cli.py; the
reference's main.py surface).

Usage:
  python -m avatarcap_tpu_torch.cli -c configs/example.yaml -m train
  python -m avatarcap_tpu_torch.cli -c configs/example.yaml -m test \
      [--nerf] [--save-avatar-mesh] [--save-final-mesh] [--interval N] \
      [--view-idx V] [--frame-idx F] [--stream N] [--device cpu]

Runs on the card unless ``--device cpu`` is given (the JAX CLI's
``JAX_PLATFORMS``). Networks load from the reference's file names:
``net.pt`` in ``testing.net_ckpt`` / ``net_ckpt_finetuned`` (what
``-m train`` writes under ``training.net_ckpt_dir/epoch_*``) and
``recon_net.pt`` in ``testing.recon_net_ckpt``, released reference
checkpoints included. Without ``net_ckpt`` the avatar keeps its
initialisation (a torch generator seeded 0, standing in for the JAX CLI's
PRNGKey(0); the bits differ). ``testing.capture_options`` (the port's one
addition to the JAX config) sets further CaptureOptions fields.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

SMPL_FILES = {"M": "basicmodel_m_lbs_10_207_0_v1.0.0.pkl",
              "F": "basicmodel_f_lbs_10_207_0_v1.0.0.pkl",
              "N": "basicmodel_n_lbs_10_207_0_v1.0.0.pkl"}
NECK_VERTEX_IDX = 3068          # the reference's main.py
RECON_FILE = "recon_net.pt"


def _load_subject(cfg, data_dir: str, training: bool, device=None):
    """(dataset, AvatarStatics on the host, SmplParams); the test-mode
    dataset builds its grid on ``device``."""
    from avatarcap_tpu_torch.body.smpl import SmplParams
    from avatarcap_tpu_torch.data.dataset import AvatarCapDataset
    from avatarcap_tpu_torch.pipeline.avatar import AvatarStatics

    smpl_params = SmplParams.load(
        os.path.join(cfg.smpl_model_dir, SMPL_FILES[cfg.smpl_gender]))
    ids = (np.loadtxt(cfg.training.training_data_ids).astype(np.int32)
           if cfg.training.training_data_ids else None)
    ds = AvatarCapDataset(data_dir, training=training,
                          smpl_params=smpl_params,
                          vol_res=cfg.testing.vol_res,
                          training_data_ids=ids, device=device)
    weight_volume = np.load(os.path.join(
        cfg.training.training_data_dir, "cano_base_blend_weight_volume.npy"))
    statics = AvatarStatics(
        weight_volume=torch.from_numpy(weight_volume),
        cano_smpl_vertices=torch.from_numpy(ds.cano_smpl_v),
        smpl_skinning_weights=torch.from_numpy(smpl_params.weights),
        cano_bounds=torch.from_numpy(ds.cano_bounds),
        cano_smpl_center=torch.from_numpy(
            ds.cano_smpl_center.astype(np.float32)))
    return ds, statics, smpl_params


def _new_avatar(cfg, seed: int):
    """GeoTexAvatar with its initialisation drawn from torch's generator
    seeded ``seed`` (forked, so the caller's stream is left as it was), in
    the config's ``if_type`` and positional encodings. The kernels take
    the (10, 0) encodings only: a test run of other encodings needs
    ``testing.capture_options: {use_fused_query: false}``."""
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return GeoTexAvatar(
            if_type=cfg.if_type,
            pos_encoding_template=cfg.model.cano_template_pos_encoding,
            pos_encoding_warp=cfg.model.warping_field_pos_encoding)


def train_avatar(cfg, device=None):
    """The reference's main.py:28-159: fit the avatar on the training
    subject (from ``training.net_ckpt`` when set), then finetune its
    texture when ``training.finetune_tex``. The initial weights come from a
    torch generator seeded 31359, standing in for the JAX CLI's
    PRNGKey(31359) (the bits differ)."""
    from avatarcap_tpu_torch.train import checkpoints as ckpt
    from avatarcap_tpu_torch.train.trainer import AvatarTrainer

    ds, statics, _ = _load_subject(cfg, cfg.training.training_data_dir, True)
    trainer = AvatarTrainer(
        statics=statics, net_ckpt_dir=cfg.training.net_ckpt_dir,
        if_type=cfg.if_type, cano_template_lr=cfg.model.cano_template_lr,
        warping_field_lr=cfg.model.warping_field_lr,
        n_samples=cfg.n_samples,
        loss_weights=(cfg.model.img_loss_weight, cfg.model.occ_loss_weight,
                      cfg.model.geo_offset_reg_loss_weight,
                      cfg.model.tex_offset_reg_loss_weight),
        device=device)
    state = trainer.init_state(_new_avatar(cfg, 31359))
    if cfg.training.net_ckpt:
        state = ckpt.load_train_state(cfg.training.net_ckpt, state)
    try:
        state = trainer.fit(ds, cfg.training.start_epoch,
                            cfg.training.end_epoch, cfg.training.batch_size,
                            state, ckpt_interval=cfg.training.ckpt_interval)
        if cfg.training.finetune_tex:
            from avatarcap_tpu_torch.train.finetune import (
                finetune_texture_template)
            finetune_texture_template(cfg, trainer.statics, ds, state,
                                      device=trainer.device)
    finally:
        ds.close()
    return state


def _capture_options(cfg):
    from avatarcap_tpu_torch.pipeline.capture import CaptureOptions
    kw = {"iso_value": cfg.iso_value, "render_res": cfg.testing.render_res}
    if cfg.testing.max_tris:
        kw["max_tris"] = cfg.testing.max_tris
    if cfg.testing.max_active:
        kw["max_active"] = cfg.testing.max_active
    kw.update(cfg.testing.capture_options)
    return CaptureOptions(**kw)


def _image(front, back) -> np.ndarray:
    """Front|back side by side, BGR uint8 for cv.imwrite."""
    img = np.concatenate([front.cpu().numpy(), back.cpu().numpy()], 1)
    return (255 * img[..., ::-1]).astype(np.uint8)


def _save_mesh(path, mesh, colors):
    from avatarcap_tpu_torch.data.mesh_io import save_ply
    n = 3 * int(mesh.num_tris)
    faces = np.arange(n, dtype=np.int32).reshape(-1, 3)
    save_ply(path, mesh.vertices[:n].cpu().numpy(), faces,
             mesh.normals[:n].cpu().numpy(),
             None if colors is None else colors[:n].cpu().numpy())


def run_avatarcap(cfg, w_recon=True, w_nerf=False, save_avatar_mesh=False,
                  save_final_mesh=False, interval=1, view_idx=0, stream=0,
                  frame_idx=None, device=None):
    """The reference's main.py:275-504: every ``interval``-th frame of
    the test subject, or only ``frame_idx``; one frame at a time, or with
    ``stream`` > 0 through pipeline/streaming.py.

    Writes ``cano_avatar/NNNN.jpg``, ``live_avatar/NNNN.jpg`` and (with a
    ReconNet) ``live_recon/NNNN.jpg`` under ``testing.output_dir``, and the
    PLYs ``NNNN_avatar.ply`` / ``NNNN_recon.ply`` when asked (vertex colors
    with ``w_nerf``). Returns one record per frame: data_idx, the frame's
    seconds (host clock, to a synchronise at the frame's end), its stage
    seconds and its kernels' row counts (a utils.timers.Tracer, which
    synchronises nothing: ``timers.frame_summaries``), overflow and
    triangle counts, and the seconds spent saving.

    ``stream`` = N > 0 streams the frames, N per device and batch, one
    batch loaded at a time: on one device through
    ``StreamingCapture.run_pipelined``, on a mesh of several (every card,
    parallel.mesh.make_mesh) through ``run``. A frame's seconds are then
    its batch's (dispatch to the end of the batch on the card) over the
    batch's frames. The outputs are those of the run without it.
    """
    import cv2 as cv
    from avatarcap_tpu_torch.data.image_io import load_float_image
    from avatarcap_tpu_torch.device import resolve_device
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from avatarcap_tpu_torch.pipeline.capture import (AvatarCapture,
                                                      CaptureGrid)
    from avatarcap_tpu_torch.render.camera import calc_back_mv, calc_front_mv
    from avatarcap_tpu_torch.train import checkpoints as ckpt
    from avatarcap_tpu_torch.utils.timers import Tracer, frame_summaries
    from avatarcap_tpu_torch.weights import load_reference_checkpoint

    device = resolve_device(device)
    options = _capture_options(cfg)
    out_dir = cfg.testing.output_dir
    for sub in ("cano_avatar", "live_avatar", "live_recon"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    ds, statics, _ = _load_subject(cfg, cfg.testing.testing_data_dir, False,
                                   device=device)
    avatar = _new_avatar(cfg, 0)
    tex_avatar = None
    if cfg.testing.net_ckpt:
        ckpt.load_network(cfg.testing.net_ckpt, avatar)
    if cfg.testing.net_ckpt_finetuned:
        tex_avatar = _new_avatar(cfg, 0)
        ckpt.load_network(cfg.testing.net_ckpt_finetuned, tex_avatar)
    recon = None
    if w_recon and cfg.testing.recon_net_ckpt:
        recon = ReconNetwork()
        load_reference_checkpoint(
            recon, os.path.join(cfg.testing.recon_net_ckpt, RECON_FILE))
    use_recon = recon is not None

    grid = CaptureGrid(valid_pts=ds.valid_pts, valid_idx=ds.valid_pts_idx,
                       prior_volume=ds.prior_volume,
                       vol_res=tuple(cfg.testing.vol_res))
    capture = AvatarCapture(avatar, statics, grid, recon=recon,
                            tex_avatar=tex_avatar, options=options,
                            device=device)

    cam = ds.data_config["camera"]
    data_num = len(ds) // ds.img_num_per_pose
    views = {}

    def load_frame(i):
        item = ds[i * ds.img_num_per_pose + view_idx]
        data_idx = item["data_idx"]
        inferred_normal = None
        if use_recon:
            if ds.data_config["data_type"] == "synthetic":
                p = os.path.join(ds.data_dir, f"imgs/{data_idx:03d}/"
                                 f"normal_view_{view_idx:03d}.exr")
            else:
                p = os.path.join(ds.data_dir,
                                 f"imgs/normal/normal_{data_idx:04d}.exr")
            inferred_normal = load_float_image(p)
        return item, inferred_normal

    def save_frame(data_idx, results):
        if bool(results["overflow"]):
            # a static capacity (query refine, MC triangles / active cells,
            # raster candidates, big-triangle slots, unique vertices) was
            # hit and geometry was dropped: raise the CaptureOptions
            # capacities for this subject
            print(f"WARNING: frame {data_idx}: capacity overflow — "
                  "output mesh/renders are missing geometry")
        # the canonical avatar render (reference main.py:372-375)
        cv.imwrite(os.path.join(out_dir, "cano_avatar", f"{data_idx:04d}.jpg"),
                   _image(*results["cano_phong"]))
        live = results["live_mesh"]
        if not views:
            lv = live.vertices[:3 * int(live.num_tris)].cpu().numpy()
            views["front"] = calc_front_mv(lv, rot_x_angle=-0.15)
            views["back"] = calc_back_mv(lv, rot_x_angle=-0.15)
        cv.imwrite(os.path.join(out_dir, "live_avatar", f"{data_idx:04d}.jpg"),
                   _image(*capture.render_live(live, views["front"],
                                               views["back"])))
        if save_avatar_mesh:
            _save_mesh(os.path.join(out_dir, f"{data_idx:04d}_avatar.ply"),
                       live, results["avatar_colors"] if w_nerf else None)
        if use_recon:
            rec = results["live_recon_mesh"]
            cv.imwrite(os.path.join(out_dir, "live_recon",
                                    f"{data_idx:04d}.jpg"),
                       _image(*capture.render_live(rec, views["front"],
                                                   views["back"])))
            if save_final_mesh:
                _save_mesh(os.path.join(out_dir, f"{data_idx:04d}_recon.ply"),
                           rec, results["recon_colors"] if w_nerf else None)

    def record(item, results, seconds, summary):
        t0 = time.perf_counter()
        save_frame(item["data_idx"], results)
        rec = {"data_idx": int(item["data_idx"]), "seconds": seconds,
               "stages": summary["stages"], "counts": summary["counts"],
               "save_seconds": time.perf_counter() - t0,
               "overflow": bool(results["overflow"]),
               "num_tris": int(results["cano_mesh"].num_tris)}
        if use_recon:
            rec["recon_num_tris"] = int(results["recon_mesh"].num_tris)
        print(f"frame {rec['data_idx']:04d}: {seconds:.3f} s, "
              f"{rec['num_tris']} triangles"
              + (f", {rec['recon_num_tris']} ReconNet triangles"
                 if use_recon else ""))
        return rec

    frame_ids = ([frame_idx] if frame_idx is not None
                 else list(range(0, data_num, interval)))
    records = []
    tracer = Tracer(device)
    if stream > 0:
        from avatarcap_tpu_torch.parallel.mesh import make_mesh
        from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
        if not frame_ids:
            print("run_avatarcap: no frames to process")
            return records
        img_hw = (load_frame(frame_ids[0])[1].shape[:2] if use_recon
                  else (cfg.testing.render_res, cfg.testing.render_res))
        mesh = make_mesh() if device.type == "cuda" else make_mesh([device])
        sc = StreamingCapture(capture, mesh, camera=cam, image_size=img_hw,
                              frames_per_device=stream, w_recon=use_recon,
                              w_nerf=w_nerf, neck_vertex_idx=NECK_VERTEX_IDX)
        runner = sc.run_pipelined if len(mesh) == 1 else sc.run
        for start in range(0, len(frame_ids), sc.batch):
            pairs = [load_frame(i)
                     for i in frame_ids[start:start + sc.batch]]
            t0 = time.perf_counter()
            res_list = runner(
                [p[0] for p in pairs],
                inferred_normals=([p[1] for p in pairs] if use_recon
                                  else None), timer=tracer)
            for dev in set(mesh):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            seconds = (time.perf_counter() - t0) / len(pairs)
            frames = frame_summaries(tracer.collect())
            records += [record(item, results, seconds,
                               frames[results["frame_id"]])
                        for (item, _), results in zip(pairs, res_list)]
        return records
    for i in frame_ids:
        item, inferred_normal = load_frame(i)
        t0 = time.perf_counter()
        results = capture.process_frame(
            item, w_recon=use_recon, w_nerf=w_nerf,
            inferred_normal=inferred_normal,
            neck_vertex_idx=NECK_VERTEX_IDX, camera=cam, timer=tracer)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        frames = frame_summaries(tracer.collect())
        records.append(record(item, results, seconds,
                              frames[results["frame_id"]]))
    return records


def main(argv=None):
    """Parse the flags and run the mode; returns the test mode's frame
    records (None for training)."""
    from avatarcap_tpu_torch.config import load_config

    parser = ArgumentParser()
    parser.add_argument("-c", "--config_path", type=str, required=True,
                        help="Configuration file path.")
    parser.add_argument("-m", "--mode", type=str, default="test",
                        choices=["train", "test"], help="Train or test.")
    parser.add_argument("--stream", type=int, default=0, metavar="N",
                        help="test mode: stream the frames, N per device "
                             "and batch (pipelined on one device, sharded "
                             "over every card on several).")
    parser.add_argument("--nerf", action="store_true",
                        help="test mode: also evaluate NeRF vertex "
                             "colors (textured results).")
    parser.add_argument("--save-avatar-mesh", action="store_true",
                        help="save animated GeoTexAvatar results as PLY.")
    parser.add_argument("--save-final-mesh", action="store_true",
                        help="save reconstructed AvatarCap results as PLY.")
    parser.add_argument("--interval", type=int, default=1,
                        help="frame interval for reconstruction.")
    parser.add_argument("--view-idx", type=int, default=0,
                        help="view index (synthetic multi-view data).")
    parser.add_argument("--frame-idx", type=int, default=None,
                        help="test mode: process only this single frame.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the plain PyTorch path).")
    args = parser.parse_args(argv)
    np.random.seed(31359)
    cfg = load_config(args.config_path)
    if args.mode == "train":
        train_avatar(cfg, device=args.device)
        return None
    return run_avatarcap(cfg, w_recon=True, w_nerf=args.nerf,
                         save_avatar_mesh=args.save_avatar_mesh,
                         save_final_mesh=args.save_final_mesh,
                         interval=args.interval, view_idx=args.view_idx,
                         stream=args.stream, frame_idx=args.frame_idx,
                         device=args.device)


if __name__ == "__main__":
    main()
