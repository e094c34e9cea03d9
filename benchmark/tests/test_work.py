"""The benchmark's frozen work counts equal the port's constants at
today's widths."""

import numpy as np
import torch

from benchmark import networks, work
from benchmark.metrics import unet_macs
from benchmark.tests.small import small_cfg


def test_mlp_macs_equal_the_ports():
    from avatarcap_tpu_torch.ops import fused_query as fq
    w = small_cfg("sdf.textured")["widths"]
    assert work.offset_shapes(w) == fq.OFFSET_SHAPES
    assert work.template_shapes(w) == fq.TEMPLATE_SHAPES
    assert work.recon_shapes(w) == fq.RECON_SHAPES
    assert work.k1_macs_per_point(w) == fq.MACS_PER_POINT
    assert work.k2_macs_per_point(w) == fq.RECON_MACS_PER_POINT


def test_launch_bound_equals_bench_kernels():
    from avatarcap_tpu_torch.tools import bench_kernels as bk
    from avatarcap_tpu_torch.ops import fused_query as fq
    w = small_cfg("sdf.textured")["widths"]
    wb = work.weight_bytes(fq.OFFSET_SHAPES) + work.weight_bytes(
        fq.TEMPLATE_SHAPES)
    for n in (1_155_072, 1_966_080):
        ours = work.k1_bound_s(w, n) * 1e3
        theirs = bk.launch_bound(n, fq.MACS_PER_POINT, 3 * 4 + 64 * 2 + 8 * 4,
                                 wb)["bound_ms"]
        assert abs(ours - theirs) <= 1e-9 * theirs


def test_step_macs_equal_bench_train():
    from avatarcap_tpu_torch.tools.bench_train import step_macs
    torch.set_num_threads(4)
    cfg = small_cfg("sdf.train_b4")
    tr = dict(cfg["train"], pos_map_res=cfg["pos_map_res"])
    B, R = tr["batch_size"], tr["n_rays"]
    batch = {"near": torch.zeros(B, R),
             "cano_pts": torch.zeros(B, tr["n_surf"] + tr["n_vol"], 3),
             "smpl_pos_map": torch.zeros(B, 256, 256, 6),
             "live_smpl_v": torch.zeros(B, cfg["body"]["vertices"], 3)}
    theirs = step_macs(networks.build(cfg, "avatar", "program").eval(),
                       batch, tr["n_samples"])
    ours = work.train_step_macs(cfg["widths"], tr, unet_macs(cfg) * B,
                                cfg["body"]["vertices"])
    assert ours == {k: theirs[k] for k in ours}
    assert np.isclose(ours["step_macs"], theirs["step_macs"], rtol=0)
