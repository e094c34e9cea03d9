"""The training phase of chip_smoke.py (tools/bench_train.run) rehearsed
on the CPU at a small size: every phase runs and its checks hold (the
card-against-CPU phase compares the CPU with itself here). The port alone,
no JAX."""

import torch


def test_bench_train_runs_on_cpu():
    from avatarcap_tpu_torch.tools import bench_train
    rec = bench_train.run(torch.device("cpu"), 3, **bench_train.SMALL)
    fw = rec["full_width"]
    assert len(fw["step_ms"]) == 3 and fw["peak_mem_gb"] is None
    assert fw["points"] == 2 * (32 * 8 + 256 + 64)
    assert fw["losses_last"]["total_loss"] < fw["losses_first"]["total_loss"]
    assert set(rec["stages"]) == {
        "pose_features", "geometry_query", "inverse_skinning", "ray_query",
        "compositing", "backward", "optimizer"}
    assert rec["card_vs_cpu"]["grad_rel_err_whole"] == 0.0
    assert rec["fit"]["steps"] == 4 and rec["fit"]["round_trip_bit_equal"]
    assert rec["repeatability"]["max_abs_diff"] == 0.0   # no atomics here
    assert not bench_train.CKPT_DIR.exists()
