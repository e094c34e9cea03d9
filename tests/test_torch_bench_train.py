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
    assert set(fw["launches"]) >= {"k1", "knn"}
    assert not any(fw["launches"].values())   # the CPU runs no kernel
    assert set(rec["stages"]) == {
        "pose_features", "geometry_query", "inverse_skinning", "ray_query",
        "compositing", "backward", "optimizer"}
    assert rec["card_vs_cpu"]["grad_rel_err_whole"] == 0.0
    assert rec["fit"]["steps"] == 4 and rec["fit"]["round_trip_bit_equal"]
    assert rec["repeatability"]["max_abs_diff"] == 0.0   # no atomics here
    assert not bench_train.CKPT_DIR.exists()


def test_bench_train_mesh_runs_on_cpu():
    """chip_smoke.py's [train_mesh] (tools/bench_train.run_mesh) over two
    CPU replicas at the small size: its checks hold (it raises
    otherwise) and it reports the step."""
    from avatarcap_tpu_torch.tools import bench_train
    rec = bench_train.run_mesh(torch.device("cpu"), 2, **bench_train.SMALL)
    two = rec["two_replicas_one_card"]
    assert two["devices"] == ["cpu", "cpu"] and len(two["step_ms"]) == 2
    assert two["loss_rel_err"] <= bench_train.MESH_LOSS_RTOL
    assert two["replicas_differ_after_3"] == []
    assert two["peak_mem_gb"] == {} and "busy_share" not in two
    assert set(rec) == {"build_s", "one_device", "two_replicas_one_card",
                        "seconds"}
