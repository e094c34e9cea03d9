"""The port's measurement tools on the CPU: tools/capacity_stats.py against
the JAX package's capacity_stats on the same weights, and the main() of
capacity_stats, profile_frame, trace_frame, compile_preflight, bench_mc
and bench_raster with ``--device cpu`` on the small random subject (their
timings there are host-clock CPU times, labelled so; the card's numbers
come from chip_smoke.py).

capacity_stats runs the f32 path on both sides, whose fields agree to
float32 rounding, so every count is equal.
"""

import json

import numpy as np
import pytest
import torch

SMALL_CPU = ["--small", "--random", "--no-fused-query", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    # beside the other test workers more threads made the fits crawl; the
    # module scope caps them before the module's subjects are built
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """The small random subject on the f32 path."""
    from avatarcap_tpu_torch.tools.bench_workloads import (
        SMALL_CAPTURE_OPTIONS, SMALL_SUBJECT, build_capture_subject)
    return build_capture_subject(
        "cpu", options=dict(SMALL_CAPTURE_OPTIONS, use_fused_query=False),
        fit=False, **SMALL_SUBJECT)


def test_capacity_stats_matches_jax(small):
    """Every avatar-side row of the JAX tool (the JAX package's
    capacity_stats without the ReconNet inputs) on the same weights,
    statics, grid and options; the port's ReconNet rows exist, within
    their capacities, and the unique-vertex rows count the soup's distinct
    edge keys."""
    from avatarcap_tpu.tools.capacity_stats import capacity_stats as jstats
    from avatarcap_tpu_torch.tools.capacity_stats import capacity_stats
    from test_torch_bench_subject import jax_capture_of
    capture, item, kw, _ = small
    got = capacity_stats(capture, item, inferred_normal=kw["inferred_normal"],
                         camera=kw["camera"])
    ref = jstats(jax_capture_of(capture), item)
    assert set(ref) - {"frame_overflow"} <= set(got)
    for name, row in ref.items():
        if name != "frame_overflow":
            assert got[name] == row, name
    for name in ("recon_refine_nodes", "recon_active_cubes", "recon_tris",
                 "live_pos_candidates"):
        assert 0 < got[name]["count"] <= got[name]["capacity"], name
    # the unique soup vertices: one color ray each in a textured frame
    res = capture.process_frame(item, w_recon=True, w_nerf=True, **kw)
    for name, mesh in (("avatar_unique_vertices", res["cano_mesh"]),
                       ("recon_unique_vertices", res["recon_mesh"])):
        ids = mesh.edge_ids.numpy()[mesh.valid.repeat_interleave(3).numpy()]
        assert got[name]["count"] == len(np.unique(ids)) > 100, name
    assert got["frame_overflow"] is False


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def test_capacity_stats_main(capsys):
    from avatarcap_tpu_torch.tools import capacity_stats
    assert capacity_stats.main(SMALL_CPU) == 0
    lines = _json_lines(capsys.readouterr().out)
    rows = {r["row"]: r for r in lines if "row" in r}
    assert {"avatar_tris", "recon_tris", "cano_pair_candidates",
            "live_big_tris", "avatar_unique_vertices"} <= set(rows)
    assert all(r["capacity"] > 0 and r["count"] >= 0 for r in rows.values())
    assert lines[-1] == {"frame_overflow": False}


def test_profile_frame_main(capsys, tmp_path):
    from avatarcap_tpu_torch.tools import profile_frame
    assert profile_frame.main(SMALL_CPU + ["--frames", "1", "--no-recon",
                                           "--trace", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for stage in ("geometry", "skinning", "cano_layers", "TOTAL",
                  "frame without the timer"):
        assert stage in out, stage
    assert (tmp_path / "profile_frame.json").stat().st_size > 0


def test_trace_frame_breakdown(small):
    """op_breakdown on a synthetic trace, and trace() on the CPU, where it
    reports CPU operators on the host clock and every stage of the
    production frame."""
    from avatarcap_tpu_torch.tools.trace_frame import op_breakdown, trace
    b = op_breakdown([("k1", 0, 3_000_000), ("mm", 5, 1_000_000),
                      ("k1", 9, 3_000_000), ("fill", 20, 1_000)], frames=2)
    assert [o["name"] for o in b["ops"]] == ["k1", "mm", "fill"]
    assert b["ops"][0] == {"name": "k1", "ms": 3.0, "launches": 1.0,
                           "share": 6e6 / 7.001e6}
    assert b["launches"] == 2.0 and b["total_ms"] == pytest.approx(3.5005)
    capture, item, kw, _ = small
    rec = trace(capture, item, kw, frames=1, top=5)
    assert rec["clock"] == "host" and len(rec["ops"]) == 5
    assert rec["ops"][0]["ms"] >= rec["ops"][-1]["ms"] > 0
    assert {"geometry", "skinning", "lift", "cano_layers", "merge",
            "hgfilter", "recon_query_mc", "recon_skinning"} == set(
                rec["stages"])


def test_compile_preflight_budget_and_card():
    from avatarcap_tpu_torch.tools import compile_preflight as cp
    total = 80 << 30
    ok = cp.program_report("frame", 7 << 30, total)
    assert ok["ok"] and ok["budget_gib"] == 80 - cp.MARGIN_BYTES / (1 << 30)
    assert not cp.program_report("stream_b4", total - cp.MARGIN_BYTES,
                                 total)["ok"]
    # it measures a card's memory: on the CPU it refuses
    with pytest.raises(RuntimeError, match="card"):
        cp.main(SMALL_CPU + ["frame"])
    with pytest.raises(SystemExit):
        cp.main(SMALL_CPU + ["movie"])


@pytest.mark.parametrize("tool,argv", [
    ("bench_mc", ["--res", "40", "36", "30", "--max-tris", "20000",
                  "--max-active", "8000", "--iters", "1"]),
    ("bench_raster", ["--tris", "4096", "--res", "128", "--iters", "1"])])
def test_microbenchmarks_main(tool, argv, capsys):
    import importlib
    mod = importlib.import_module(f"avatarcap_tpu_torch.tools.{tool}")
    assert mod.main(argv + ["--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    passes = [r for r in lines if "pass" in r]
    assert len(passes) >= 4
    assert all(p["clock"] == "host" and p["ms"] > 0 for p in passes)
    summary = lines[-1]
    assert summary["device"] == "cpu" and summary["overflow"] is False
    assert summary.get("triangles", summary.get("covered_pixels")) > 0
