"""union_ns, the idle gaps and the idle share on hand-made intervals."""

import time
import types

import pytest

from benchmark import trace
from benchmark.metrics import idle_share, kernel_ns, stage_ms


def test_union_of_overlapping_and_disjoint_intervals():
    assert trace.union_ns([]) == 0
    assert trace.union_ns([(0, 10)]) == 10
    assert trace.union_ns([(0, 10), (5, 15), (20, 25)]) == 20
    assert trace.union_ns([(20, 25), (0, 10), (10, 12)]) == 17
    assert trace.union_ns([(0, 100), (10, 20), (30, 40)]) == 100


def test_clip_and_gaps_within_the_window():
    spans = [(-5, 10), (20, 30), (25, 35), (90, 120)]
    assert trace.clip(spans, 0, 100) == [(0, 10), (20, 30), (25, 35),
                                          (90, 100)]
    assert trace.idle_gaps(spans, 0, 100) == [(10, 20), (35, 90)]
    assert trace.idle_gaps([], 0, 100) == [(0, 100)]


def _run(summary, iterations=2, host_s=None):
    # the same reduced stretch as the device-only and the staged one; the
    # host-timed stretch as long as the profiled one unless given
    host = None
    if summary is not None:
        summary = dict(summary, iterations=iterations)
        host = {"iterations": iterations, "seconds": {}, "window_s":
                summary["window_ns"] * 1e-9 if host_s is None else host_s}
    return types.SimpleNamespace(summary=summary, stage_summary=summary,
                                 host_stages=host, iterations=iterations)


def test_idle_share_over_the_whole_window():
    # kernels cover 10 + 15 of a 100 ns window: 75% idle, not the share of
    # the stretch from the first kernel to the last
    spans = [(20, 30), (40, 55)]
    busy = trace.union_ns(trace.clip(spans, 0, 100))
    s = {"window_ns": 100, "busy_ns": busy, "kernels": []}
    assert idle_share(_run(s)) == pytest.approx(75.0)
    assert idle_share(_run(None)) is None
    assert idle_share(_run(s, iterations=0)) is None


def test_idle_share_against_the_unprofiled_iteration():
    # 25 ns busy over two iterations; unprofiled, the two took 50 ns (the
    # profiled stretch's 100 ns is the profiler's): 50% idle
    s = {"window_ns": 100, "busy_ns": 25, "kernels": []}
    assert idle_share(_run(s, host_s=50e-9)) == pytest.approx(50.0)


def test_stage_time_sums_its_kernels_per_iteration():
    kern = [{"name": "a", "start": 0, "dur": 4_000_000, "stage": "geometry"},
            {"name": "b", "start": 5, "dur": 2_000_000, "stage": "geometry"},
            {"name": "c", "start": 9, "dur": 1_000_000, "stage": None}]
    s = {"window_ns": 10 ** 9, "busy_ns": 1, "kernels": kern}
    assert stage_ms(_run(s), "geometry") == pytest.approx(3.0)
    assert stage_ms(_run(s), "merge") is None
    assert trace.op_breakdown(kern, top=2) == [["a", 0.004], ["b", 0.002]]


def test_kernel_time_by_function_name():
    names = ["(anonymous namespace)::warp_template_query_kernel(float const*, "
             "int)", "void warp_template_query_kernel(int)",
             "void other_warp_template_query_kernel(int)",
             "warp_template_query_kernel_v2(int)"]
    kern = [{"name": n, "start": 0, "dur": 10 ** i, "stage": None}
            for i, n in enumerate(names)]
    s = {"window_ns": 10 ** 9, "busy_ns": 1, "kernels": kern}
    assert kernel_ns(_run(s), "warp_template_query_kernel") == 11
    assert kernel_ns(_run(s), "ray_color_query_kernel") is None


def test_host_stages_add_each_stage_time():
    host = trace.HostStages()
    for _ in range(3):
        with host("merge"):
            time.sleep(0.01)
        with host("geometry"):
            pass
    assert 0.03 <= host.seconds["merge"] < 0.5
    assert host.seconds["geometry"] < host.seconds["merge"]
