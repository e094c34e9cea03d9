"""benchmark/spans.py's attribution and the readers of the program's
spans, on hand-made spans, device operations and launches."""

import types

import pytest

from benchmark import spans, work
from benchmark.metrics import (color_ms, k2_roofline, knn_ms, mc_ms,
                               merge_idle_share)
from benchmark.tests.small import small_cfg


def _span(sid, name, start, end, parent=None, kind="stage", **counts):
    return types.SimpleNamespace(id=sid, name=name, start_ns=start,
                                 end_ns=end, parent=parent, kind=kind,
                                 counts=counts)


# one frame on the host's clock: [0, 100) the root; merge [10, 40);
# nerf_colors [40, 80) holding knn [45, 55) and k3 [60, 70)
SPANS = [_span(0, "frame", 0, 100, kind="frame"),
         _span(1, "merge", 10, 40, 0),
         _span(2, "nerf_colors", 40, 80, 0),
         _span(3, "knn", 45, 55, 2, kind="op"),
         _span(4, "k3", 60, 70, 2, kind="op", rows=8, live=5)]


def test_innermost_span_at_a_time():
    where = spans.Innermost(SPANS)
    assert where.chain(5) == ["frame"]
    assert where.chain(10) == ["merge", "frame"]
    assert where.chain(50) == ["knn", "nerf_colors", "frame"]
    # after knn closed, before k3 opened: its parent holds the time
    assert where.chain(57) == ["nerf_colors", "frame"]
    assert where.chain(65) == ["k3", "nerf_colors", "frame"]
    assert where.chain(100) == [] and where.chain(-1) == []


def _kernel(corr, start, dur, name="kern(int)"):
    return {"name": name, "start": start, "dur": dur, "corr": corr}


def test_launches_and_gaps_go_to_the_innermost_span():
    """Each operation to the spans holding its launch (inclusive of the
    parents), each idle gap to those holding its middle; a launch under no
    span and a gap outside every span are kept apart."""
    kernels = [_kernel(1, 20, 10), _kernel(2, 50, 5, "knn_tile(float)"),
               _kernel(3, 66, 20), _kernel(4, 95, 3), _kernel(5, 300, 5)]
    # launch stamps: merge, knn, k3, no span, and one past the window
    launches = {1: 12, 2: 46, 3: 61, 4: 120, 5: 130}
    s = spans.attribute(kernels, launches, (0, 110), SPANS, 2)
    assert s["device_ns"] == {"merge": 10, "frame": 35, "knn": 5,
                              "nerf_colors": 25, "k3": 20}
    assert s["launches"] == {"merge": 1, "frame": 3, "knn": 1,
                             "nerf_colors": 2, "k3": 1}
    # gaps [0, 20) mid 10 merge; [30, 50) mid 40 nerf_colors;
    # [55, 66) mid 60 k3; [86, 95) mid 90 frame; [98, 110) mid 104 none
    assert s["idle_ns"] == 110 - 38 == 20 + 20 + 11 + 9 + 12
    assert s["idle_under_ns"] == {"merge": 20, "nerf_colors": 31, "k3": 11,
                                  "frame": 60}
    assert s["idle_outside_ns"] == 12
    assert [g[0] for g in s["idle_gaps"]] == ["merge", "nerf_colors",
                                             "(no span)", "k3", "frame"]
    assert s["kernel_ns"] == {"kern(int)": 33, "knn_tile(float)": 5}
    assert s["ops"] == [{"rows": 8, "live": 5, "name": "k3"}]
    note = spans.idle_note(s)
    assert note["outside_share"] == pytest.approx(100 * 12 / 72)
    assert note["idle_ms"]["merge"] == pytest.approx(20e-6 / 2)


def _run(summary, cell="sdf.textured"):
    return types.SimpleNamespace(span_summary=summary, cfg=small_cfg(cell))


def _summary(**kw):
    base = {"window_ns": 10 ** 9, "busy_ns": 5 * 10 ** 8,
            "idle_ns": 5 * 10 ** 8, "iterations": 2, "device_ns": {},
            "launches": {}, "idle_under_ns": {}, "idle_outside_ns": 0,
            "kernel_ns": {}, "idle_gaps": [], "ops": []}
    return dict(base, **kw)


def test_device_time_readers():
    s = _summary(device_ns={"nerf_colors": 6_000_000,
                            "color_transfer": 2_000_000, "knn": 3_000_000,
                            "marching_tets": 1_000_000})
    assert color_ms.read(_run(s)) == pytest.approx(4.0)
    assert knn_ms.read(_run(s)) == pytest.approx(1.5)
    assert mc_ms.read(_run(s)) == pytest.approx(0.5)
    empty = _summary()
    for reader in (color_ms, knn_ms, mc_ms, merge_idle_share, k2_roofline):
        assert reader.read(_run(None)) is None
        assert reader.read(_run(empty)) is None
        assert reader.read(_run(dict(s, iterations=0))) is None
    # a run that is not traced, or of another loop, has no such stretch
    for run in (types.SimpleNamespace(trace=False, mix={"loop": "capture"}),
                types.SimpleNamespace(trace=True, mix={"loop": "train"})):
        assert mc_ms.read(run) is None and run.span_summary is None


def test_merge_idle_share():
    s = _summary(idle_under_ns={"merge": 2 * 10 ** 8, "frame": 5 * 10 ** 8})
    assert merge_idle_share.read(_run(s)) == pytest.approx(40.0)


def test_k2_roofline_from_the_live_counts():
    w = small_cfg("sdf.textured")["widths"]
    ops = [{"name": "k2", "rows": 1000, "live": 600},
           {"name": "k2", "rows": 500, "live": 200},
           {"name": "k1", "rows": 1000, "live": 900}]
    ns = 10 ** 6
    s = _summary(ops=ops, kernel_ns={
        "(anonymous namespace)::recon_decode_kernel(float const*)": ns,
        "void other_kernel(int)": 5 * ns})
    wb = work.weight_bytes(work.recon_shapes(w))
    bound = sum(work.launch_bound_s(n, work.k2_macs_per_point(w), 136, wb)
                for n in (600, 200))
    assert k2_roofline.read(_run(s)) == pytest.approx(100 * bound / 1e-3)
    assert k2_roofline.read(_run(dict(s, kernel_ns={}))) is None
    assert k2_roofline.read(_run(dict(s, ops=ops[2:]))) is None
