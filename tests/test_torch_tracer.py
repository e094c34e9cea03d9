"""The program's tracer (utils/timers.Tracer) on the CPU: a small random
subject on the kernels' path (their plain versions), a 24 x 24 x 16 grid,
64^2 renders, 2 merge steps, 4 samples a color ray.

Held: the frames' outputs are the same bits with and without a tracer;
the span tree (one root per frame, the stages under it, the layers under
the stages); the kernels' live counts are those of the benchmark's
harness-side wrappers (benchmark/loops/capture.py LiveWork, rebuilt here);
the stamps lie on torch.profiler's clock, their offset taken from the
read least disturbed; an untraced frame makes no span and a foreign stage
hook sees the stages alone, in order, not nested.
"""

import contextlib
import time

import pytest
import torch

from avatarcap_tpu_torch.pipeline import capture as capture_module
from avatarcap_tpu_torch.utils import timers
from avatarcap_tpu_torch.utils.timers import (NO_SPAN, Tracer, count,
                                              frame_span, frame_summaries,
                                              live_rows, span)

OPTIONS = dict(max_tris=1 << 13, max_active=1 << 12, refine_capacity=1 << 14,
               recon_max_tris=0, recon_max_active=0, recon_refine_capacity=0,
               raster_max_candidates=0, render_res=64, skin_row_group=1,
               fusion_iters=2, nerf_unique_capacity=1 << 10,
               recon_unique_capacity=1 << 10, n_samples=4)
FORMS = {"avatar_only": dict(w_recon=False, w_nerf=False),
         "textured": dict(w_recon=True, w_nerf=True)}
STAGES = {"avatar_only": ["geometry", "skinning", "cano_layers"],
          "textured": ["geometry", "skinning", "lift", "cano_layers",
                       "merge", "hgfilter", "recon_query_mc",
                       "recon_skinning", "nerf_colors", "color_transfer"]}
# (op span, the stage it lies in), in the order they open
OPS = {"avatar_only": [("k1", "geometry"), ("k1", "geometry"),
                       ("marching_tets", "geometry")],
       "textured": [("k1", "geometry"), ("k1", "geometry"),
                    ("marching_tets", "geometry"),
                    ("k2", "recon_query_mc"), ("k2", "recon_query_mc"),
                    ("marching_tets", "recon_query_mc"),
                    ("knn", "nerf_colors"), ("k3", "nerf_colors"),
                    ("knn", "color_transfer"), ("k3", "color_transfer")]}


@pytest.fixture(scope="module")
def subject():
    from avatarcap_tpu_torch.tools.bench_workloads import (
        CAPTURE_OPTIONS, build_capture_subject)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    capture, item, recon_kw, _ = build_capture_subject(
        "cpu", vol_res=(24, 24, 16), dense=False, fit=False, img_res=64,
        options=dict(CAPTURE_OPTIONS, **OPTIONS))
    yield capture, item, recon_kw
    torch.set_num_threads(n)


class StageHook:
    """A foreign stage hook: the names it is handed, and how deep its
    stages nest."""

    def __init__(self):
        self.names, self.depth, self.deepest = [], 0, 0

    @contextlib.contextmanager
    def __call__(self, name):
        self.names.append(name)
        self.depth += 1
        self.deepest = max(self.deepest, self.depth)
        try:
            yield
        finally:
            self.depth -= 1


def live_work(mp):
    """The harness's LiveWork wrappers of three capture-module calls: K1's
    points that are not the padding (the origin), each query's refined
    nodes up to its capacity, each deduped soup's live unique vertices."""
    got = {"k1": [], "refined": [], "k3": []}
    k1_fn = capture_module.warp_template_query
    hier_fn = capture_module.hierarchical_volume
    dedupe_fn = capture_module._dedupe_soup

    def k1(packed_offset, packed_template, pts, *a, **kw):
        got["k1"].append(int((pts != 0).any(-1).sum()))
        return k1_fn(packed_offset, packed_template, pts, *a, **kw)

    def hier(*a, **kw):
        vol, ovf, n_r = hier_fn(*a, **dict(kw, with_stats=True))
        cap = a[7] if len(a) > 7 else kw["refine_capacity"]
        got["refined"].append(int(torch.clamp(n_r, max=cap)))
        return vol, ovf

    def dedupe(*a, **kw):
        out = dedupe_fn(*a, **kw)
        got["k3"].append(int(out[3].sum()))
        return out
    mp.setattr(capture_module, "warp_template_query", k1)
    mp.setattr(capture_module, "hierarchical_volume", hier)
    mp.setattr(capture_module, "_dedupe_soup", dedupe)
    return got


def _refuse(*a, **kw):
    raise AssertionError("an untraced frame made tracer state")


@pytest.fixture(scope="module")
def frames(subject):
    """Per form, one frame three times: untraced (making a Span or a CUDA
    event raises), through a foreign hook, and through a Tracer with the
    LiveWork wrappers in place."""
    capture, item, recon_kw = subject
    out = {}
    for form, f in FORMS.items():
        kw = dict(f, **(recon_kw if f["w_recon"] else {}))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(timers.Span, "__init__", _refuse)
            mp.setattr(torch.cuda, "Event", _refuse)
            plain = capture.process_frame(item, **kw)
        hook = StageHook()
        foreign = capture.process_frame(item, timer=hook, **kw)
        tracer = Tracer("cpu")
        with pytest.MonkeyPatch.context() as mp:
            live = live_work(mp)
            traced = capture.process_frame(item, timer=tracer, **kw)
        out[form] = dict(plain=plain, foreign=foreign, hook=hook,
                         traced=traced, spans=tracer.collect(), live=live)
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@pytest.mark.parametrize("form", list(FORMS))
def test_frames_are_the_same_bits_with_a_tracer(frames, form):
    """A Tracer or a foreign hook changes no output bit; the traced frame
    adds only its root span's id."""
    f = frames[form]
    assert set(f["traced"]) - set(f["plain"]) == {"frame_id"}
    assert set(f["foreign"]) == set(f["plain"])
    ref = _tensors(f["plain"])
    for other in (f["traced"], f["foreign"]):
        got = _tensors({k: v for k, v in other.items() if k != "frame_id"})
        assert len(got) == len(ref) > 8
        for a, b in zip(got, ref):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("form", list(FORMS))
def test_foreign_hook_sees_the_stages_alone(frames, form):
    """A hook that is not a Tracer gets the frame's stages, in order, not
    nested, and no frame root or layer span."""
    hook = frames[form]["hook"]
    assert hook.names == STAGES[form] and hook.deepest == 1


@pytest.mark.parametrize("form", list(FORMS))
def test_span_tree(frames, form):
    """One root ``frame`` per call, whose id every span carries and the
    results return; the stages under the root; knn, marching_tets and
    the kernels under their stages; each span inside its parent's
    stamps; no device times on the CPU."""
    spans = frames[form]["spans"]
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert (root.name, root.kind, root.frame) == ("frame", "frame", root.id)
    assert frames[form]["traced"]["frame_id"] == root.id
    assert all(s.frame == root.id for s in spans)
    stages = [s for s in spans if s.kind == "stage"]
    assert [s.name for s in stages] == STAGES[form]
    assert all(s.parent == root.id for s in stages)
    assert [(s.name, by_id[s.parent].name) for s in spans
            if s.kind == "op"] == OPS[form]
    for s in spans:
        assert s.device_ms is None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    summary = frame_summaries(spans)[root.id]
    assert list(summary["stages"]) == STAGES[form]
    assert set(summary["counts"]) == {n for n, _ in OPS[form]} & {
        "k1", "k2", "k3"}


@pytest.mark.parametrize("form", list(FORMS))
def test_kernel_live_counts_are_the_harness_counts(frames, subject, form):
    """Each k1 / k2 / k3 span's live rows are what the harness's wrappers
    count: K1's unpadded points; K2's coarse launch the coarse band (K1's
    coarse count), its refine launch ReconNet's refined nodes; K3 the
    deduped soups' unique vertices. Its rows are the launch's."""
    f = frames[form]
    grid = subject[0].grid
    ops = {}
    for s in f["spans"]:
        if s.kind == "op" and s.name in ("k1", "k2", "k3"):
            ops.setdefault(s.name, []).append(s.counts)
    live = f["live"]
    assert [c["live"] for c in ops["k1"]] == live["k1"]
    assert live["k1"][1] == live["refined"][0]
    n_cells = grid.vol_res[0] * grid.vol_res[1] * grid.vol_res[2]
    refine_rows = min(OPTIONS["refine_capacity"], n_cells)
    assert [c["rows"] for c in ops["k1"]] == [grid.c_pts.shape[0],
                                             refine_rows]
    assert 0 < live["k1"][0] < grid.c_pts.shape[0]
    if form == "textured":
        assert [c["live"] for c in ops["k2"]] == [live["k1"][0],
                                                 live["refined"][1]]
        assert [c["live"] for c in ops["k3"]] == live["k3"]
        assert [c["rows"] for c in ops["k3"]] == [
            OPTIONS["nerf_unique_capacity"], OPTIONS["recon_unique_capacity"]]
    else:
        assert set(ops) == {"k1"}


def test_streamed_frames_get_their_own_ids(subject, frames):
    """run_pipelined and run hand the tracer to each frame: one root per
    frame, a distinct id each, returned with its results, the frame's
    spans under it, and the outputs of process_frame."""
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    capture, item, _ = subject
    sc = StreamingCapture(capture, ["cpu"], frames_per_device=2)
    tracer = Tracer("cpu")
    results = (sc.run_pipelined([item, item], timer=tracer)
               + sc.run([item, item], timer=tracer))
    spans = tracer.collect()
    roots = [s for s in spans if s.kind == "frame"]
    assert len(roots) == 4 and len({r.id for r in roots}) == 4
    assert [r["frame_id"] for r in results] == [r.id for r in roots]
    summaries = frame_summaries(spans)
    for r in roots:
        assert list(summaries[r.id]["stages"]) == STAGES["avatar_only"]
        assert sum(s.frame == r.id for s in spans) == 1 + 3 + 3
    ref = frames["avatar_only"]["plain"]["cano_mesh"].vertices
    assert all(torch.equal(r["cano_mesh"].vertices, ref) for r in results)


def test_span_stamps_lie_on_the_profilers_clock():
    """Spans opened between two torch.profiler ranges are stamped between
    the profiler's stamps of those ranges (5 ms apart, well beyond the two
    clocks' sub-millisecond offset)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracer = Tracer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("before"):
            time.sleep(0.001)
        time.sleep(0.005)
        with tracer("stage"):
            with span("op"):
                time.sleep(0.001)
        time.sleep(0.005)
        with record_function("after"):
            time.sleep(0.001)
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()
          if e.name() in ("before", "after")}
    spans = tracer.collect()
    assert [s.name for s in spans] == ["stage", "op"]
    for s in spans:
        assert ev["before"].end_ns() < s.start_ns < s.end_ns \
            < ev["after"].start_ns()


def test_unix_offset_keeps_the_tightest_read(monkeypatch):
    """A thread switched out between the wall clock's read and the
    monotonic one's shifts that pair's offset; the offset is taken from
    the read the monotonic clock brackets most tightly."""
    # monotonic reads around each wall read: the first pair 30 ms apart
    # (switched out after the wall read), the second 2 us apart
    mono = iter([1_000, 30_001_000, 40_000_000, 40_002_000])
    wall = iter([5_000_001_000, 5_040_001_000])
    monkeypatch.setattr(timers.time, "perf_counter_ns", lambda: next(mono))
    monkeypatch.setattr(timers.time, "time_ns", lambda: next(wall))
    assert timers._unix_offset_ns(tries=2) == 5_040_001_000 - 40_001_000


def test_untraced_calls_are_the_shared_no_op():
    """Without a current tracer the module's calls make nothing: the
    shared no-op (also for a foreign hook's frame), and no tracer is left
    current once a tracer's spans close."""
    assert timers._current.tracer is None
    assert span("k1") is NO_SPAN and live_rows(3) is NO_SPAN
    assert frame_span(None) is NO_SPAN
    assert frame_span(lambda name: NO_SPAN) is NO_SPAN
    assert count("rows", 3) is None
    tracer = Tracer("cpu")
    with tracer("stage"):
        assert timers._current.tracer is tracer
        assert live_rows(None) is NO_SPAN
    assert timers._current.tracer is None


def test_live_rows_are_taken_in_order():
    """Launches inside a live_rows scope take its live rows in order (the
    slabs of one set of points); launches outside count every row; the
    counts are read at collect, a tensor's with the rest; collect
    forgets."""
    tracer = Tracer("cpu")
    with tracer("stage"):
        with live_rows(torch.tensor(5, dtype=torch.int32)):
            for _ in range(3):
                with span("k"):
                    count("rows", 4)
        with span("k"):
            count("rows", 2)
            count("rows", 1)
    spans = tracer.collect()
    assert [(s.counts["rows"], s.counts["live"]) for s in spans[1:]] == [
        (4, 4), (4, 1), (4, 0), (3, 3)]
    assert tracer.collect() == []
