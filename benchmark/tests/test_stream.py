"""The streaming loop (loops/stream.py) at the small sizes on the CPU: it
counts whole chunks of frames, fills the checks (and they pass), and a
traced run fills the three stretches the readers use; PIFu's ReconNet runs
through the program's plain K2w path there."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import Run, cell_files, cell_metrics, result_line
from benchmark.metrics import (capture_idle_share, capture_mfu,
                               stream_idle_share, stream_mfu)
from benchmark.tests.small import SPEC, small_cfg


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(cell, trace, seconds=0.5):
    mix = dict(cell_files(SPEC, cell)[2], chunk=2, warm_frames=2,
               trace_frames=2)
    r = Run(cell=cell, cfg=small_cfg(cell), mix=mix, seed=2 ** 31 + 17,
            seconds=seconds, trace=trace, device=torch.device("cpu"),
            t0=bench_run.T0, limits=cell_files(SPEC, cell)[3])
    bench_run.execute(r)
    return r


@pytest.mark.parametrize("trace", [False, True])
def test_stream_loop_counts_checks_and_traces(trace):
    r = _run("pifu.production_stream", trace)
    assert r.iterations > 0 and r.iterations % 2 == 0
    assert r.attempted == r.iterations and r.window_s > 0
    assert set(r.limits) <= set(r.checks)
    assert r.notes["checked_frames"][-1] == 2 + r.iterations - 1
    if not trace:
        return
    assert r.iterations == 6
    assert r.host_stages["iterations"] == 2 and r.host_stages["window_s"] > 0
    assert r.summary["iterations"] == 2 and r.stage_summary is not None
    assert r.span_summary["iterations"] == 2
    # PIFu's decoder runs as K2w's spans, never K2's, with live counts
    ks = [op for op in r.span_summary["ops"] if op["name"] in ("k2", "k2w")]
    assert ks and {op["name"] for op in ks} == {"k2w"}
    assert all(0 < op["live"] <= op["rows"] for op in ks)
    assert r.notes["spans"]["k2w"] == len(ks)
    assert len(r.counters["k1_points"]) == 4      # coarse and refine a frame
    line = result_line(r, cell_metrics(SPEC, r.cell, True),
                       {"platform": "cpu"})
    # the CPU trace holds no device kernels: the device metrics stay out
    assert "k2w_roofline" not in line["metrics"]
    # the stream cells' split readers read as the capture cells' do
    assert stream_idle_share.read(r) == capture_idle_share.read(r)
    assert stream_mfu.read(r) == capture_mfu.read(r)


def test_stream_loop_judges_the_textured_frame():
    r = _run("sdf.textured_stream", False, seconds=0.1)
    assert r.iterations == 2 and "color_gap" in r.checks
    line = result_line(r, cell_metrics(SPEC, r.cell, False),
                       {"platform": "cpu"})
    assert line["correct"], line["checks"]
    assert line["metrics"]["capture_fps"]["value"] > 0
