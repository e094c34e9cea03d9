"""A whole small run on the CPU, and the last line's keys against the
contract."""

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import cell_metrics
from benchmark.tests.small import SPEC, small_cfg

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
def test_train_cell_line_keys(trace, capsys):
    cell = "sdf.train_b4"
    run, line = bench_run.run_cell(SPEC, cell, 2 ** 31 + 5, 1.0, bool(trace),
                                   "cpu", cfg_override=small_cfg(cell))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["correct"]
    assert line["attempted"] >= 4 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    want = {m["name"] for m in cell_metrics(SPEC, cell, bool(trace))}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for k, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    bench_run.report(run, line)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(line))
    assert err.strip().splitlines()[-1].startswith("check ")


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench_run.main(["--workload", "sdf.train_b4", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        bench_run.run_cell(SPEC, "no.such_cell", 1, 1.0, False, "cpu")
