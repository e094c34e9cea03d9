"""The comparison catches what it is there to catch. A whole small run on
the CPU (the look for a card skipped) with the timed path broken
underneath must come out not correct, once for each fault a cell can
have: a step that returns its state unchanged and half of the batch left
out (training), an answer altered where it is produced (capture); and
the controls, the reference a precision lower in the program's place.
The unbroken runs come out correct. The cells are on one chip: no
exchange between chips to leave out."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.faults import planted
from benchmark.tests.small import SPEC, small_cfg

SEED = 2 ** 31 + 99


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _line(cell, control=None):
    return bench_run.run_cell(SPEC, cell, SEED, 0.5, False, "cpu", control,
                              small_cfg(cell))[1]


@pytest.mark.parametrize("cell", ["sdf.train_b4", "occ.avatar_only",
                                  "sdf.textured"])
def test_unbroken_run_is_correct(cell):
    assert _line(cell)["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("occ.avatar_only", "half_mesh"), ("occ.avatar_only", "shifted_mesh"),
    ("sdf.textured", "half_mesh"), ("sdf.textured", "dim_colors"),
    ("sdf.textured", "skewed_merge"), ("sdf.textured", "shifted_layers"),
    ("sdf.train_b4", "unchanged_state"), ("sdf.train_b4", "half_batch")])
def test_planted_fault_is_not_correct(cell, fault):
    with planted(fault):
        line = _line(cell)
    assert not line["correct"]
    if fault == "unchanged_state":
        assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["occ.avatar_only", "sdf.textured"])
def test_fp8_control_is_not_correct(cell):
    assert not _line(cell, "fp8")["correct"]


@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    line = bench_run.run_cell(SPEC, "sdf.train_b4", SEED, 1.0, False,
                              "cuda", "tf32")[1]
    assert not line["correct"]
