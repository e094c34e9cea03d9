"""BENCHMARK.json against the rule that ties a per-layer metric to its
cells: each cell it lists reports the end-to-end metric it moves."""

from benchmark.tests.small import SPEC


def test_each_per_layer_metric_moves_what_its_cells_report():
    cells = [c["name"] for c in SPEC["workloads"]]
    reported = {m["name"]: m.get("workloads", cells)
                for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in reported[m["moves"]], (
                m["name"], cell)
