"""A cell, a configuration, a traffic mix or a metric added as a new file
(and a BENCHMARK.json entry) is found by name, with no edit of the
harness."""

import json
import os
import shutil

import benchmark.metrics
from benchmark.harness import (ROOT, Run, cell_files, cell_metrics,
                               read_metric)
from benchmark.tests.small import SPEC


def test_new_config_mix_and_cell_are_found(tmp_path):
    root = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(ROOT, d), root / d)
    cfg = json.loads((root / "configs" / "geotex_sdf.json").read_text())
    cfg["vol_res"] = [256, 256, 96]
    (root / "configs" / "geotex_new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "avatar_closed.json").read_text())
    mix["frames"] = 7
    (root / "traffic" / "avatar_new.json").write_text(json.dumps(mix))
    (root / "limits" / "new.cell.json").write_text(json.dumps({"x": 1.0}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="geotex_new",
                                file="benchmark/configs/geotex_new.json"))
    spec["workloads"].append({"name": "new.cell", "config": "geotex_new",
                              "traffic": "avatar_new", "chips": 1,
                              "why": "a new cell"})
    cell, c, m, lim = cell_files(spec, "new.cell", root=str(root))
    assert c["vol_res"] == [256, 256, 96] and m["frames"] == 7
    assert lim == {"x": 1.0} and cell["config"] == "geotex_new"
    # a metric without "workloads" belongs to every cell, the new one too
    assert "setup_s" in {x["name"] for x in cell_metrics(spec, "new.cell",
                                                          False)}


def test_new_metric_reader_is_found(tmp_path):
    (tmp_path / "frames_twice.py").write_text(
        "def read(run):\n    return 2 * run.iterations\n")
    benchmark.metrics.__path__.append(str(tmp_path))
    try:
        run = Run(cell="c", cfg={}, mix={}, seed=0, seconds=1.0, trace=False,
                  device="cpu", t0=0.0, iterations=21)
        assert read_metric("frames_twice", run) == 42.0
    finally:
        benchmark.metrics.__path__.remove(str(tmp_path))


def test_every_named_file_exists():
    for cell in SPEC["workloads"]:
        cell_files(SPEC, cell["name"])
    for key in ("end_to_end", "per_layer"):
        for m in SPEC[key]:
            assert os.path.exists(os.path.join(
                ROOT, "metrics", m["name"].replace(".", os.sep) + ".py"))
