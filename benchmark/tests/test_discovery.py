"""A cell, a configuration, a traffic mix or a metric added as a new file
(and a BENCHMARK.json entry) is found by name, with no edit of the
harness; a configuration with networks of another form runs as data."""

import json
import os
import shutil

import torch

import benchmark.metrics
from benchmark import networks, run as bench_run, subject, work
from benchmark.harness import (ROOT, Run, cell_files, cell_metrics,
                               read_metric)
from benchmark.tests.small import SPEC, shrink, small_cfg


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


def test_new_config_with_another_recon_runs_whole(tmp_path, monkeypatch):
    # a configuration file added beside the others, with ReconNet's
    # feature width 16 (the decoder's input 17) and the module path (the
    # port's K2 takes 33 inputs), runs a whole small textured cell
    root = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "configs"), root / "configs")
    shutil.copytree(os.path.join(ROOT, "traffic"), root / "traffic")
    shutil.copytree(os.path.join(ROOT, "limits"), root / "limits")
    cfg = json.loads((root / "configs" / "geotex_sdf.json").read_text())
    cfg["networks"]["recon"]["kwargs"]["feat_channels"] = 16
    cfg["widths"]["recon_in_dim"] = 17
    cfg["capture"]["options"]["use_fused_query"] = False
    (root / "configs" / "geotex_recon16.json").write_text(json.dumps(cfg))
    shutil.copy(root / "limits" / "sdf.textured.json",
                root / "limits" / "recon16.textured.json")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="geotex_recon16",
                                file="benchmark/configs/geotex_recon16.json"))
    spec["workloads"].append({"name": "recon16.textured",
                              "config": "geotex_recon16",
                              "traffic": "textured_closed", "chips": 1,
                              "why": "another ReconNet"})
    cfg = shrink(cell_files(spec, "recon16.textured", root=str(root))[1])
    assert work.k2_macs_per_point(cfg["widths"]) == 179_200
    sdf = small_cfg("sdf.textured")
    assert subject.fit_keys(cfg, "cpu") != subject.fit_keys(sdf, "cpu")

    built = []
    build = networks.build

    def keep(cfg, role, side, **kw):
        built.append((role, side, build(cfg, role, side, **kw)))
        return built[-1][2]
    monkeypatch.setattr(networks, "build", keep)
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        _, line = bench_run.run_cell(SPEC, "sdf.textured", 2 ** 31 + 11, 0.5,
                                     False, "cpu", cfg_override=cfg)
    finally:
        torch.set_num_threads(n)
    assert line["correct"], line["checks"]
    recons = [m for role, _, m in built if role == "recon"]
    assert {side for role, side, _ in built if role == "recon"} == {
        "program", "reference"}
    for m in recons:
        assert m.image_encoder.l0.out_channels == 16
        assert m.image_decoder.fc_list[0][0].weight_v.shape[1] == 17
