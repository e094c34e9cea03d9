"""What every cell's run shares: the run record the loops fill, the
metric readers found by name, the checks beside their limits, and the
result line."""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "avatarcap_tpu")


@dataclasses.dataclass
class Run:
    """One run of one cell: what the loop was given, and what it read."""

    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float                       # process start on the host clock
    control: Optional[str] = None   # a control's precision (see reference/)
    setup_s: float = float("nan")
    window_s: float = float("nan")
    iterations: int = 0             # frames or steps completed
    latencies: List[float] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    # a traced run's stretches (benchmark/trace.py), each with the
    # iterations it ran: the device-only profile, the profile with the
    # stage ranges, and the stages' host seconds
    summary: Optional[dict] = None
    stage_summary: Optional[dict] = None
    host_stages: Optional[dict] = None
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, cell_name: str, root: str = ROOT):
    """The cell's entry, its configuration and its mix, found by name:
    the configuration's file from BENCHMARK.json (relative to the folder
    holding ``root``), the mix as ``root``/traffic/<name>.json, the limits
    as ``root``/limits/<cell>.json."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[cell_name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(os.path.dirname(root), cfg_entry["file"]))
    mix = load_json(os.path.join(root, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(root, "limits", cell_name + ".json"))
    return cell, cfg, mix, limits


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a metric without ``workloads``
    belongs to every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if cell_name in m.get("workloads", [cell_name])]


def read_metric(name: str, run: Run) -> Optional[float]:
    """The metric's reader, benchmark/metrics/<name>.py (a dot in the name
    is a folder: dispatch_ms.train is metrics/dispatch_ms/train.py), on
    the run; None where it finds nothing to read."""
    mod = importlib.import_module(f"benchmark.metrics.{name}")
    value = mod.read(run)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


def judged(run: Run) -> bool:
    """Every limited number present, finite and within its limit."""
    return all(name in run.checks and math.isfinite(run.checks[name])
               and run.checks[name] <= limit
               for name, limit in run.limits.items())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(run: Run, metrics: List[dict], device: dict) -> dict:
    """The last line: correct, attempted, failed, the metrics, the device,
    the breakdown of a traced run, and the compared numbers last."""
    values = {}
    for m in metrics:
        v = read_metric(m["name"], run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": judged(run),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": values, "device": device}
    if run.summary is not None:
        from benchmark.trace import op_breakdown
        line["breakdown"] = {
            "device_ops": op_breakdown(run.summary["kernels"]),
            "idle_gaps": (run.stage_summary or {}).get("idle_gaps", [])}
    line["checks"] = {k: {"value": run.checks.get(k), "limit": lim}
                      for k, lim in run.limits.items()}
    return line
