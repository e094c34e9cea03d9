"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control fp8|tf32]

from the root of a checkout (avatarcap_tpu_torch beside this folder). The
cell's configuration, traffic mix, limits and metric readers are found by
name (BENCHMARK.json, traffic/<mix>.json, limits/<cell>.json,
metrics/<metric>.py); the mix names its loop (loops/<loop>.py). The last
line of standard output is one JSON object: correct, attempted, failed,
the metrics (the cell's end-to-end ones, or with --trace 1 its per-layer
ones), the device, a traced run's breakdown, and the numbers compared,
each beside its limit, which are also the last lines of standard error.
``--control`` puts the reference, one precision lower, in the program's
place (the benchmark's own runs never do).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8", "tf32"), default=None)
    args = ap.parse_args(argv)

    from benchmark.harness import (ROOT, cell_files, forbidden_modules,
                                   load_json)
    spec = load_json(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json"))
    cell = cell_files(spec, args.workload)[0]
    # any Triton cache stays inside the checkout (the program's kernels
    # build into its build/kernels/)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "cache", "triton"))

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    run, line = run_cell(spec, args.workload, args.seed, args.seconds,
                         bool(args.trace), device, args.control)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 3
    if line is None:
        print("benchmark: the trace holds no window", file=sys.stderr)
        return 4
    report(run, line)
    return 0


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, control=None, cfg_override=None):
    """Everything of a run after the look for the card: the cell's loop on
    ``device``, then its result line (None for a traced run whose trace
    holds no window). ``cfg_override`` replaces the configuration (the
    tests' small sizes)."""
    import torch
    from benchmark.harness import Run, cell_files, cell_metrics, result_line
    cell, cfg, mix, limits = cell_files(spec, cell_name)
    run = Run(cell=cell_name, cfg=cfg_override or cfg, mix=mix, seed=seed,
              seconds=seconds, trace=trace, device=torch.device(device),
              t0=T0, control=control, limits=limits)
    execute(run)
    cuda = run.device.type == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(run.device) if cuda
                else "cpu", "count": cell["chips"],
                "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace:
        if run.summary is None or run.stage_summary is None:
            return run, None
        dev_info["busy_s"] = run.summary["busy_ns"] * 1e-9
        dev_info["window_s"] = run.summary["window_ns"] * 1e-9
    return run, result_line(run, cell_metrics(spec, cell_name, run.trace),
                            dev_info)


def execute(run) -> None:
    """The mix's loop on the run."""
    importlib.import_module(f"benchmark.loops.{run.mix['loop']}").run(run)


def report(run, line: dict) -> None:
    """The compared numbers beside their limits on standard error, then
    the result line on standard output, each last."""
    lat = sorted(run.latencies)
    if lat:
        run.notes["latency_ms"] = [round(1e3 * lat[int(q * (len(lat) - 1))],
                                         3) for q in (0, .25, .5, .75, 1)]
    print(json.dumps({"notes": run.notes, "unlimited_checks": {
        k: v for k, v in run.checks.items() if k not in run.limits}},
        default=str), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
