"""Peak device memory of each capture program against the card's budget
(counterpart of avatarcap_tpu/tools/compile_preflight.py, whose name it
keeps so that a reader finds it).

The JAX tool compiles each program ahead of time and reads XLA's memory
analysis, because a program that does not fit fails only on the chip.
PyTorch compiles nothing ahead of time, so here each program runs once,
after ``torch.cuda.reset_peak_memory_stats()``, and its
``torch.cuda.max_memory_allocated()`` is held against the budget: the
card's ``total_memory`` less MARGIN_BYTES.

Programs: ``frame`` (the production frame, w_recon), ``nerf`` (the
textured production frame) and ``stream`` (StreamingCapture.run_pipelined
over ``--batch`` frames of distinct poses, every frame's outputs kept).

Usage: python -m avatarcap_tpu_torch.tools.compile_preflight
       [frame] [nerf] [stream] [--batch N] [--small]
prints one JSON line per program; exit code 0 only if every program fits.
It needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

# what the allocator's peak does not count: the CUDA context, cuBLAS and
# cuDNN workspaces, the kernels' modules and the allocator's
# fragmentation (the JAX tool leaves 1.75 GB of a 15.75 GB chip)
MARGIN_BYTES = 4 << 30
PROGRAMS = ("frame", "nerf", "stream")


def program_report(name: str, peak_bytes: int, total_bytes: int) -> dict:
    """One program's peak beside the budget, total_bytes - MARGIN_BYTES."""
    gib = float(1 << 30)
    budget = total_bytes - MARGIN_BYTES
    return {"program": name, "peak_gib": peak_bytes / gib,
            "budget_gib": budget / gib, "total_gib": total_bytes / gib,
            "margin_gib": MARGIN_BYTES / gib, "ok": peak_bytes < budget}


def preflight(capture, item: dict, recon_kw: dict, which=PROGRAMS,
              batch: int = 4) -> list:
    """Run each requested program once on the capture's card and report
    its peak allocated memory against the budget."""
    dev = capture.device
    if dev.type != "cuda":
        raise RuntimeError("compile_preflight measures a card's memory; "
                           f"the capture is on {dev}")
    from avatarcap_tpu_torch.parallel import make_mesh
    from avatarcap_tpu_torch.pipeline.streaming import StreamingCapture
    from avatarcap_tpu_torch.tools.bench_stream import stream_items
    total = torch.cuda.get_device_properties(dev).total_memory
    programs = {
        "frame": lambda: capture.process_frame(item, w_recon=True,
                                               **recon_kw),
        "nerf": lambda: capture.process_frame(item, w_recon=True,
                                              w_nerf=True, **recon_kw),
        "stream": lambda: StreamingCapture(
            capture, make_mesh([dev]), camera=recon_kw["camera"],
            image_size=recon_kw["inferred_normal"].shape[:2],
            neck_vertex_idx=recon_kw["neck_vertex_idx"], w_recon=True,
            w_nerf=True).run_pipelined(
                stream_items(item, batch),
                [recon_kw["inferred_normal"]] * batch)}
    reports = []
    for name in which:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out = programs[name]()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        del out
        reports.append(program_report(
            f"stream_b{batch}" if name == "stream" else name, peak, total))
    return reports


def main(argv=None) -> int:
    from avatarcap_tpu_torch.tools.bench_workloads import (add_subject_args,
                                                           subject_from_args)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("programs", nargs="*",
                    help=f"any of {PROGRAMS} (default: all)")
    ap.add_argument("--batch", type=int, default=4,
                    help="frames of the stream program")
    add_subject_args(ap)
    args = ap.parse_args(argv)
    unknown = set(args.programs) - set(PROGRAMS)
    if unknown:
        ap.error(f"unknown programs {sorted(unknown)}; choose from {PROGRAMS}")
    capture, item, recon_kw, _ = subject_from_args(args)
    reports = preflight(capture, item, recon_kw,
                        tuple(args.programs) or PROGRAMS, args.batch)
    for rep in reports:
        print(json.dumps(rep), flush=True)
    return 0 if all(r["ok"] for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
