"""Faults planted under the timed path, for the tests and for reading a
fault at a cell's own size on the card:

    python3 -m benchmark.tests.faults --workload <cell> --fault <name>
        --seed <n> [--seed <n> ...] --seconds <s>

prints each run's result line. The faults: ``unchanged_state`` (a train
step that leaves the parameters and Adam's state as they were),
``half_batch`` (the train loss over the first half of the batch),
``half_mesh`` (the frame's avatar mesh cut to half its triangles),
``shifted_mesh`` (its vertices moved by 1 cm), ``dim_colors`` (its
colors scaled by 0.8), ``skewed_merge`` (the merged normals scaled by
0.9), ``shifted_layers`` (the back avatar normal image one pixel to the
side)."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _frame(alter):
    from avatarcap_tpu_torch.pipeline.capture import AvatarCapture
    body = AvatarCapture.frame_body

    def broken(self, *a, **kw):
        return alter(body(self, *a, **kw))
    return AvatarCapture, "frame_body", broken


def _half_mesh(out):
    m = out["cano_mesh"]
    out["cano_mesh"] = m._replace(num_tris=m.num_tris // 2)
    return out


def _shifted_mesh(out):
    m = out["cano_mesh"]
    out["cano_mesh"] = m._replace(vertices=m.vertices + 0.01)
    return out


def _dim_colors(out):
    out["avatar_colors"] = out["avatar_colors"] * 0.8
    return out


def _skewed_merge(out):
    out["front_merged_normal"] = out["front_merged_normal"] * 0.9
    return out


def _shifted_layers(out):
    out["back_avatar_normal"] = out["back_avatar_normal"].roll(1, dims=1)
    return out


def _unchanged_state():
    from avatarcap_tpu_torch.train import trainer
    return trainer, "apply_gradients", lambda state, groups, grads, lrs: None


def _half_batch():
    from avatarcap_tpu_torch.train import trainer
    make = trainer.make_loss_terms

    def half(*a, **kw):
        terms = make(*a, **kw)

        def loss_terms(model, batch, generator=None, t_rand=None,
                       timer=None):
            h = batch["near"].shape[0] // 2
            return terms(model, {k: v[:h] for k, v in batch.items()},
                         generator, None if t_rand is None else t_rand[:h],
                         timer)
        return loss_terms
    return trainer, "make_loss_terms", half


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "half_mesh": lambda: _frame(_half_mesh),
          "shifted_mesh": lambda: _frame(_shifted_mesh),
          "dim_colors": lambda: _frame(_dim_colors),
          "skewed_merge": lambda: _frame(_skewed_merge),
          "shifted_layers": lambda: _frame(_shifted_layers)}


@contextlib.contextmanager
def planted(name: str):
    """The program with the named fault, for the duration."""
    owner, attr, value = FAULTS[name]()
    saved = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import run as bench_run
    from benchmark.harness import ROOT, load_json
    spec = load_json(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json"))
    for seed in args.seed:
        with planted(args.fault):
            _, line = bench_run.run_cell(spec, args.workload, seed,
                                         args.seconds, False,
                                         torch.device("cuda:0"))
        print(json.dumps({"fault": args.fault, "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
