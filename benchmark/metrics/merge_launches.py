"""Kernels launched inside the merge stage, per frame (the stretch with the
stage ranges)."""

from benchmark import trace


def read(run):
    s = run.stage_summary
    if s is None or not s.get("iterations"):
        return None
    n = trace.stage_launches(s).get("merge")
    return None if n is None else n / s["iterations"]
