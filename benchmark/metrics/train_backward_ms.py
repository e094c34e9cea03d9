"""Device milliseconds of the backward stage, per step."""

from benchmark.metrics import stage_ms


def read(run):
    return stage_ms(run, "backward")
