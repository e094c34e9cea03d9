"""Device milliseconds of the inverse-skinning stage, per step."""

from benchmark.metrics import stage_ms


def read(run):
    return stage_ms(run, "inverse_skinning")
