"""Device milliseconds of the geometry stage (U-Net, K1, marching cubes),
per frame."""

from benchmark.metrics import stage_ms


def read(run):
    return stage_ms(run, "geometry")
