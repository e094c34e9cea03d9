"""Device milliseconds a frame of the operations launched under the
program's ``knn`` spans (ops/knn.knn: the color rays' anchor distances,
the nearest-vertex transfers), in the stretch with the program's own
spans (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "knn")
