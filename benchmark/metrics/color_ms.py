"""Device milliseconds a frame of the operations launched under the
program's color stages (spans ``nerf_colors`` and ``color_transfer``: K3,
the anchors' KNN, the dedupe, the gathers), in the stretch with the
program's own spans (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "nerf_colors", "color_transfer")
