"""A capture frame's work (metrics.frame_flops) over the unprofiled frame
time (metrics.iteration_s) and the bf16 dense peak."""

from benchmark import work
from benchmark.metrics import frame_flops, iteration_s


def read(run):
    flops, frame_s = frame_flops(run), iteration_s(run)
    if flops is None or not frame_s:
        return None
    return 100.0 * flops / (frame_s * work.PEAK_BF16_FLOPS)
