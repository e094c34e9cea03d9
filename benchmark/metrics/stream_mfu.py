"""capture_mfu in the streaming cells (a frame's work over the unprofiled
frame time and the bf16 dense peak), split from it because those cells
report capture_fps and not frame_p95_ms."""

from benchmark.metrics import capture_mfu


def read(run):
    return capture_mfu.read(run)
