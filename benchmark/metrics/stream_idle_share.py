"""capture_idle_share in the streaming cells (metrics.idle_share over an
unprofiled chunk's frame), split from it because those cells report
capture_fps and not frame_p95_ms."""

from benchmark.metrics import idle_share


def read(run):
    return idle_share(run)
