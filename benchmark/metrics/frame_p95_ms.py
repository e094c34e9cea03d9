"""The 95th percentile of every frame's latency in the window (host clock,
from the call into process_frame until the frame's meshes and colors are
in host memory), nearest rank."""

import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
