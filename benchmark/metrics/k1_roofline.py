"""K1's least time for the device-only stretch's launches (work.k1_bound_s
on each launch's live points, loops/capture.py LiveWork) over its device
time there."""

from benchmark import work
from benchmark.metrics import kernel_ns


def read(run):
    ns = kernel_ns(run, "warp_template_query_kernel")
    if ns is None:
        return None
    w = run.cfg["widths"]
    bound = sum(work.k1_bound_s(w, n) for n in run.counters["k1_points"])
    return 100.0 * bound / (ns * 1e-9)
