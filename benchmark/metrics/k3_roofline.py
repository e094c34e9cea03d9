"""K3's least time for the device-only stretch's launches (work.k3_bound_s
on each launch's live rays, the deduped soup's unique vertices counted by
loops/capture.py LiveWork) over its device time there."""

from benchmark import work
from benchmark.metrics import kernel_ns


def read(run):
    ns = kernel_ns(run, "ray_color_query_kernel")
    if ns is None:
        return None
    opt, w = run.cfg["capture"]["options"], run.cfg["widths"]
    bound = sum(work.k3_bound_s(w, rays, opt["n_samples"],
                                opt["near_flag_anchors"])
                for rays in run.counters["k3_rays"])
    return 100.0 * bound / (ns * 1e-9)
