"""K2w's least time for the launches of the stretch with the program's own
spans (work.launch_bound_s on each ``k2w`` span's live points: the
float32 input row in and the occupancy out, work.k2_bytes_per_point, and
the decoder's weights once, all from the configuration's widths) over
recon_decode_wide_kernel's device time in that stretch
(benchmark/spans.py). None where no ``k2w`` span or no such kernel ran,
as in a program without K2w."""

from benchmark import spans, work


def read(run):
    s = spans.summary(run)
    if s is None:
        return None
    ns = spans.kernel_ns(s, "recon_decode_wide_kernel")
    lives = [op["live"] for op in s["ops"] if op["name"] == "k2w"]
    if ns is None or not lives:
        return None
    w = run.cfg["widths"]
    wb = work.weight_bytes(work.recon_shapes(w))
    bound = sum(work.launch_bound_s(n, work.k2_macs_per_point(w),
                                    work.k2_bytes_per_point(w), wb)
                for n in lives)
    return 100.0 * bound / (ns * 1e-9)
