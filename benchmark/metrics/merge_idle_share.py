"""Share of the device's idle time, in the stretch with the program's own
spans, that falls while the host is inside the ``merge`` stage (each idle
gap put under the span open at its middle, benchmark/spans.py)."""

from benchmark import spans


def read(run):
    s = spans.summary(run)
    if s is None or not s["idle_ns"] or "merge" not in s["idle_under_ns"]:
        return None
    return 100.0 * s["idle_under_ns"]["merge"] / s["idle_ns"]
