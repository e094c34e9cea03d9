"""Host milliseconds inside the merge stage, per frame, in the host-timed
stretch (no profiler, no synchronise)."""


def read(run):
    h = run.host_stages
    if not h or not h["iterations"] or "merge" not in h["seconds"]:
        return None
    return 1e3 * h["seconds"]["merge"] / h["iterations"]
