"""The window over the steps completed in it (host clock, one synchronise
at the end)."""


def read(run):
    return 1e3 * run.window_s / run.iterations if run.iterations else None
