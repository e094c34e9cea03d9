"""Frames completed in the window over the window's seconds (host clock)."""


def read(run):
    return run.iterations / run.window_s if run.iterations else None
