"""Share of an unprofiled iteration in which no kernel, copy or fill runs
on the card (metrics.idle_share)."""

from benchmark.metrics import idle_share


def read(run):
    return idle_share(run)
