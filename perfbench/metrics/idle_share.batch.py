"""Share of the profiled sub-window in which no device operation ran, %."""

from perfbench.metrics import idle_share


def read(ctx):
    return idle_share(ctx)
