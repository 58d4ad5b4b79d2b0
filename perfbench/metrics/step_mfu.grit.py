"""Least time of all the work of the window's calls, the question encoder's included, over the window's wall time, %."""

from perfbench.metrics import step_mfu


def read(ctx):
    return step_mfu(ctx)
