"""PageRank iterations per column tile in the profiled call: the iterations
the solver counted on its retrieve/ppr spans over the tiles it solved."""

from perfbench.spans import ppr_totals


def read(ctx):
    totals = ppr_totals(ctx)
    return totals[1] / totals[0] if totals else None
