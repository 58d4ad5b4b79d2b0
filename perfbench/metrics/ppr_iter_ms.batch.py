"""Host time per PageRank iteration in the profiled call: the summed
duration of its retrieve/ppr spans over the iterations counted on them, ms."""

from perfbench.spans import ppr_totals


def read(ctx):
    totals = ppr_totals(ctx)
    return totals[2] / totals[1] if totals else None
