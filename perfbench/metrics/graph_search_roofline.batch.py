"""Seeds, PageRank, passage scores and document top-k: least time over the device time of the kernels launched inside retrieve/graph_search, %."""

from perfbench.metrics import graph_search_roofline


def read(ctx):
    return graph_search_roofline(ctx)
