"""Mean host duration of the retrieve/graph_search range per bucket in the profiled calls, ms."""

from perfbench.metrics import graph_search_ms


def read(ctx):
    return graph_search_ms(ctx)
