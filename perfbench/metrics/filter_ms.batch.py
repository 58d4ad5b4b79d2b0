"""Mean host duration of the retrieve/filter span per bucket in the profiled call, ms."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "retrieve/filter")
