"""Mean host duration of the retrieve/build_result span per bucket in the profiled call, ms."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "retrieve/build_result")
