"""Host duration of the retrieve/embed span of the profiled call, ms: every
question encoded under both instructions by GritLM-8x7B."""

from perfbench.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "retrieve/embed")
