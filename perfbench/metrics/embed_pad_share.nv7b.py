"""Share of the positions the question encoder computed in the profiled call
that were padding: 100 * (padded_tokens - tokens) / padded_tokens, from the
counters the model adds to its retrieve/embed span, %."""

from perfbench.spans import profiled_call


def read(ctx):
    embed = [s for s in profiled_call(ctx) or () if s.name == "retrieve/embed"]
    padded = sum(s.attrs.get("padded_tokens", 0) for s in embed)
    tokens = sum(s.attrs.get("tokens", 0) for s in embed)
    return 100.0 * (padded - tokens) / padded if padded else None
