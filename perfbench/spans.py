"""The program's span log, as the per-layer metrics of its stages read it.

While a profiler records, the port logs a span for each stage of a
``retrieve`` call (``hipporag_tpu_torch.utils.timing.spans``), so in a
traced run the newest ``retrieve`` call in the log is the profiled one.
A run without a trace, or a program without the log, gives nothing.
"""

from __future__ import annotations

ROOT_SPAN = "retrieve"
PPR_SPAN = "retrieve/ppr"


def profiled_call(ctx):
    """The spans of the newest ``retrieve`` call in the program's log, or
    ``None``."""
    if ctx.trace is None:
        return None
    try:
        from hipporag_tpu_torch.utils.timing import spans
    except ImportError:
        return None
    log = spans()
    roots = [s for s in log if s.name == ROOT_SPAN and s.parent_id is None]
    if not roots:
        return None
    call = roots[-1].call_id
    return [s for s in log if s.call_id == call]


def mean_ms(ctx, name: str):
    """Mean duration of the profiled call's ``name`` spans (one per
    bucket), ms."""
    durations = [s.end_ns - s.start_ns for s in profiled_call(ctx) or () if s.name == name]
    return 1e-6 * sum(durations) / len(durations) if durations else None


def ppr_totals(ctx):
    """(tiles, iterations, ms) summed over the profiled call's PageRank
    solves, or ``None`` when it solved none."""
    ppr = [s for s in profiled_call(ctx) or () if s.name == PPR_SPAN]
    tiles = sum(s.attrs.get("tiles", 0) for s in ppr)
    iterations = sum(s.attrs.get("iterations", 0) for s in ppr)
    if not tiles or not iterations:
        return None
    return tiles, iterations, 1e-6 * sum(s.end_ns - s.start_ns for s in ppr)
