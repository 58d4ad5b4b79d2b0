"""Per-layer metric readers, one file per metric, named as the metric is in
``BENCHMARK.json``. Each defines ``read(ctx)``, which returns the metric's
value or ``None`` when the run holds nothing to read it from; the harness
then leaves the metric out. ``ctx`` has ``counters`` (the driver's window
counters), ``trace`` (the reduced profiler window, or ``None``),
``window_s``, and ``stages`` / ``traced_stages``: per engine call of the
window (of the profiled calls), the least device seconds of each stage.

The helpers below are shared by readers of one quantity on several cells.
"""

from __future__ import annotations

from ..work import GRAPH_SEARCH_STAGES, STEP_STAGES

K1_KERNEL = "scan_kernel"


def stage_sum(per_call, stages) -> float:
    return sum(st.get(name, 0.0) for st in per_call for name in stages)


def idle_share(ctx):
    t = ctx.trace
    if not t or not t["window_s"] or not t["busy_s"]:
        return None  # no device operation in the trace: nothing measured
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def step_mfu(ctx):
    if not ctx.stages or not ctx.window_s:
        return None
    return 100.0 * stage_sum(ctx.stages, STEP_STAGES) / ctx.window_s


def graph_search_ms(ctx):
    ranges = (ctx.trace or {}).get("graph_search_ranges_s")
    return 1e3 * sum(ranges) / len(ranges) if ranges else None


def graph_search_roofline(ctx):
    t = ctx.trace
    if not t or not ctx.traced_stages:
        return None
    device = sum(dur for _name, dur, inside in t["kernels"] if inside)
    least = stage_sum(ctx.traced_stages, GRAPH_SEARCH_STAGES)
    return 100.0 * least / device if device > 0 and least > 0 else None


def k1_roofline(ctx):
    t = ctx.trace
    if not t or not ctx.traced_stages:
        return None
    device = sum(dur for name, dur, _inside in t["kernels"] if K1_KERNEL in name)
    least = stage_sum(ctx.traced_stages, ("k1_pass_a",))
    return 100.0 * least / device if device > 0 and least > 0 else None

