"""The question encoder's share of its roofline: the profiled calls' least
``encode`` time (every weight read once a call) over the device time of the
kernels launched inside their retrieve/embed ranges, %."""

from perfbench.metrics import stage_sum


def read(ctx):
    t = ctx.trace
    if not t or not ctx.traced_stages:
        return None
    device = t.get("range_device_s", {}).get("retrieve/embed", 0.0)
    least = stage_sum(ctx.traced_stages, ("encode",))
    return 100.0 * least / device if device > 0 and least > 0 else None
