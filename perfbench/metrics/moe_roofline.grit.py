"""The mixture-of-experts layer's share of its roofline: the profiled call's
least time of its MoE layers (``encoders/gritlm.moe_least_s``, from the
(token, expert) pairs routed and the forwards its retrieve/embed spans
count) over the device time of the kernels whose names hold ``moe_``, %."""

from perfbench.spans import profiled_call

KERNELS = "moe_"


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    device = sum(dur for name, dur, _inside in t["kernels"] if KERNELS in name)
    embed = [s for s in profiled_call(ctx) or () if s.name == "retrieve/embed"]
    routed = sum(s.attrs.get("routed", 0) for s in embed)
    forwards = sum(s.attrs.get("forwards", 0) for s in embed)
    if device <= 0 or not routed or not forwards:
        return None
    from perfbench.encoders import gritlm

    return 100.0 * gritlm.moe_least_s(gritlm.cell_config(), routed, forwards) / device
