"""How unevenly the profiled call's routing loaded the experts: the largest
expert's rows, summed over layers and forwards, times the number of experts,
over the (token, expert) pairs routed, from the counters the model adds to
its retrieve/embed spans. 1.0 is even; the grouped products wait on the
largest expert."""

from perfbench.spans import profiled_call


def read(ctx):
    embed = [s for s in profiled_call(ctx) or () if s.name == "retrieve/embed"]
    routed = sum(s.attrs.get("routed", 0) for s in embed)
    rows_max = sum(s.attrs.get("expert_rows_max", 0) for s in embed)
    if not routed or not rows_max:
        return None
    from perfbench.encoders import gritlm

    return rows_max * int(gritlm.cell_config()["num_local_experts"]) / routed
