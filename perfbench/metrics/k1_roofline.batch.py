"""Pass A of the fused top-k (kernel scan_kernel): least time of the profiled buckets over the kernel's device time, %."""

from perfbench.metrics import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
