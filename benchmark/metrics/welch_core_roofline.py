"""``welch_core_roofline``: the least time of the FIR + Welch work of a call
(``work_counts``' ``welch_core``, against the published float32 and HBM
peaks) as a share (%) of the device time of every kernel the call
launched."""
from benchmark.tracing import roofline_share


def read(ctx):
    return roofline_share(ctx, "welch_core", "welch_core_roofline")
