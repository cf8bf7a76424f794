"""``call_ms_p95``: the 95th percentile of every call's wall time in the
window (host clock, the call's results as NumPy arrays on the host)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.calls_s) * 1e3, 95))
