"""``device_ops_per_call``: the kernels, copies and memsets the device ran
in the traced stretch, over the calls."""


def read(ctx):
    tr = ctx.trace
    n = tr.device_count()
    return n / tr.ncalls if n else None
