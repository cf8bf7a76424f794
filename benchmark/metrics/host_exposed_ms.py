"""``host_exposed_ms``: the time of the benchmark's span around a call in
which the device ran nothing, the mean over the traced calls."""


def read(ctx):
    tr = ctx.trace
    idle = [(e - s) - tr.busy_us(s, e) for s, e in tr.calls]
    return sum(idle) / len(idle) / 1e3
