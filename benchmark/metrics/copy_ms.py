"""``copy_ms``: device time of the host <-> device copies (the trace's
memcpy events) a call, over the traced calls."""


def read(ctx):
    tr = ctx.trace
    if not tr.device_count(("memcpy",)):
        return None
    return tr.device_us(("memcpy",)) / tr.ncalls / 1e3
