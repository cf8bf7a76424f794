"""``device_idle_share``: the share (%) of the traced stretch's wall in
which no kernel, copy or memset ran on the device."""


def read(ctx):
    tr = ctx.trace
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
