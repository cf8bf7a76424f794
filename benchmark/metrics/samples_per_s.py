"""``samples_per_s``: the input samples (every channel and the reference)
of all calls completed in the window, over the window's seconds."""


def read(ctx):
    return len(ctx.calls_s) * ctx.samples_per_call / ctx.window_s
