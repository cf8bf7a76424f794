"""``setup_s``: from the start of the run to the start of the window:
starting torch and the card, loading (on a checkout's first run, building)
the program's kernels, making the pool of records from the seed and the
warm-up calls."""


def read(ctx):
    return ctx.setup_s
