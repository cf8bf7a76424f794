"""``enqueue_ms``: host time from the start of the program's
``welch_filtered_cross_spectra`` range to the end of its
``welch_cuda.launch`` range (kernel B enqueued), the mean over the traced
calls that hold both: how long kernel B waits for the host."""


def read(ctx):
    tr = ctx.trace
    times = []
    for lo, hi in tr.calls:
        outer = tr.spans_in("welch_filtered_cross_spectra", lo, hi)
        launch = tr.spans_in("welch_cuda.launch", lo, hi)
        if outer and launch:
            times.append(max(e for _, e in launch) - min(s for s, _ in outer))
    return sum(times) / len(times) / 1e3 if times else None
