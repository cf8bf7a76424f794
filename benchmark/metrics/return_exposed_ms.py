"""``return_exposed_ms``: the time inside the program's ``copy.d2h``
ranges in which the device ran nothing, the mean a call: what the
synchronous copies back add beyond the wait for the kernel.  None where
the calls hold no ``welch_filtered_cross_spectra`` range."""


def read(ctx):
    tr = ctx.trace
    if not any(tr.spans_in("welch_filtered_cross_spectra", lo, hi)
               for lo, hi in tr.calls):
        return None
    idle = sum((e - s) - tr.busy_us(s, e) for lo, hi in tr.calls
               for s, e in tr.spans_in("copy.d2h", lo, hi))
    return idle / tr.ncalls / 1e3
