"""``host_syncs_per_call``: the program's ``copy.d2h`` ranges (one copy of
a device tensor to the host, which waits for the work that writes it)
inside the calls, over the calls.  None where the calls hold no
``welch_filtered_cross_spectra`` range (a program without the ranges)."""


def read(ctx):
    tr = ctx.trace
    if not any(tr.spans_in("welch_filtered_cross_spectra", lo, hi)
               for lo, hi in tr.calls):
        return None
    n = sum(len(tr.spans_in("copy.d2h", lo, hi)) for lo, hi in tr.calls)
    return n / tr.ncalls
