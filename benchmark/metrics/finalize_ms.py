"""``finalize_ms``: the self time of the program's
``welch_filtered_cross_spectra.finalize`` range (its length less what its
``copy.d2h`` ranges cover: the one-sided scale, the ``Pxy`` assembly and
``freq`` on the host), the mean a call.  None where no call holds the
range."""
from benchmark.tracing import covered, union


def read(ctx):
    tr = ctx.trace
    self_us = []
    for lo, hi in tr.calls:
        for s, e in tr.spans_in("welch_filtered_cross_spectra.finalize",
                                lo, hi):
            copies = union(tr.spans_in("copy.d2h", s, e))
            self_us.append((e - s) - covered(copies, s, e))
    return sum(self_us) / tr.ncalls / 1e3 if self_us else None
