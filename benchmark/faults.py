"""Faults planted under the timed path, for the tests that see the output
check come out false and for the readings that set the limits: each wraps
a program's ``call(state, record)``.  The cells here have no state carried
from call to call and no exchange between cards, so the faults are an
answer that is stale (the previous call's, as a step that returns its
state unchanged would give), half the batch left out with the mean taken
over the rest, and one answer altered where it is produced."""
from __future__ import annotations

import numpy as np


def stale(call):
    """Every call after the first returns the previous call's outputs."""
    last = []

    def wrapped(state, record):
        out = call(state, record)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return wrapped


def half_batch(program):
    """The program averages half its segments (``program.half_batch``)."""
    def wrap(call):
        return lambda state, record: call(program.half_batch(state), record)
    return wrap


ALTERED_BY = 1e-3


def altered(call):
    """The largest value of the first output is off by
    :data:`ALTERED_BY`."""
    def wrapped(state, record):
        out = dict(call(state, record))
        k = next(iter(out))
        a = np.array(out[k], copy=True)
        i = np.unravel_index(np.argmax(np.abs(a)), a.shape)
        a[i] = a[i] * (1 + ALTERED_BY)
        out[k] = a
        return out
    return wrapped
