"""Small numeric utilities replacing the reference's private ``pybaseutils``
(counterpart of :mod:`pyfft_tpu.utils.interp`).

The reference package imports ``interp``, ``trapz_var``, ``sliding_window_1d``
and ``reshapech`` from a private helper package (reference
``fft_analysis.py:22-24``, ``filters.py:13``, ``ccf.py:15``).  They are
re-created from their call-site semantics as host NumPy functions: each is
O(n) glue around the spectral pipelines, and nothing in the port traces
through them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["interp", "trapz_var", "sliding_window_1d", "reshapech", "rect",
           "delta"]


def interp(xi, yi, ei=None, xo=None):
    """Linear interpolation with optional uncertainty propagation.

    Parameters mirror the reference call sites (e.g. ``filters.py:29``:
    ``_ut.interp(tt, u_t, ei=None, xo=ti)``).

    - ``xi, yi``: sample grid and values (interpolation along axis 0 of yi).
    - ``ei``: optional 1-sigma uncertainty on ``yi``; if given, the linearly
      propagated uncertainty is returned as a second output.
    - ``xo``: query points.

    Points outside the grid extrapolate linearly from the end intervals.
    """
    xi = np.asarray(xi)
    yi = np.asarray(yi)
    if xo is None:
        xo = xi
    xo = np.asarray(xo)

    idx = np.clip(np.searchsorted(xi, xo, side="right") - 1, 0,
                  xi.shape[0] - 2)
    x0 = xi[idx]
    x1 = xi[idx + 1]
    frac = (xo - x0) / (x1 - x0)

    def _lin(y):
        y0 = np.take(y, idx, axis=0)
        y1 = np.take(y, idx + 1, axis=0)
        f = frac.reshape(frac.shape + (1,) * (y.ndim - 1))
        return y0 + f * (y1 - y0)

    yo = _lin(yi)
    if ei is None:
        return yo
    ei = np.asarray(ei)
    e0 = np.take(ei, idx, axis=0)
    e1 = np.take(ei, idx + 1, axis=0)
    f = frac.reshape(frac.shape + (1,) * (ei.ndim - 1))
    eo = np.sqrt(((1 - f) * e0) ** 2 + (f * e1) ** 2)
    return yo, eo


def trapz_var(x, y, ey=None, vary=None, dim=0):
    """Trapezoidal integration with variance propagation.

    Matches the reference call convention (``fft_analysis.py:891-902``):
    ``[I, varI, _, _] = trapz_var(x, y, None, vary, dim=0)``.

    The trapezoid rule is a linear functional ``I = sum_i w_i y_i`` with
    ``w_i = (dx_{i-1} + dx_i)/2`` (half-weights at the ends), so the variance
    propagates as ``varI = sum_i w_i^2 var_i``.
    """
    x = np.asarray(x)
    y = np.moveaxis(np.asarray(y), dim, 0)
    n = y.shape[0]
    dx = np.diff(x)
    w = 0.5 * np.concatenate([dx[:1], dx[1:] + dx[:-1], dx[-1:]])
    wb = w.reshape((n,) + (1,) * (y.ndim - 1))
    integral = np.sum(wb * y, axis=0)
    if vary is None:
        var = np.zeros_like(integral)
    else:
        vary = np.moveaxis(np.asarray(vary), dim, 0)
        var = np.sum((wb ** 2) * vary, axis=0)
    return integral, var, None, None


def sliding_window_1d(t, x, win, ss=None, ind_only=False):
    """Split a 1-D series into (overlapping) windows.

    Reference call sites: ``Doppler.py:69`` (``ind_only=1`` returning start/stop
    index pairs) and ``Doppler.py:84`` / ``ccf.py:92-93`` returning
    ``(t_windows, x_windows, t_centers)`` with ``x_windows`` of shape
    ``(nwindows, win)``.

    ``ss`` is the window step (defaults to ``win`` -> non-overlapping).
    """
    t = np.asarray(t)
    x = np.asarray(x)
    if ss is None or ss == 0:
        ss = win
    ss = int(ss)
    win = int(win)
    n = x.shape[0]
    nwin = 1 + (n - win) // ss if n >= win else 0
    starts = np.arange(nwin) * ss
    if ind_only:
        return np.stack([starts, starts + win], axis=-1)
    idx = starts[:, None] + np.arange(win)[None, :]
    xw = x[idx]
    tw = t[idx]
    tc = np.mean(tw, axis=-1)
    return tw, xw, tc


def reshapech(x):
    """Reshape a spectrum (or stack of spectra) to ``(nfreq, nch)``.

    Mirrors the reference helper used by ``integratespectra``
    (``fft_analysis.py:883-888``): 1-D inputs become a single column.
    Shape-only: an array is never converted or copied.
    """
    if not hasattr(x, "ndim"):
        x = np.asarray(x)
    if x.ndim == 1:
        return x[:, None]
    if x.shape[0] == 1:
        return x.T
    return x


def rect(x):
    """Unit rectangle function (reference ``fft_deriv`` test oracle)."""
    ax = np.abs(np.asarray(x))
    return np.where(ax < 0.5, 1.0, np.where(ax == 0.5, 0.5, 0.0))


def delta(x):
    """Discrete impulse: 1 where ``x == 0`` (reference test oracle)."""
    return np.where(np.asarray(x) == 0.0, 1.0, 0.0)
