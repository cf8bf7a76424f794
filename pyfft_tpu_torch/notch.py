"""Second-order IIR notch / peak filter design (Orfanidis); counterpart of
:mod:`pyfft_tpu.notch`.

Role of the reference ``notch_filter.py`` (``iirnotch`` :19, ``iirpeak`` :97,
``_design_notch_peak_filter`` :175-241): the textbook second-order designs
from S. J. Orfanidis, *Introduction to Signal Processing*, Prentice-Hall,
1996 — formulas 11.3.4/11.3.7 (notch) and 11.3.19/11.3.21 (peak).

Design is host-side NumPy (copied); application goes through the port's
blocked IIR filter (:func:`pyfft_tpu_torch.filters.filtfilt` /
``lfilter``) on ``device``, or the FIR overlap-save path via
:func:`pyfft_tpu_torch.filters.iir_to_fir`.
"""
from __future__ import annotations

import numpy as np

from .filters import filtfilt, lfilter

__all__ = ["iirnotch", "iirpeak", "notch_filter", "peak_filter"]


def _design_notch_peak(w0, Q, ftype):
    w0 = float(w0)
    Q = float(Q)
    if w0 > 1.0 or w0 < 0.0:
        raise ValueError("w0 should be such that 0 < w0 < 1")

    bw = (w0 / Q) * np.pi
    w0 = w0 * np.pi
    gb = 1.0 / np.sqrt(2.0)                    # -3 dB point

    if ftype == "notch":
        beta = (np.sqrt(1.0 - gb ** 2.0) / gb) * np.tan(bw / 2.0)
    elif ftype == "peak":
        beta = (gb / np.sqrt(1.0 - gb ** 2.0)) * np.tan(bw / 2.0)
    else:
        raise ValueError("Unknown ftype.")

    gain = 1.0 / (1.0 + beta)

    if ftype == "notch":
        b = gain * np.array([1.0, -2.0 * np.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * np.cos(w0), (2.0 * gain - 1.0)])
    return b, a


# reference-parity alias (reference ``notch_filter.py:175``)
_design_notch_peak_filter = _design_notch_peak


def iirnotch(w0, Q):
    """Second-order notch: rejects a narrow band around ``w0`` (normalized
    to Nyquist).  ``Q = w0 / bw`` at the -3 dB width.  Returns ``(b, a)``."""
    return _design_notch_peak(w0, Q, "notch")


def iirpeak(w0, Q):
    """Second-order peak (resonator): passes only a narrow band around
    ``w0`` (normalized to Nyquist).  Returns ``(b, a)``."""
    return _design_notch_peak(w0, Q, "peak")


def _apply(b, a, x, zero_phase, axis, device):
    if zero_phase:
        return filtfilt(b, a, x, axis=axis, device=device)
    return lfilter(b, a, x, axis=axis, device=device)


def notch_filter(x, w0, Q, zero_phase=True, axis=-1, device=None):
    """Apply a notch at ``w0`` to a signal (zero-phase by default); NumPy
    out."""
    return _apply(*iirnotch(w0, Q), x, zero_phase, axis, device)


def peak_filter(x, w0, Q, zero_phase=True, axis=-1, device=None):
    """Apply a resonator at ``w0`` to a signal (zero-phase by default);
    NumPy out."""
    return _apply(*iirpeak(w0, Q), x, zero_phase, axis, device)
