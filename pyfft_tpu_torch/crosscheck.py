"""mlab-style convenience spectral wrappers (cross-check API); a copy of
:mod:`pyfft_tpu.crosscheck`.

Role of the reference's matplotlib.mlab convenience layer
(``fft_analysis.py:1037-1155``): quick PSD/CSD/coherence estimates with the
mlab conventions (per-segment detrend, Hanning window, density scaling).
Built on the port's independent NumPy oracle (:func:`csd_oracle`) so they
remain a cross-check on the device pipelines.
"""
from __future__ import annotations

import numpy as np

from .spectral import csd_oracle


__all__ = ["fft_pmlab", "coh", "coh2", "psd", "csd", "window_hanning",
           "detrend_str"]


def window_hanning(x):
    """mlab-style window callable (symmetric Hanning weights)."""
    return np.hanning(len(x)) * x


def detrend_str(detrend):
    """Map mlab-style detrend spec (str/callable/None) to a callable."""
    if callable(detrend):
        return detrend
    if detrend in (None, "none", False):
        return lambda d: d
    if detrend == "mean":
        return lambda d: d - np.mean(d)
    if detrend == "linear":
        def _lin(d):
            n = len(d)
            t = np.arange(n) - (n - 1) / 2.0
            slope = np.dot(t, d - d.mean()) / np.dot(t, t)
            return d - d.mean() - slope * t
        return _lin
    raise ValueError(f"unknown detrend {detrend!r}")


def _csd(x, y, nfft, fs, detrend, noverlap, window=None):
    win = np.hanning(nfft) if window is None else window
    return csd_oracle(x, y, nfft, fs=fs, detrend=detrend_str(detrend),
                      window=win, noverlap=int(noverlap), sides="onesided")


def fft_pmlab(sig1, sig2, dt, plotit=False):
    """Auto/cross spectral densities of two signals at full record length
    (reference ``fft_pmlab``, :1037-1057)."""
    sig1 = np.asarray(sig1)
    sig2 = np.asarray(sig2)
    nfft = np.size(sig1)
    ps1, ff = _csd(sig1, sig1, nfft, 1.0 / dt, "mean", 0)
    ps2, _ = _csd(sig2, sig2, nfft, 1.0 / dt, "mean", 0)
    p12, _ = _csd(sig1, sig2, nfft, 1.0 / dt, "mean", 0)
    return ff, ps1.real, ps2.real, p12


def coh(x, y, fs, nfft=2048, fmin=0.0, fmax=500e3, detrend="mean", ov=0.67):
    """RMS coherence below ``fmax`` (reference ``coh``, :1060-1088)."""
    noverlap = int(ov * nfft)
    Pxx, F = _csd(x, x, nfft, fs, detrend, noverlap)
    Pyy, _ = _csd(y, y, nfft, fs, detrend, noverlap)
    Pxy, _ = _csd(x, y, nfft, fs, detrend, noverlap)
    Cxy2 = np.abs(Pxy) ** 2 / (Pxx.real * Pyy.real)
    ind = np.where((F <= fmax) & (F >= fmin))
    return np.sqrt(Cxy2[ind]), F[ind]


def coh2(x, y, fs, nfft=4096, fmin=0, fmax=500e3, detrend="none",
         peak_treshold=None):
    """Mean-squared coherence, cross-phase and auto-power
    (reference ``coh2``, :1090-1110): returns ``{'coh','f','PS','pha'}``."""
    noverlap = nfft // 2
    fxx, f = _csd(x, x, nfft, fs, "none", noverlap)
    fyy, _ = _csd(y, y, nfft, fs, "none", noverlap)
    fxy, _ = _csd(x, y, nfft, fs, "none", noverlap)
    COH = np.abs(fxy * np.conj(fxy)) / (fxx.real * fyy.real)
    PHA = np.arctan2(np.imag(fxy), np.real(fxy))
    PSD = np.abs(fxx)
    ind = np.where(np.abs(f) <= fmax)
    return {"coh": COH[ind], "f": f[ind], "PS": PSD[ind], "pha": PHA[ind]}


def psd(x, fs, nfft=2048, fmin=None, fmax=None, detrend="none",
        peak_threshold=None, ov=0.67):
    """PSD within a frequency range (reference ``psd``, :1113-1131)."""
    P, F = _csd(x, x, nfft, fs, detrend, int(np.floor(ov * nfft)))
    P = P.real
    threshold = np.ones(P.shape, dtype=bool)
    if fmin is not None:
        threshold &= F >= fmin
    if fmax is not None:
        threshold &= F <= fmax
    if peak_threshold is not None:
        threshold &= P > peak_threshold
    ind = np.where(threshold)
    return P[ind], F[ind]


def csd(x, y, fs, nfft=2048, fmin=0, fmax=500e3, detrend="none",
        peak_threshold=None, ov=0.67):
    """CSD within a frequency range (reference ``csd``, :1134-1155)."""
    P, F = _csd(x, y, nfft, fs, detrend, int(np.floor(ov * nfft)))
    threshold = np.ones(P.shape, dtype=bool)
    if fmin is not None:
        threshold &= F >= fmin
    if fmax is not None:
        threshold &= F <= fmax
    if peak_threshold is not None:
        threshold &= np.abs(P) > peak_threshold
    ind = np.where(threshold)
    return P[ind], F[ind]
