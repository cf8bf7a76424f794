"""Spectral differentiation (fft_deriv) with modified wavenumbers
(counterpart of :mod:`pyfft_tpu.deriv`).

Role of the reference's ``fft_deriv`` family (``fft_analysis.py:1419-1588``):
derivative via ``ifft(wavenumber * fft(f))`` with the Sunaina et al. (2018)
modified wavenumber ``j sin(k dx)/dx`` to suppress ringing, optional
pre-filter/downsample, optional window, and one-sided-difference endpoint
repair.  The transform runs on ``device`` with ``torch.fft`` in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from .filters import downsample_efficient
from .config import _np, resolve_device
from .utils.detrend import detrend_none

__all__ = ["rescale", "unscale", "fft_deriv"]


def rescale(xx, yy, scaley=True, scalex=True):
    """Normalize (x, y) to unit-ish ranges (reference ``rescale``, :1419)."""
    slope, offset = 1.0, 0.0
    xslope, xoffset = 1.0, 0.0
    xx = np.asarray(xx, dtype=float)
    yy = np.asarray(yy, dtype=float)
    if scaley:
        slope = np.nanmax(yy) - np.nanmin(yy)
        offset = np.nanmin(yy)
        if slope == 0:
            slope = 1.0
        yy = (yy.copy() - offset) / slope
    if scalex:
        xslope = np.nanmax(xx) - np.nanmin(xx)
        xoffset = -1e-4
        if xslope == 0:
            xslope = 1.0
        xx = (xx.copy() - xoffset) / xslope
    return xx, yy, (slope, offset, xslope, xoffset)


def unscale(xx, yy, scl, dydx=None):
    """Invert :func:`rescale` (reference ``unscale``, :1440)."""
    slope, offset, xslope, xoffset = scl
    xx = np.asarray(xx) * xslope + xoffset
    yy = slope * np.asarray(yy) + offset
    if dydx is not None:
        dydx = np.asarray(dydx) * slope / xslope
        return xx, yy, dydx
    return xx, yy


def fft_deriv(sig, xx=None, lowpass=True, Fs_new=None, modified=True,
              detrend=detrend_none, window=None, device=None):
    """Differentiate a sampled signal spectrally.

    Behavior-parity with reference ``fft_deriv`` (``fft_analysis.py:1453``):

    - optional low-pass + resample before the transform (``lowpass`` True
      defaults to the Nyquist frequency, which leaves the signal unchanged);
    - ``modified=True`` uses the ringing-suppressing wavenumber
      ``j sin(k dx)/dx``;
    - optional window applied before the FFT and divided back out after;
    - endpoints replaced by one-sided finite differences (``:1550-1559``).

    ``detrend`` takes and returns a tensor (:mod:`pyfft_tpu_torch.utils.
    detrend`).  Returns ``(dsdx, xx)`` as NumPy arrays.
    """
    dev = resolve_device(device, sig)
    sig = np.asarray(_np(sig), dtype=float)
    if xx is None:
        xx = 1.0 * np.arange(len(sig))
    xx = np.asarray(xx, dtype=float)

    if lowpass:
        dxo = xx[1] - xx[0]
        if lowpass is True:
            lowpass = 0.5 * 1.0 / dxo
        Fs = 1.0 / dxo
        if Fs_new is None:
            Fs_new = min(5.0 * lowpass, Fs)
        if Fs_new < Fs:
            sig = np.asarray(downsample_efficient(
                sig, Fs=Fs, Fs_new=Fs_new, plotit=False, halforder=2,
                lowpass=lowpass, device=dev)).flatten()
            xx = xx[0] + np.arange(0, len(xx) / Fs, 1.0 / Fs_new)
            Fs = Fs_new

    xx, sig, scl = rescale(xx, sig, scaley=True, scalex=True)
    sig = _np(detrend(torch.as_tensor(sig, device=dev)))

    N = len(xx)
    nfft = N
    dx = xx[1] - xx[0]
    L = N * dx

    k = np.fft.fftfreq(nfft, d=dx / L) * 2.0 * np.pi
    if modified:
        wv = np.sin(k * dx) / dx        # Sunaina et al. 2018 Eur.J.Phys. 39
    else:
        wv = k
    wv = wv / L

    if window is None:
        win = np.ones_like(sig)
    else:
        win = np.asarray(window(nfft))
    sig = win * sig

    ds0 = (sig[1] - sig[0]) / (xx[1] - xx[0])
    ds1 = (sig[-1] - sig[-2]) / (xx[-1] - xx[-2])

    F = torch.fft.fft(torch.as_tensor(sig, device=dev), n=nfft)
    jw = torch.as_tensor(1j * wv, device=dev)
    sig = _np(torch.fft.ifft(jw * F, n=nfft).real).astype(float)

    sig = sig / win
    sig[0] = ds0
    sig[-1] = ds1

    xx, _, sig = unscale(xx, sig.copy(), scl=scl, dydx=sig)
    return sig, xx
