"""Numerical Laplace transform on a sigma grid (counterpart of
:mod:`pyfft_tpu.laplace`).

Role of the reference ``laplace.py``: a brute-force bilateral Laplace
transform evaluated as a family of exponentially-weighted Fourier transforms
over a grid of real parts ``sigma`` (reference ``laplace_1d``,
``laplace.py:85-113``).  The sigma axis is a batch dimension: each block of
sigma rows is one ``(block, N)`` weighted ``torch.fft.rfft`` on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import _np, resolve_device

__all__ = ["laplace", "laplace_1d"]


def laplace(uin=None, **kwargs):
    """2-D Laplace transform — reserved (the reference's ``laplace`` is an
    empty stub, ``laplace.py:81``).  Delegates to :func:`laplace_1d`."""
    if uin is None:
        return None
    return laplace_1d(uin, **kwargs)


def laplace_1d(uin, real_sigma_interval=None, nfft=None, sigma_block=None,
               device=None):
    """Bilateral Laplace transform over a grid of real parts.

    Returns a complex NumPy array of shape ``(nsigma, nfft//2 + 1)``: rows
    are the sigma grid, columns the rfft frequency bins — the reference's
    output layout (``laplace.py:104-113``).

    The reference normalizes each exponential weight by its own sum and
    applies it to the time-reversed signal; both conventions are preserved
    (weights ``exp(sigma (N-1-m)) / sum exp(sigma n)`` after unwinding the
    double reversal at ``laplace.py:101`` and ``:109``).

    The sigma rows are transformed in blocks of ``sigma_block`` rows
    (default: the ``(block, N)`` float64 weights under ~256 MB), so the
    reference's 2001-point default grid never builds the whole weight
    matrix.  The exponents stay float64 (their range is ``|sigma| * N``);
    only the bounded weights are cast to the signal's precision.
    """
    dev = resolve_device(device, uin)
    uin = np.atleast_1d(np.asarray(_np(uin)))
    if real_sigma_interval is None:
        real_sigma_interval = np.arange(-1, 1 + 0.001, 0.001)
    sig = np.asarray(real_sigma_interval, dtype=np.float64)
    N = len(uin) if nfft is None else int(nfft)
    x = uin[:N] if len(uin) >= N else np.pad(uin, (0, N - len(uin)))
    # float64 stays float64; narrower signals are transformed in float32
    dt = torch.float64 if x.dtype == np.float64 else torch.float32
    xt = torch.as_tensor(x, device=dev)

    nsigma = sig.size
    if sigma_block is None:
        sigma_block = int(max(1, min(nsigma, (1 << 25) // max(N, 1))))
    n = np.arange(N, dtype=np.float64)
    outs = []
    for i in range(0, nsigma, int(sigma_block)):
        sb = sig[i:i + int(sigma_block)]
        # log-space normalization keeps large |sigma * N| finite
        expo = sb[:, None] * (N - 1 - n)[None, :]
        logz = np.logaddexp.reduce(sb[:, None] * n[None, :], axis=1)
        W = torch.as_tensor(np.exp(expo - logz[:, None]), device=dev)
        outs.append(_np(torch.fft.rfft((W * xt[None, :]).to(dt), dim=-1)))
    return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)


def test_laplace(plotit=False):
    """s-plane scan demo (reference ``test_laplace``, laplace.py:116-201):
    a damped sine scanned over a grid of real parts; the pole row shows the
    sharpest spectral line.  Returns ``(sigma, freq_bins, LP)``."""
    fs, n = 1000.0, 1024
    t = np.arange(n) / fs
    d, f0 = 60.0, 120.0
    x = np.exp(-d * t) * np.sin(2 * np.pi * f0 * t)
    sigma = np.arange(-0.2, 0.2, 0.005)
    LP = laplace_1d(x, real_sigma_interval=sigma)
    freq = fs * np.arange(LP.shape[1]) / n
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure("test_laplace")
        plt.pcolormesh(freq, sigma, np.log10(np.abs(LP) + 1e-12),
                       shading="auto")
        plt.xlabel("freq [Hz]")
        plt.ylabel("sigma")
    return sigma, freq, LP
