"""Thomson multitaper spectral estimation (DPSS).

Counterpart of :mod:`pyfft_tpu.multitaper`.  The ``K`` tapers are a batch
axis: the tapered signals go through one batched ``torch.fft.rfft`` on the
compute device, and the eigenvalue-weighted average runs on the host in
float64 NumPy, as in the JAX package.

- :func:`multitaper_psd`: auto-PSD with 'unity', 'eigen', or Thomson
  'adaptive' taper weighting (Percival & Walden eq. 368-370 iteration);
- :func:`multitaper_csd`: cross-spectrum, coherence and phase between two
  signals with eigen-weighted taper averaging.

Density normalization matches ``fft_pwelch`` (V^2/Hz: one-sided doubling of
interior bins, 1/fs scaling).  ``fft_backend`` is accepted for the JAX
signature: every value takes ``torch.fft`` (the JAX package has no Pallas
kernel here: it sends 'pallas' to 'mxu').
Device (:func:`~pyfft_tpu_torch.config.resolve_device`): ``device=``, else
the first tensor argument's, else the package default, else the card.
NumPy input computes in float64; a tensor keeps its floating dtype.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .config import resolve_device
from .windows import dpss
from .segmentation import get_nnyquist
from .spectral import _onesided_power_scale

__all__ = ["multitaper_psd", "multitaper_csd"]


def _signal(x, device):
    """``x`` as a 1-D real tensor on ``device``: NumPy as float64, tensors
    in their floating dtype."""
    if isinstance(x, torch.Tensor):
        x = x.to(device)
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _eigencoefficients(x, tapers, nnyquist):
    """(K, nfreq) complex eigencoefficients of ``x`` under each taper."""
    t = torch.tensor(tapers, dtype=x.dtype, device=x.device)
    return torch.fft.rfft(t * x[None, :], dim=-1)[..., :nnyquist]


@lru_cache(maxsize=4)
def _eigvals_tapers(n, NW, K):
    """DPSS tapers (K, n) and their concentrations, read-only (cached: the
    tridiagonal eigenproblem costs seconds at n = 2**20)."""
    tapers, ratios = dpss(n, NW, Kmax=K, sym=False, return_ratios=True)
    tapers, ratios = np.atleast_2d(tapers), np.atleast_1d(ratios)
    tapers.setflags(write=False)
    ratios.setflags(write=False)
    return tapers, ratios


def multitaper_psd(x, fs=1.0, NW=4.0, K=None, weighting="adaptive",
                   fft_backend=None, adaptive_iters=5, device=None):
    """Multitaper PSD of a real signal ``x``.

    ``K`` defaults to ``2*NW - 1`` tapers.  Returns ``(freq, Pxx)`` (NumPy
    float64) with Pxx in V^2/Hz (one-sided).  ``weighting``:

    - 'unity': plain average of the K eigenspectra;
    - 'eigen': eigenvalue-weighted average;
    - 'adaptive': Thomson's iterative weights  d_k(f) = sqrt(lam_k) S(f) /
      (lam_k S(f) + (1-lam_k) sigma^2), which suppress broadband leakage
      bin-by-bin.
    """
    xt = _signal(x, resolve_device(device, x)).reshape(-1)
    n = xt.shape[0]
    if K is None:
        K = max(2, int(2 * NW - 1))
    tapers, lam = _eigvals_tapers(n, NW, K)
    nny = get_nnyquist(n)

    X = _eigencoefficients(xt, tapers, nny)
    Sk = (X.real ** 2 + X.imag ** 2).double().cpu().numpy()  # (K, nfreq)
    scale = _onesided_power_scale(n, nny) / fs

    if weighting == "unity":
        S = Sk.mean(axis=0)
    elif weighting == "eigen":
        S = (lam[:, None] * Sk).sum(axis=0) / lam.sum()
    elif weighting == "adaptive":
        sig2 = float(xt.double().var(unbiased=False))
        S = Sk[:2].mean(axis=0)                          # pilot estimate
        for _ in range(adaptive_iters):
            d = (np.sqrt(lam)[:, None] * S[None, :]
                 / (lam[:, None] * S[None, :]
                    + (1.0 - lam)[:, None] * sig2 + 1e-300))
            w = d ** 2
            S = (w * Sk).sum(axis=0) / w.sum(axis=0)
    else:
        raise ValueError(f"weighting {weighting!r} not in "
                         "('unity', 'eigen', 'adaptive')")

    freq = fs * np.arange(nny) / n
    return freq, S * scale


def multitaper_csd(x, y, fs=1.0, NW=4.0, K=None, fft_backend=None,
                   device=None):
    """Multitaper cross-spectrum of two real signals.

    Returns ``(freq, Pxy, Pxx, Pyy, Cxy2, phi)`` (NumPy) — eigen-weighted
    taper averages; coherence here is meaningful *without* segment
    averaging because the K tapers supply independent estimates.
    """
    dev = resolve_device(device, x, y)
    xt = _signal(x, dev).reshape(-1)
    yt = _signal(y, dev).reshape(-1)
    if xt.shape != yt.shape:
        raise ValueError("x and y must have equal length")
    n = xt.shape[0]
    if K is None:
        K = max(2, int(2 * NW - 1))
    tapers, lam = _eigvals_tapers(n, NW, K)
    nny = get_nnyquist(n)

    X = _eigencoefficients(xt, tapers, nny).to(torch.complex128).cpu().numpy()
    Y = _eigencoefficients(yt, tapers, nny).to(torch.complex128).cpu().numpy()
    Xr, Xi, Yr, Yi = X.real, X.imag, Y.real, Y.imag
    w = (lam / lam.sum())[:, None]
    Pxx = (w * (Xr ** 2 + Xi ** 2)).sum(axis=0)
    Pyy = (w * (Yr ** 2 + Yi ** 2)).sum(axis=0)
    Pxy = ((w * (Yr * Xr + Yi * Xi)).sum(axis=0)
           + 1j * (w * (Yi * Xr - Yr * Xi)).sum(axis=0))

    scale = _onesided_power_scale(n, nny) / fs
    freq = fs * np.arange(nny) / n
    with np.errstate(divide="ignore", invalid="ignore"):
        Cxy2 = np.abs(Pxy) ** 2 / (Pxx * Pyy)
    phi = np.arctan2(Pxy.imag, Pxy.real)
    return freq, Pxy * scale, Pxx * scale, Pyy * scale, Cxy2, phi
