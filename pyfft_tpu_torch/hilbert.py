"""Analytic signal via the Hilbert transform (counterpart of
:mod:`pyfft_tpu.hilbert`).

Role of the reference ``hilbert.py``: zero the negative-frequency half of
the spectrum, double the positive half, inverse-transform (reference
``hilbert.py:22-67`` and the mask variant ``:70-112``).  With ``nyq =
nfft//2`` (even) / ``(nfft+1)//2`` (odd), bins ``1..nyq-1`` are doubled,
bin ``nyq`` is kept at unit gain, bins ``nyq+1..`` are zeroed.

Routes (gates on shapes only):

- :func:`hilbert` / :func:`hilbert_1d`: ``torch.fft`` -> mask -> ``ifft``
  on the input's device, in its precision (the JAX ``_hilbert_xla``).
- :func:`envelope_phase` casts to float32 as the JAX function does.  A
  1-D signal whose length equals ``nfft``, and whose ``nfft`` has a row
  split (:func:`pyfft_tpu_torch.ops.hilbert.row_split`: the power-of-two
  part of ``nfft``, capped at 8192, is at least 16), takes the factored
  chain :func:`_analytic_factored`: outer ``torch.fft`` over the columns of
  ``(n1, M)``, the rows' section in the middle (kernel D on a CUDA tensor,
  its plain version on a CPU tensor), inverse outer ``torch.fft``.  Every
  other input (N-D, ``nfft != nt``, no split) takes ``torch.fft`` on its
  device.

``mesh=`` raises ``NotImplementedError`` until the FFT half of the mesh
tier (``hilbert_sharded``) is ported.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .ops import hilbert as _kd
from .spectral import _device, _np, _tensor

__all__ = ["hilbert", "hilbert_1d", "analytic_mask", "envelope_phase"]


@lru_cache(maxsize=None)
def analytic_mask(nfft: int) -> np.ndarray:
    """The analytic-signal spectral mask (reference ``hilbert.py:105-109``)."""
    nyq = (nfft + 1) // 2 if nfft % 2 else nfft // 2
    h = np.zeros(nfft)
    h[0] = 1.0
    h[1:nyq] = 2.0
    h[nyq] = 1.0
    return h


def _hilbert_torch(u, nfft, axis):
    """``ifft(fft(u, nfft) * mask)`` along ``axis`` on ``u``'s device."""
    if not (u.is_floating_point() or u.is_complex()):
        u = u.to(torch.float64)
    U = torch.fft.fft(u, n=nfft, dim=axis)
    h = torch.as_tensor(analytic_mask(nfft), dtype=U.real.dtype,
                        device=U.device)
    shape = [1] * U.dim()
    shape[axis % U.dim()] = nfft
    return torch.fft.ifft(U * h.reshape(shape), n=nfft, dim=axis)


def hilbert(uin, nfft=None, axes=-1, device=None):
    """Return the analytic signal ``u + j H[u]`` (NumPy complex, squeezed).

    API-parity with reference ``hilbert.hilbert`` (``hilbert.py:22``);
    batched over any leading axes, transform along ``axes``.  Real and
    complex inputs take the same mask.
    """
    u = _tensor(uin if isinstance(uin, torch.Tensor)
                else np.atleast_1d(np.asarray(uin)), _device(device, uin))
    if u.dim() == 0:
        u = u[None]
    if nfft is None:
        nfft = u.shape[axes]
    return _np(_hilbert_torch(u, int(nfft), axes)).squeeze()


def hilbert_1d(uin, nfft=None, device=None):
    """Mask-vector variant (reference ``hilbert.py:70-112``) — same result."""
    uin = uin if isinstance(uin, torch.Tensor) else np.atleast_1d(
        np.asarray(uin))
    if nfft is None:
        nfft = len(uin)
    return hilbert(uin, nfft=nfft, axes=-1, device=device)


def _analytic_factored(x, split=None, rows=_kd.hilbert_rows):
    """Analytic signal of a real 1-D ``x`` (length ``n1 * M``) through the
    factored chain: outer DFT over the columns of ``x.view(n1, M)``, the
    rows' section ``rows`` (kernel D on the card, its plain version on the
    CPU), inverse outer DFT.  Complex, natural time order."""
    N = x.shape[-1]
    n1, M = _kd.row_split(N) if split is None else split
    if n1 * M != N:
        raise ValueError(f"split {n1} x {M} does not cover {N} samples")
    A = torch.fft.fft(x.reshape(n1, M), dim=0)
    return torch.fft.ifft(rows(A.contiguous()), dim=0).reshape(N)


def _factored_applies(u, nfft, axis):
    return (u.dim() == 1 and axis in (-1, 0) and u.shape[-1] == nfft
            and _kd.row_split(nfft) is not None)


def _envelope_phase_dev(u, nfft, axis=-1):
    """(envelope, phase) tensors of ``u`` on its device (module docstring
    for the routes)."""
    if _factored_applies(u, nfft, axis):
        z = _analytic_factored(u)
    else:
        z = _hilbert_torch(u, nfft, axis)
    return z.abs(), z.angle()


def envelope_phase(uin, nfft=None, axes=-1, mesh=None, device=None):
    """AM/PM demodulation via the analytic signal, reduced on the device.

    Returns ``(envelope, phase)`` as real NumPy arrays (float32): the
    quantities the reference's demod chains consume (``Doppler.py:214-225``
    I/Q magnitude, the instantaneous amplitude and phase), without the
    complex analytic signal crossing to the host.
    """
    if mesh is not None:
        raise NotImplementedError(
            "envelope_phase(mesh=...) needs hilbert_sharded, the FFT half "
            "of the mesh tier (ROADMAP Queue 1 item 4b), which is not "
            "ported yet")
    dev = _device(device, uin)
    u = (uin.to(device=dev, dtype=torch.float32)
         if isinstance(uin, torch.Tensor)
         else torch.as_tensor(np.asarray(uin, dtype=np.float32), device=dev))
    if u.dim() == 0:
        u = u[None]
    if nfft is None:
        nfft = u.shape[axes]
    env, ph = _envelope_phase_dev(u, int(nfft), axes)
    return _np(env).squeeze(), _np(ph).squeeze()


def test_hilbert(plotit=False):
    """The reference's strongest oracle (hilbert.py:115-179): the analytic
    signal of sin must have imaginary part -cos (and agree with the
    scipy.fftpack.hilbert convention).  Raises on disagreement; returns
    the analytic signal."""
    t = np.linspace(0, 2 * np.pi, 1024, endpoint=False)
    x = np.sin(t)
    z = np.asarray(hilbert(x))
    want_imag = -np.cos(t)
    if not np.allclose(np.imag(z), want_imag, atol=1e-6):
        raise AssertionError("hilbert(sin) imaginary part != -cos")
    try:
        from scipy.fftpack import hilbert as sp_hilbert
        if not np.allclose(-sp_hilbert(x), np.imag(z), atol=1e-6):
            raise AssertionError("disagrees with scipy.fftpack.hilbert")
    except ImportError:  # pragma: no cover
        pass
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure("test_hilbert")
        plt.plot(t, x, t, np.imag(z), t, np.abs(z))
        plt.legend(["sin", "H(sin)", "envelope"])
    return z
