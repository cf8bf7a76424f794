"""Continuous wavelet transform (the reference's missing ``pycwt`` slot).

Counterpart of :mod:`pyfft_tpu.wavelet`.  The CWT at all scales is ONE
batched spectral multiply,

    W[a, n] = ifft( fft(x)[k] * conj(psi_hat(s_a * omega_k)) )[n]

so the scale axis is the batch axis of one ``torch.fft.ifft`` on the
compute device (no per-scale loop); the filter bank is built there too
(its exponential by NumPy for a CPU tensor: :meth:`Morlet.hat`).

API follows the Torrence & Compo conventions (the pycwt lineage):

- :class:`Morlet` (``omega0`` default 6) with ``flambda``/``coi`` factors;
- :func:`cwt(x, dt, dj, s0, J, wavelet)`` ->
  ``(W, scales, freqs, coi)``;
- :func:`icwt` delta-function reconstruction;
- :func:`global_spectrum`: time-averaged |W|^2 (the wavelet analogue of
  the Welch PSD).

Device (:func:`~pyfft_tpu_torch.config.resolve_device`): ``device=``, else
the tensor argument's, else the package default, else the card.  NumPy
input computes in float64; a float32 tensor in float32 (complex64).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import _np, resolve_device

__all__ = ["Morlet", "cwt", "icwt", "global_spectrum"]


class Morlet:
    """Analytic Morlet wavelet (Torrence & Compo table 1)."""

    def __init__(self, omega0=6.0):
        self.omega0 = float(omega0)

    @property
    def flambda(self):
        """Fourier wavelength factor: lambda = flambda * scale."""
        w0 = self.omega0
        return 4.0 * np.pi / (w0 + np.sqrt(2.0 + w0 * w0))

    @property
    def coi_factor(self):
        """e-folding time factor: coi = coi_factor * scale."""
        return np.sqrt(2.0)

    # T&C reconstruction constants for omega0 = 6
    cdelta = 0.776
    psi0 = np.pi ** -0.25

    def hat(self, s_omega):
        """psi_hat(s*omega) on the positive-frequency axis (analytic), for
        NumPy arrays or tensors.

        On a CPU tensor the exponential is NumPy's: torch's float64
        ``torch.exp`` on the CPU has returned values off by up to 3e-9 in
        one thread's share of its first multithreaded call in a process
        (``scripts/torch_exp_first_call.py`` reproduces it), where the bank
        must hold float64 rounding."""
        arg = -0.5 * (s_omega - self.omega0) ** 2
        if not isinstance(s_omega, torch.Tensor):
            e = np.exp(arg)
        elif arg.device.type == "cpu":
            e = torch.from_numpy(np.exp(arg.numpy()))
        else:
            e = torch.exp(arg)
        return (np.pi ** -0.25) * e * (s_omega > 0.0)


def cwt(x, dt=1.0, dj=0.125, s0=None, J=None, wavelet=None, device=None):
    """Continuous wavelet transform of a real signal.

    Scales ``s_j = s0 * 2**(j*dj)``, ``j = 0..J`` (defaults: ``s0 = 2*dt``,
    ``J = log2(N*dt/s0)/dj`` — the full octave range).  Returns
    ``(W (J+1, N) complex, scales, freqs, coi)`` (NumPy; ``W`` complex128)
    where ``coi[n]`` is the e-folding period of edge effects at time index
    ``n``.
    """
    dev = resolve_device(device, x)
    if isinstance(x, torch.Tensor):
        xt = x.to(dev).reshape(-1)
        if not xt.is_floating_point():
            xt = xt.to(torch.float64)
    else:
        xt = torch.as_tensor(np.asarray(x, dtype=np.float64).ravel(),
                             device=dev)
    n = xt.shape[0]
    wavelet = wavelet or Morlet()
    if s0 is None:
        s0 = 2.0 * dt
    if J is None:
        J = int(np.log2(n * dt / s0) / dj)
    scales = s0 * 2.0 ** (dj * np.arange(J + 1))

    # the filter bank, built on the device in float64 and applied in the
    # signal's precision; L2 normalization sqrt(2*pi*s/dt)
    omega = 2.0 * np.pi * torch.fft.fftfreq(n, dt, dtype=torch.float64,
                                            device=dev)
    s = torch.as_tensor(scales, device=dev)
    bank = wavelet.hat(s[:, None] * omega[None, :]) \
        * torch.sqrt(2.0 * np.pi * s / dt)[:, None]

    X = torch.fft.fft(xt - xt.mean())
    W = torch.fft.ifft(X[None, :] * bank.to(xt.dtype), dim=-1)
    W = W.to(torch.complex128).cpu().numpy()

    freqs = 1.0 / (wavelet.flambda * scales)
    t_edge = np.minimum(np.arange(n), np.arange(n)[::-1]) * dt
    coi = wavelet.coi_factor * t_edge / wavelet.flambda  # as frequency^-1
    return W, scales, freqs, coi


def icwt(W, scales, dt=1.0, dj=0.125, wavelet=None):
    """Delta-function reconstruction (T&C eq. 11)."""
    wavelet = wavelet or Morlet()
    fac = (dj * np.sqrt(dt)
           / (wavelet.cdelta * wavelet.psi0))
    return fac * np.sum(np.real(_np(W)) / np.sqrt(_np(scales))[:, None],
                        axis=0)


def global_spectrum(W, scales=None):
    """Time-averaged wavelet power |W|^2 per scale (wavelet PSD analogue)."""
    return np.mean(np.abs(_np(W)) ** 2, axis=-1)
