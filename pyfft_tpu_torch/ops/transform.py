"""Host-convenience transforms, NumPy in and NumPy out (counterpart of
:mod:`pyfft_tpu.ops.transform`).

Small analysis modules need plain FFTs that run on whatever device is
present.  These run ``torch.fft`` on the port's device rule
(:func:`pyfft_tpu_torch.config.resolve_device`: ``device``, else the
tensor's device, else the package default, else the card) in the input's
precision
and return NumPy arrays.  The JAX package's real-pair matmul branch exists because its TPU
backend has no complex dtype; it has no counterpart here.  Heavy
pipelines (Welch, STFT, FIR) have their own paths and do not go through
here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import _np, _tensor, resolve_device

__all__ = ["fft", "ifft", "rfft", "irfft"]


def _run(op, x, n, axis, device):
    t = _tensor(x, resolve_device(device, x))
    if t.numel() == 0:      # torch's FFT backends refuse empty batches
        return getattr(np.fft, op.__name__.split("_")[-1])(_np(t), n=n,
                                                           axis=axis)
    return _np(op(t, n=n, dim=axis))


def fft(x, n=None, axis=-1, device=None):
    """Forward DFT; NumPy complex out."""
    return _run(torch.fft.fft, x, n, axis, device)


def ifft(x, n=None, axis=-1, device=None):
    """Inverse DFT (1/N-normalized); NumPy complex out."""
    return _run(torch.fft.ifft, x, n, axis, device)


def rfft(x, n=None, axis=-1, device=None):
    """Real-input DFT; NumPy complex out."""
    return _run(torch.fft.rfft, x, n, axis, device)


def irfft(x, n, axis=-1, device=None):
    """Inverse real DFT; NumPy real out."""
    return _run(torch.fft.irfft, x, n, axis, device)
