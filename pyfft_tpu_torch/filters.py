"""FIR design and causal FIR filtering on tensors.

Counterpart of the FIR part of :mod:`pyfft_tpu.filters`:

- :func:`firwin` — windowed-sinc design, host NumPy (copied);
- :func:`oaconvolve` — overlap-save convolution on ``torch.fft``, batched
  over blocks and channels on the input's device, in its dtype;
- :func:`fir_filter` — causal filtering ``np.convolve(x, taps,
  'full')[:nt]`` with backend ``'os'`` (overlap-save, default) or
  ``'pallas'`` (kernel A, :func:`pyfft_tpu_torch.ops.fir.fir_pallas`);
- :func:`upsample` — linear-interpolation upsampling, host NumPy (what
  ``fftanal.resample`` needs).

Butterworth design, IIR filtering, downsampling and the rest of the
resampling are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import segmentation as seg
from .utils.interp import interp

__all__ = ["firwin", "oaconvolve", "fir_filter", "upsample"]


# --------------------------------------------------------------------------- #
# FIR design
# --------------------------------------------------------------------------- #

def firwin(numtaps, cutoff, window="hamming", pass_zero=True, fs=2.0):
    """Windowed-sinc FIR design (scipy.signal.firwin-compatible subset).

    ``cutoff`` scalar -> low-pass (or high-pass with ``pass_zero=False``);
    pair -> band-stop (``pass_zero=True``) or band-pass (``False``).
    """
    from .windows import get_window

    numtaps = int(numtaps)
    cutoff = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / (fs / 2.0)
    if np.any(cutoff <= 0) or np.any(cutoff >= 1):
        raise ValueError("cutoff must be inside (0, fs/2)")

    pass_nyquist = bool(len(cutoff) % 2) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError("A filter with an even number of taps cannot pass "
                         "the Nyquist frequency.")

    bands = np.concatenate([[0.0] if pass_zero else [],
                            cutoff,
                            [1.0] if pass_nyquist else []])
    bands = bands.reshape(-1, 2)

    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps) - alpha
    h = np.zeros(numtaps)
    for left, right in bands:
        h += right * np.sinc(right * m)
        h -= left * np.sinc(left * m)

    win = get_window(window, numtaps, fftbins=False)
    h *= win

    # normalize unit gain at the center of the first passband
    left, right = bands[0]
    if left == 0:
        scale_frequency = 0.0
    elif right == 1:
        scale_frequency = 1.0
    else:
        scale_frequency = 0.5 * (left + right)
    c = np.cos(np.pi * m * scale_frequency)
    h /= np.sum(h * c)
    return h



# --------------------------------------------------------------------------- #
# Overlap-save FIR convolution
# --------------------------------------------------------------------------- #

def _os_plan(nx, ntaps, nfft=None):
    if nfft is None:
        nfft = 1
        while nfft < 8 * ntaps or nfft < 1024:
            nfft *= 2
        nfft = min(nfft, 1 << 18)
        while nfft < 2 * ntaps:
            nfft *= 2
    hop = nfft - (ntaps - 1)
    nblocks = int(np.ceil(nx / hop))
    return nfft, hop, nblocks



def oaconvolve(x, taps, mode="full", nfft=None):
    """Overlap-save FIR convolution along the last axis of a real tensor.

    Block the input, rFFT each block, multiply by the tap response,
    inverse-transform and drop the ``ntaps-1`` wrap-around samples, batched
    over blocks and channels on ``x``'s device and in its floating dtype
    (integers are promoted to float64).  ``mode`` follows numpy.convolve.
    """
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    taps = np.asarray(taps, dtype=np.float64)
    ntaps = len(taps)
    nx = x.shape[-1]
    nfull = nx + ntaps - 1
    nfft, hop, nblocks = _os_plan(nfull, ntaps, nfft)
    H = torch.as_tensor(np.fft.rfft(taps, n=nfft), device=x.device).to(
        torch.promote_types(x.dtype, torch.complex64))
    xp = F.pad(x, (ntaps - 1, nblocks * hop - nx + nfft))
    fr = seg.frame_signal(xp, nfft, hop, nblocks)
    Y = torch.fft.irfft(torch.fft.rfft(fr, dim=-1) * H, n=nfft, dim=-1)
    y = Y[..., ntaps - 1:].reshape(*x.shape[:-1], nblocks * hop)[..., :nfull]
    if mode == "full":
        return y
    if mode == "same":
        start = (ntaps - 1) // 2
        return y[..., start:start + nx]
    if mode == "valid":
        return y[..., ntaps - 1:nx]
    raise ValueError(f"unknown mode {mode!r}")


def fir_filter(x, taps, axis=-1, backend=None):
    """Causal FIR filtering ('same' alignment as lfilter) of a tensor.

    ``backend``: 'os' (overlap-save, default) or 'pallas' (kernel A on a
    CUDA tensor, taps <= 1024; its plain version on a CPU tensor).  The
    result has ``x``'s shape, dtype and device.
    """
    x = torch.movedim(torch.as_tensor(x), axis, -1)
    if backend == "pallas":
        from .ops.fir import fir_pallas
        y = fir_pallas(x.reshape(-1, x.shape[-1]), taps)
        y = y.reshape(x.shape).to(x.dtype)
    else:
        y = oaconvolve(x, taps, mode="full")[..., :x.shape[-1]]
    return torch.movedim(y, -1, axis)


# --------------------------------------------------------------------------- #
# Resampling (reference filters.py:20-34)
# --------------------------------------------------------------------------- #

def upsample(u_t, Fs, Fs_new, plotit=False):
    """Linear-interpolation upsampling (reference ``upsample``, :20-34)."""
    u_t = np.asarray(u_t)
    nt = len(u_t)
    tt = np.arange(0, nt, 1) / Fs
    ti = np.arange(tt[0], tt[-1], 1 / Fs_new)
    return interp(tt, u_t, ei=None, xo=ti)
