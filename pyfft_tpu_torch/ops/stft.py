"""Per-segment STFT after global-mean detrend and window: kernel C and its
plain version.

Counterpart of the STFT entry of :mod:`pyfft_tpu.ops.pallas_welch3`
(``stft_pallas3``).  Contract, as in the JAX package: ``x (nt,)`` and
optional further signals ``y (nch, nt)``, all real or all complex; the
global mean of each signal removed (``detrend_style`` 1) or not (0); ``win``
on ``navr`` segments of ``nwins`` samples every ``hop``; returns the DFT of
every segment, all ``nwins`` bins in natural order, scaled by ``norm``.
There is no filter on this path.

- On CUDA tensors :func:`stft_cuda` launches kernel C (``csrc/stft.cu``:
  two real segments per complex FFT on the register-radix Stockham FFT of
  ``csrc/fft_reg.cuh``, each scaled by its own power of two, so that each
  segment's error follows its own size, not its partner's: 2e-5 of its
  own max however quiet it is beside the other).  Its means are
  ``welch._row_sums / nt``: float32
  block sums added in float64, with no float64 copy of the signal; the
  window goes to the card once per (content, device).  After the first
  call with a window, a call copies nothing from the host.
- On CPU tensors :func:`stft_plain` runs: mean -> frames -> window ->
  ``torch.fft.fft`` -> times ``norm``, in the input's dtype.

``LAUNCHES`` counts the launches of kernel C.

Domain of the kernel (re-derived for the card; the TPU's lane, hop and
channel-count limits do not apply): ``nwins`` a power of two in
16..16384, any hop in 1..nwins, any ``nt >= (navr-1)*hop + nwins``, any
number of signals (up to 65535), float32 or complex64, ``detrend_style``
in {0, 1}.  Its shared memory is at most 136 KB a block (``nwins`` 16384).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .welch import _row_sums, _twiddles, _window
from .. import segmentation as seg
from ..config import _tensor, resolve_device

__all__ = ["stft_pallas3", "stft_applicable", "stft_plain", "stft_cuda",
           "LAUNCHES"]

_MIN_NWINS = 16
_MAX_NWINS = 16384

LAUNCHES = 0


def stft_applicable(nwins, noverlap, detrend_style=1):
    """Whether kernel C (and :func:`stft_pallas3`) takes this geometry: a
    pure function of shapes and flags."""
    nwins = int(nwins)
    hop = nwins - int(noverlap)
    return (detrend_style in (0, 1)
            and _MIN_NWINS <= nwins <= _MAX_NWINS
            and nwins & (nwins - 1) == 0
            and 1 <= hop <= nwins)


def _stack(x, y):
    """``x (nt,)`` as a tensor and ``y (nch, nt) | (nt,) | None`` as
    ``(nch, nt)`` rows on its device (no rows for None)."""
    x = torch.as_tensor(x)
    if y is None:
        return x, x.new_empty((0, x.shape[-1]))
    y = torch.as_tensor(y, device=x.device)
    return x, (y[None] if y.dim() == 1 else y)


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #

def stft_plain(x, y, win, norm, *, navr, nwins, hop, detrend_style=1):
    """Plain PyTorch version of kernel C, in the inputs' dtype.

    ``x (nt,)``, ``y (nch, nt)`` or None; returns ``(1 + nch, navr,
    nwins)`` complex: ``norm * fft((sig - mean) * win)`` per segment.
    """
    x, y = _stack(x, y)
    dtype = torch.promote_types(x.dtype, y.dtype)
    sig = torch.cat([x[None].to(dtype), y.to(dtype)])
    if detrend_style == 1:
        sig = sig - sig.mean(dim=-1, keepdim=True)
    real = sig.real.dtype if sig.is_complex() else sig.dtype
    w = torch.as_tensor(np.asarray(win), dtype=real, device=sig.device)
    frames = seg.frame_signal(sig, nwins, hop, navr)     # (C, navr, nwins)
    return torch.fft.fft(frames * w, dim=-1) * norm


# --------------------------------------------------------------------------- #
# Kernel C
# --------------------------------------------------------------------------- #

def _means(x, y, detrend_style, cplx):
    """Kernel C's ``means`` operand, float32: each signal's mean (a re, im
    pair for complex signals), first signal first; zeros without detrend.
    Strided views only (a complex ``x`` as its (re, im) rows), so nothing
    is copied."""
    if detrend_style != 1:
        return torch.zeros((1 + y.shape[0]) * (2 if cplx else 1),
                           dtype=torch.float32, device=x.device)
    sums = _row_sums(torch.view_as_real(x).T if cplx else x[None])
    if y.shape[0]:
        ys = (torch.stack([_row_sums(y.real), _row_sums(y.imag)],
                          dim=-1).reshape(-1) if cplx else _row_sums(y))
        sums = torch.cat([sums, ys])
    return (sums / x.shape[-1]).to(torch.float32)


def stft_cuda(x, y, win, norm, *, navr, nwins, hop, detrend_style=1):
    """Launch kernel C.  ``x (nt,)`` contiguous and ``y (nch, nt)`` (or
    None) with unit stride along time, all float32 or all complex64, on one
    CUDA device.  Returns ``(1 + nch, navr, nwins)`` complex64.  Raises
    outside the kernel's domain."""
    global LAUNCHES
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        raise ValueError("stft_cuda needs x on a CUDA device")
    x, y = _stack(x, y)
    cplx = x.is_complex()
    want = torch.complex64 if cplx else torch.float32
    if x.dtype != want or y.dtype != want:
        raise ValueError(f"stft_cuda takes float32 or complex64 signals, "
                         f"got {x.dtype} and {y.dtype}")
    if x.dim() != 1 or not x.is_contiguous() or y.dim() != 2 \
            or y.shape[1] != x.shape[0] or (y.shape[0] and y.stride(1) != 1):
        raise ValueError(
            f"stft_cuda takes x (nt,) contiguous and y (nch, nt) with unit "
            f"time stride, got {tuple(x.shape)} and {tuple(y.shape)} "
            f"strides {tuple(y.stride())}")
    nt = x.shape[0]
    nsig = 1 + y.shape[0]
    if not stft_applicable(nwins, nwins - hop, detrend_style) \
            or nsig > 65535 or navr < 1:
        raise ValueError(
            f"stft kernel: unsupported geometry nwins={nwins} hop={hop} "
            f"navr={navr} nsig={nsig} detrend={detrend_style}")
    if (navr - 1) * hop + nwins > nt:
        raise ValueError(f"{navr} segments of {nwins} every {hop} do not "
                         f"fit {nt} samples")
    dev = x.device
    win32 = np.ascontiguousarray(np.asarray(win), dtype=np.float32)
    if win32.shape != (nwins,):
        raise ValueError(f"window of shape {win32.shape}, need ({nwins},)")
    w = _window(win32.tobytes(), str(dev))
    means = _means(x, y, detrend_style, cplx)
    xf = torch.view_as_real(x) if cplx else x
    yf = torch.view_as_real(y) if cplx else y
    tw = _twiddles(int(nwins), str(dev))
    out = torch.empty((nsig, navr, nwins), dtype=torch.complex64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pyfft_stft(
            xf.data_ptr(), yf.data_ptr() if nsig > 1 else xf.data_ptr(),
            yf.stride(0) if nsig > 1 else 0, int(cplx), nsig,
            means.data_ptr(), w.data_ptr(), tw.data_ptr(), out.data_ptr(),
            int(nwins), int(hop), int(navr), float(norm), stream)
        _build.check(rc, "stft kernel")
    LAUNCHES += 1
    return out


# --------------------------------------------------------------------------- #
# Entry (JAX package name)
# --------------------------------------------------------------------------- #

def _stft(x, y, win, norm, *, navr, nwins, noverlap, detrend_style=1,
          device=None):
    """Complex ``(C, navr, nwins)`` spectra of :func:`stft_pallas3`, on the
    signals' device: signals cast to float32 (complex64 if any is complex),
    as the JAX kernel casts them."""
    if win is None:
        raise TypeError("stft_pallas3 needs a window of nwins samples")
    if not stft_applicable(nwins, noverlap, detrend_style):
        raise ValueError(
            f"stft kernel: unsupported geometry nwins={nwins} "
            f"noverlap={noverlap} detrend={detrend_style}")
    dev = resolve_device(device, x, y)
    x, y = _stack(_tensor(x, dev), None if y is None else _tensor(y, dev))
    dtype = (torch.complex64 if x.is_complex() or y.is_complex()
             else torch.float32)
    x = x.to(dtype).contiguous()
    y = y.to(dtype)
    if y.shape[0] and y.stride(-1) != 1:
        y = y.contiguous()
    kw = dict(navr=int(navr), nwins=int(nwins), hop=int(nwins - noverlap),
              detrend_style=int(detrend_style))
    if x.is_cuda:
        return stft_cuda(x, y, win, norm, **kw)
    return stft_plain(x, y, win, norm, **kw)


def stft_pallas3(x, y=None, win=None, norm=1.0, *, navr, nwins, noverlap,
                 detrend_style=1, device=None):
    """Per-segment STFT of real or complex signals (module docstring).

    ``x (nt,)`` plus optional further signals ``y (nch, nt)`` -> natural-
    order DFT coefficients ``(Xr, Xi)``, each ``(nsig, navr, nwins)``
    float32, scaled by ``norm``.  Detrend is the global mean (reference
    ``fft_analysis.py:357``).  Callers apply one-sided slicing / fftshift
    and the ``fft_win`` scaling conventions.  Raises ``ValueError``
    outside the kernel's domain.
    """
    X = _stft(x, y, win, norm, navr=navr, nwins=nwins, noverlap=noverlap,
              detrend_style=detrend_style, device=device)
    return X.real, X.imag
