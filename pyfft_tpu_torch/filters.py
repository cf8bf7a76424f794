"""Filter design, IIR and FIR filtering, and resampling on tensors
(counterpart of :mod:`pyfft_tpu.filters`).

- Design is host NumPy (copied): :func:`butter` (matches
  ``scipy.signal.butter``), :func:`butter_lowpass`, :func:`firwin`,
  :func:`freqz`, :func:`lfilter_zi`, :func:`iir_to_fir`.
- IIR application, :func:`lfilter` / :func:`filtfilt`: the JAX package runs
  the transposed-direct-form-II recurrence as a ``lax.scan`` over samples.
  Here it steps over blocks of ``L`` samples instead (a Python loop per
  sample would cost several launches per sample on the card).  Within a
  block the output is the lower-triangular Toeplitz product of the
  impulse response (exact over the block, float64) plus the free response
  of the state at the block's start; the states at the blocks' starts come
  from a log-depth scan of ``z[b+1] = A^L z[b] + f[b]`` over the blocks,
  where ``f[b]`` is the block's forced state.  All of it is batched
  matmuls on the input's device.  :func:`filtfilt` keeps scipy's
  ``method='pad'``, odd extension and ``lfilter_zi`` initial conditions.
- FIR: :func:`oaconvolve` (overlap-save on ``torch.fft``),
  :func:`fir_filter` (``'os'`` or ``'pallas'``, kernel A on a CUDA
  tensor), :func:`fir_filtfilt`, all NumPy out; the package's own callers
  use the tensor-in, tensor-out ``_oaconvolve`` and ``_fir_filter``.  The
  tile-layout names
  (:func:`tile_rows`, :func:`untile_rows`, :func:`fir_filter_tiled`) are
  thin aliases of :mod:`pyfft_tpu_torch.ops.fir`.
- Resampling: :func:`upsample`, :func:`downsample`,
  :func:`downsample_efficient`, :func:`resample_poly`, and :func:`smooth`.

Functions that return NumPy in the JAX package return NumPy here; they
compute on the port's device (:func:`pyfft_tpu_torch.config.resolve_device`:
``device``, else the first tensor's device, else the package default, else
the card) in float64 (complex128 for complex
input), as the JAX package does under x64.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import segmentation as seg
from .ops.fir import tile_rows, untile_rows, fir_pallas_tiled
from .config import _np, _tensor, resolve_device
from .utils.interp import interp

__all__ = ["butter", "butter_lowpass", "butter_bandpass",
           "butter_lowpass_filter", "complex_filtfilt", "lfilter",
           "lfilter_zi", "filtfilt", "upsample", "downsample",
           "downsample_efficient", "smooth", "smooth_demo", "firwin", "freqz",
           "oaconvolve", "fir_filter", "fir_filtfilt", "iir_to_fir",
           "resample_poly", "tile_rows", "untile_rows", "fir_filter_tiled"]


def _wide(x, device):
    """``x`` as a float64 (complex128 if complex) tensor on ``device``."""
    t = _tensor(x, device)
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


# --------------------------------------------------------------------------- #
# Butterworth design (host NumPy; matches scipy.signal.butter)
# --------------------------------------------------------------------------- #

def _poly_from_roots(roots):
    p = np.array([1.0 + 0.0j])
    for r in roots:
        p = np.convolve(p, np.array([1.0, -r]))
    return p


def butter(order, Wn, btype="low"):
    """Digital Butterworth design: returns ``(b, a)``.

    ``Wn`` is normalized to Nyquist (as scipy): scalar for low/high, pair
    for band.  Analog prototype poles -> frequency transform -> bilinear.
    """
    order = int(order)
    Wn = np.atleast_1d(np.asarray(Wn, dtype=np.float64))
    if np.any(Wn <= 0) or np.any(Wn >= 1):
        raise ValueError("Wn must be in (0, 1) (normalized to Nyquist)")

    # analog lowpass prototype: poles on the unit circle, no zeros
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order)
    p = -np.sin(theta) + 1j * np.cos(theta)
    z = np.array([], dtype=complex)

    fs = 2.0
    warped = 2 * fs * np.tan(np.pi * Wn / fs)

    if btype in ("low", "lowpass"):
        p = p * warped[0]
    elif btype in ("high", "highpass"):
        p = warped[0] / p
        z = np.zeros(order, dtype=complex)
    elif btype in ("band", "bandpass"):
        bw = warped[1] - warped[0]
        w0 = np.sqrt(warped[0] * warped[1])
        p_lp = p * bw / 2
        p = np.concatenate([p_lp + np.sqrt(p_lp ** 2 - w0 ** 2 + 0j),
                            p_lp - np.sqrt(p_lp ** 2 - w0 ** 2 + 0j)])
        z = np.zeros(order, dtype=complex)
    elif btype in ("stop", "bandstop"):
        bw = warped[1] - warped[0]
        w0 = np.sqrt(warped[0] * warped[1])
        p_hp = (bw / 2) / p
        p = np.concatenate([p_hp + np.sqrt(p_hp ** 2 - w0 ** 2 + 0j),
                            p_hp - np.sqrt(p_hp ** 2 - w0 ** 2 + 0j)])
        z = np.concatenate([1j * w0 * np.ones(order),
                            -1j * w0 * np.ones(order)])
    else:
        raise ValueError(f"unknown btype {btype!r}")

    # bilinear transform; zeros at infinity map to z = -1
    fs2 = 2.0 * fs
    z_b = (fs2 + z) / (fs2 - z)
    p_b = (fs2 + p) / (fs2 - p)
    z_b = np.concatenate([z_b, -np.ones(len(p) - len(z))])

    b = np.real(_poly_from_roots(z_b))
    a = np.real(_poly_from_roots(p_b))

    # fix the overall gain exactly at a known unit-gain frequency:
    # DC (low/stop), Nyquist (high), or the warped geometric center (band)
    if btype in ("high", "highpass"):
        wtest = np.pi
    elif btype in ("band", "bandpass"):
        wtest = 2 * np.arctan(np.sqrt(np.prod(np.tan(np.pi * Wn / 2))))
    else:
        wtest = 0.0
    ejw = np.exp(-1j * wtest * np.arange(max(len(b), len(a))))
    resp = np.abs(np.dot(b, ejw[:len(b)]) / np.dot(a, ejw[:len(a)]))
    b = b / resp
    return b, a


def butter_lowpass(cutoff, fnyq, order=5):
    """Reference helper (``filters.py:336-341``): ``Wn = cutoff/fnyq``."""
    return butter(order, cutoff / fnyq, btype="low")


def butter_bandpass(x, fs=4e6, lf=1000, hf=500e3, order=3, disp=0,
                    device=None):
    """Causal Butterworth band-pass of a signal (reference ``:323-333``)."""
    nyq = 0.5 * fs
    b, a = butter(order, [lf / nyq, hf / nyq], btype="band")
    return lfilter(b, a, x, device=device)


def butter_lowpass_filter(data, cutoff, fs, order=5, axis=0, device=None):
    """Zero-phase Butterworth low-pass (reference ``:344-348``).

    Note the reference passes the sampling frequency as the ``fnyq`` argument
    of ``butter_lowpass`` — preserved for parity.
    """
    b, a = butter_lowpass(cutoff, fs, order=order)
    return filtfilt(b, a, data, axis=axis, device=device)


def complex_filtfilt(filt_n, filt_d, data, device=None):
    """filtfilt on real and imaginary parts separately (reference ``:351``)."""
    data = _tensor(data, resolve_device(device, data))
    dRR = filtfilt(filt_n, filt_d, data.real)
    dII = filtfilt(filt_n, filt_d, data.imag if data.is_complex()
                   else torch.zeros_like(data))
    return dRR + 1j * dII


# --------------------------------------------------------------------------- #
# IIR application: transposed direct form II, stepped over blocks
# --------------------------------------------------------------------------- #

_LFILTER_BLOCK = 1024


def _normalize(b, a):
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    n = max(len(a), len(b))
    return (np.pad(b, (0, n - len(b))) / a[0],
            np.pad(a, (0, n - len(a))) / a[0])


@lru_cache(maxsize=64)
def _block_operators(b, a, L):
    """Host operators of the TDF-II filter ``(b, a)`` (normalized tuples,
    order >= 1) over blocks of ``L`` samples.

    State space: ``z[n+1] = A z[n] + B x[n]``, ``y[n] = z_0[n] + b_0 x[n]``.
    Returns float64 ``T`` (L, L), the lower-triangular Toeplitz matrix of
    the impulse response; ``O`` (L, order) with rows ``e_0 A^j`` (free
    response); ``G`` (order, L) with columns ``A^(L-1-i) B`` (forced state
    at the block's end); and ``Apow`` (L+1, order, order), ``A^j``.  The
    powers are formed one product at a time in extended precision: ``A`` is
    far from normal when poles crowd ``z = 1`` (a low cutoff), and
    repeated squaring in float64 loses about 1e-10 there.
    """
    ld = np.longdouble
    b = np.asarray(b, dtype=ld)
    a = np.asarray(a, dtype=ld)
    order = len(a) - 1
    A = np.zeros((order, order), dtype=ld)
    A[:, 0] = -a[1:]
    A[np.arange(order - 1), np.arange(1, order)] += 1
    B = b[1:] - a[1:] * b[0]
    Apow = np.empty((L + 1, order, order), dtype=ld)
    Apow[0] = np.eye(order, dtype=ld)
    for j in range(L):
        Apow[j + 1] = A @ Apow[j]
    O = Apow[:L, 0, :]
    Gr = Apow[:L] @ B                                   # A^j B
    h = np.concatenate([[b[0]], O[:L - 1] @ B])
    idx = np.arange(L)
    lag = idx[:, None] - idx[None, :]
    T = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0)
    f64 = lambda m: np.ascontiguousarray(m, dtype=np.float64)  # noqa: E731
    return f64(T), f64(O), f64(Gr[::-1].T), Apow


@lru_cache(maxsize=64)
def _scan_powers(b, a, L, levels):
    """``P^(2^k)``, ``k < levels``, of the block transition ``P = A^L``,
    squared in extended precision, as float64."""
    Q = _block_operators(b, a, L)[3][L]
    out = []
    for _ in range(levels):
        out.append(Q.astype(np.float64))
        Q = Q @ Q
    return out


def _lfilter_t(b, a, x, zi=None, block=None):
    """TDF-II filter of ``x (..., nt)`` (float64/complex128 tensor) along
    its last axis, stepped over blocks (module docstring).  ``b``, ``a``
    normalized (``a[0] = 1``, equal lengths, order >= 1); ``zi (...,
    order)`` or None.  Returns ``(y, zf)`` tensors on ``x``'s device."""
    L = int(block or _LFILTER_BLOCK)
    b, a = tuple(b), tuple(a)
    order = len(a) - 1
    lead, nt = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, nt)
    R = x2.shape[0]
    T, O, G, Apow = _block_operators(b, a, L)
    op = lambda m: torch.as_tensor(  # noqa: E731
        np.asarray(m, dtype=np.float64), dtype=x.dtype, device=x.device)
    nb = max(1, -(-nt // L))
    X = F.pad(x2, (0, nb * L - nt)).reshape(R, nb, L)
    z0 = (torch.zeros(R, order, dtype=x.dtype, device=x.device)
          if zi is None else zi.to(x.dtype).reshape(R, order))
    # forced state of each block, with the start state folded into block 0
    f = X @ op(G).T                                     # (R, nb, order)
    f[:, 0] += z0 @ op(Apow[L]).T
    # inclusive scan of s[b] = P s[b-1] + f[b] (Hillis-Steele doubling)
    d = 1
    for Q in _scan_powers(b, a, L, (nb - 1).bit_length()):
        f = torch.cat([f[:, :d], f[:, d:] + f[:, :-d] @ op(Q).T], dim=1)
        d *= 2
    Z = torch.cat([z0[:, None], f[:, :-1]], dim=1)      # block-start states
    Y = X @ op(T).T + Z @ op(O).T
    y = Y.reshape(R, nb * L)[:, :nt].reshape(*lead, nt)
    r = nt - (nb - 1) * L                               # samples in last block
    zf = Z[:, -1] @ op(Apow[r]).T + X[:, -1, :r] @ op(G[:, L - r:]).T
    return y, zf.reshape(*lead, order)


def lfilter(b, a, x, zi=None, axis=-1, device=None):
    """Causal IIR filter (scipy-compatible semantics); NumPy out.  Returns
    ``y``, or ``(y, zf)`` when ``zi`` is given."""
    b, a = _normalize(b, a)
    order = len(a) - 1
    if order == 0:
        x = _np(x)
        y = b[0] * x
        return (y, np.zeros(x.shape[:-1] + (0,))) if zi is not None else y
    xm = torch.movedim(_wide(x, resolve_device(device, x, zi)), axis, -1)
    z0 = None
    if zi is not None:
        z0 = torch.movedim(_wide(zi, xm.device), axis, -1).broadcast_to(
            xm.shape[:-1] + (order,))
    y, zf = _lfilter_t(b, a, xm, z0)
    y = _np(torch.movedim(y, -1, axis))
    return (y, _np(zf)) if zi is not None else y


def lfilter_zi(b, a):
    """Steady-state initial conditions for a step input (scipy-compatible)."""
    b, a = _normalize(b, a)
    n = len(a)
    # companion matrix of a
    comp = np.zeros((n - 1, n - 1))
    comp[0, :] = -a[1:]
    comp[1:, :-1] = np.eye(n - 2)
    IminusA = np.eye(n - 1) - comp.T
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(IminusA, B)


def _filtfilt_t(b, a, x):
    """Zero-phase filter of the tensor ``x (..., nt)`` along its last axis
    (:func:`filtfilt`); a tensor out."""
    nt = x.shape[-1]
    padlen = 3 * max(len(a), len(b))
    if nt <= padlen:
        raise ValueError(f"The length of the input vector x must be greater "
                         f"than padlen, which is {padlen}.")
    # odd extension
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., nt - padlen - 1:nt - 1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    zi = torch.as_tensor(lfilter_zi(b, a), dtype=x.dtype, device=x.device)
    bn, an = _normalize(b, a)
    y, _ = _lfilter_t(bn, an, ext, zi * ext[..., :1])
    y = y.flip(-1)
    y, _ = _lfilter_t(bn, an, y, zi * y[..., :1])
    return y.flip(-1)[..., padlen:padlen + nt]


def filtfilt(b, a, x, axis=-1, device=None):
    """Zero-phase forward-backward IIR filter; NumPy out.

    scipy-compatible (``method='pad'``, ``padtype='odd'``,
    ``padlen = 3 * max(len(a), len(b))``) — the semantics the reference
    relies on throughout its resampling chain (``filters.py:99,191,347``).
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    xm = torch.movedim(_wide(x, resolve_device(device, x)), axis, -1)
    return _np(torch.movedim(_filtfilt_t(b, a, xm), -1, axis))


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


def freqz(b, a=1.0, worN=512, fs=2 * np.pi):
    """Frequency response of a digital filter (host-side)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if np.ndim(worN) == 0:
        w = np.linspace(0, np.pi, int(worN), endpoint=False)
    else:
        w = 2 * np.pi * np.asarray(worN) / fs
    zm = np.exp(-1j * np.outer(w, np.arange(max(len(b), len(a)))))
    h = zm[:, :len(b)] @ b / (zm[:, :len(a)] @ a)
    return w * fs / (2 * np.pi), h


def iir_to_fir(b, a, ntaps=None, tol=1e-8):
    """Truncated-impulse-response FIR equivalent of a stable IIR filter
    (host design: the impulse responses run on the CPU).

    Applying this FIR (forward) or its zero-phase variant
    (:func:`fir_filtfilt`) reproduces the IIR magnitude response within
    ``tol`` (the truncation point is chosen where the impulse response has
    decayed below ``tol`` relative to its peak).
    """
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    if ntaps is None:
        n = 64
        while n < 1 << 20:
            imp = np.zeros(n)
            imp[0] = 1.0
            h = lfilter(b, a, imp, device="cpu")
            tail = np.max(np.abs(h[-n // 8:]))
            if tail < tol * np.max(np.abs(h)):
                break
            n *= 2
        ntaps = n
    imp = np.zeros(int(ntaps))
    imp[0] = 1.0
    return lfilter(b, a, imp, device="cpu")



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



def _oaconvolve(x, taps, mode="full", nfft=None):
    """Overlap-save FIR convolution along the last axis of the real tensor
    ``x``; a tensor out.

    Block the input, rFFT each block, multiply by the tap response,
    inverse-transform and drop the ``ntaps-1`` wrap-around samples, batched
    over blocks and channels on ``x``'s device and in its floating dtype
    (integers are promoted to float64).  ``mode`` follows numpy.convolve.
    """
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


def oaconvolve(x, taps, mode="full", nfft=None, device=None):
    """Overlap-save FIR convolution along the last axis (:func:`_oaconvolve`)
    on ``device``; NumPy out, as in the JAX package."""
    x = _tensor(x, resolve_device(device, x))
    return _np(_oaconvolve(x, taps, mode, nfft))


def _fir_filter(x, taps, axis=-1, backend=None):
    """Causal FIR filtering ('same' alignment as lfilter) of the tensor
    ``x``; the result has ``x``'s shape, dtype and device.

    ``backend``: 'os' (overlap-save, default) or 'pallas' (kernel A on a
    CUDA tensor, taps <= 1024; its plain version on a CPU tensor).
    """
    x = torch.movedim(x, axis, -1)
    if backend == "pallas":
        from .ops.fir import fir_pallas
        y = fir_pallas(x.reshape(-1, x.shape[-1]), taps)
        y = y.reshape(x.shape).to(x.dtype)
    else:
        y = _oaconvolve(x, taps, mode="full")[..., :x.shape[-1]]
    return torch.movedim(y, -1, axis)


def fir_filter(x, taps, axis=-1, backend=None, device=None):
    """Causal FIR filtering (:func:`_fir_filter`) on ``device``; NumPy out,
    as in the JAX package."""
    return _np(_fir_filter(_tensor(x, resolve_device(device, x)), taps, axis,
                           backend))


def fir_filter_tiled(xr, taps, precision=None):
    """Causal FIR on the ``(nch, nrows, 128)`` view of :func:`tile_rows`,
    same layout out (:func:`pyfft_tpu_torch.ops.fir.fir_pallas_tiled`).
    ``precision`` is accepted for the JAX signature; the card filters in
    float32."""
    return fir_pallas_tiled(xr, taps)


def fir_filtfilt(x, taps, axis=-1, device=None):
    """Zero-phase FIR filtering with reflected-edge padding; NumPy out.

    For a symmetric (linear-phase) ``taps`` this applies the filter once and
    removes the group delay (apply :func:`iir_to_fir` twice via squared
    response for an exact |H|^2 match with an IIR ``filtfilt``).
    """
    x = torch.movedim(_wide(x, resolve_device(device, x)), axis, -1)
    ntaps = len(taps)
    pad = ntaps
    left = 2 * x[..., :1] - x[..., 1:pad + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -pad - 1:-1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    y = _oaconvolve(ext, taps, mode="full")
    delay = (ntaps - 1) // 2
    y = y[..., pad + delay:pad + delay + x.shape[-1]]
    return _np(torch.movedim(y, -1, axis))


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


def _filtfilt_columns(b, a, u_t, device):
    """:func:`filtfilt` along axis 0 of the 2-D ``u_t (nt, nch)`` on
    ``device``; NumPy ``(nt, nch)`` out (a transposed view of the
    contiguous ``(nch, nt)`` result, so the copy to the host is dense)."""
    x = _wide(u_t, device).T
    return _np(_filtfilt_t(np.asarray(b), np.asarray(a), x)).T


def downsample(u_t, Fs, Fs_new, plotit=False, device=None):
    """LPF (Butterworth-2 filtfilt) then interpolate to the new rate.

    Behavior-parity with reference ``downsample`` (:36-121): always returns
    a 2-D ``(nt_new, nch)`` array.
    """
    tau = 2 / Fs_new
    dev = resolve_device(device, u_t)
    u_t = np.asarray(_np(u_t), dtype=np.float64)
    nt = len(u_t)
    tt = np.arange(0, nt, 1) / Fs
    if u_t.ndim == 1:
        u_t = u_t.reshape(nt, 1)
    lowpass_n, lowpass_d = butter(2, 2.0 / (Fs * tau), btype="low")
    ti = np.arange(0, nt / Fs, 1 / Fs_new)
    filtered = _filtfilt_columns(lowpass_n, lowpass_d, u_t, dev)
    return np.asarray(interp(tt, filtered, ei=None, xo=ti))


def downsample_efficient(u_t, Fs, Fs_new, plotit=False, halforder=2,
                         lowpass=None, device=None):
    """Vectorized LPF + resample (reference ``downsample_efficient``,
    :123-218)."""
    if lowpass is None:
        lowpass = 0.5 * Fs_new
    dev = resolve_device(device, u_t)
    u_t = np.asarray(_np(u_t), dtype=np.float64)
    nt = len(u_t)
    squeeze = u_t.ndim == 1
    if squeeze:
        u_t = u_t.reshape(nt, 1)
    lowpass_n, lowpass_d = butter(halforder, 2.0 * lowpass / Fs, btype="low")
    filtered = _filtfilt_columns(lowpass_n, lowpass_d, u_t, dev)
    out = np.asarray(interp(xi=np.arange(0, nt, 1) / Fs, yi=filtered,
                            ei=None, xo=np.arange(0, nt / Fs, 1 / Fs_new)))
    return out[:, 0] if squeeze else out


def smooth(x, window_len=11, window="hanning", device=None):
    """Windowed moving average with reflected ends (reference ``smooth``,
    :226-285, with integer slicing so that the output has the input's
    length), convolved by :func:`oaconvolve` on ``device``; NumPy out."""
    dev = resolve_device(device, x)
    x = np.asarray(_np(x))
    if x.ndim != 1:
        raise ValueError("smooth only accepts 1 dimension arrays.")
    if x.size < window_len:
        raise ValueError("Input vector needs to be bigger than window size.")
    if window_len < 3:
        return x
    if window not in ["flat", "hanning", "hamming", "bartlett", "blackman"]:
        raise ValueError("Window is one of 'flat', 'hanning', 'hamming', "
                         "'bartlett', 'blackman'")
    s = np.r_[x[window_len - 1:0:-1], x, x[-1:-window_len:-1]]
    if window == "flat":
        w = np.ones(window_len, "d")
    else:
        w = getattr(np, window)(window_len)
    y = oaconvolve(s, w / w.sum(), mode="valid", device=dev)
    return y[(window_len // 2 - 1):-(window_len // 2)]


def smooth_demo(plotit=False):
    """Window-comparison demo for :func:`smooth` (reference ``smooth_demo``,
    filters.py:287-320).  Returns ``{window_name: smoothed}``."""
    rng = np.random.default_rng(0)
    t = np.linspace(-4, 4, 100)
    x = np.sin(t)
    xn = x + rng.standard_normal(len(t)) * 0.1
    ws = 31
    names = ["flat", "hanning", "hamming", "bartlett", "blackman"]
    out = {w: np.asarray(smooth(xn, ws, w)) for w in names}
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure("smooth_demo")
        plt.plot(x, "k-", label="signal")
        plt.plot(xn, ".", label="noisy")
        for w, y in out.items():
            plt.plot(y, label=w)
        plt.legend()
    return out


def resample_poly(x, up, down, axis=-1, taps=None, device=None):
    """Polyphase rational-rate resampling (scipy ``resample_poly`` parity);
    NumPy out.

    Phase sub-filter ``h_p[i] = h[i*up + p]`` is applied with the
    overlap-save convolution (one batched convolution per phase), and the
    outputs interleave and decimate to the ``up/down`` rate: no
    zero-stuffed signal is built.  ``taps=None`` designs the scipy default
    anti-alias filter (Kaiser beta=5.0, 10*max(up,down) taps per side, gain
    ``up``).
    """
    from math import gcd

    up, down = int(up), int(down)
    if up <= 0 or down <= 0:
        raise ValueError("up and down must be positive")
    g = gcd(up, down)
    up //= g
    down //= g
    if up == down == 1:
        return np.array(_np(x), copy=True)

    xm = torch.movedim(_tensor(x, resolve_device(device, x)), axis, -1)
    if not (xm.is_floating_point() or xm.is_complex()):
        xm = xm.to(torch.float64)
    n_in = xm.shape[-1]
    if taps is None:
        max_rate = max(up, down)
        f_c = 1.0 / (2 * max_rate)
        half_len = 10 * max_rate
        from .windows import kaiser
        ntaps = 2 * half_len + 1
        m = np.arange(ntaps) - half_len
        h = 2 * f_c * np.sinc(2 * f_c * m) * kaiser(ntaps, 5.0)
        h = h / h.sum() * up
    else:
        h = np.asarray(taps, dtype=np.float64)
    ntaps = len(h)

    # scipy output alignment: n_out samples, group delay (ntaps-1)//2
    n_out = -(-n_in * up // down)
    offset = (ntaps - 1) // 2

    lead = xm.shape[:-1]
    x2 = xm.reshape(-1, n_in)
    phases = [_oaconvolve(x2, h[p::up] if len(h[p::up]) else np.zeros(1),
                          mode="full") for p in range(up)]
    # interleave: y_full[q*up + p] = phases[p][q]
    qmax = max(ph.shape[-1] for ph in phases)
    y_full = x2.new_zeros(x2.shape[:-1] + (qmax * up,),
                          dtype=phases[0].dtype)
    for p, yp in enumerate(phases):
        y_full[..., p::up][..., :yp.shape[-1]] = yp
    y = y_full[..., offset:offset + n_out * down:down]
    y = F.pad(y, (0, n_out - y.shape[-1]))
    return _np(torch.movedim(y.reshape(*lead, n_out), -1, axis))
