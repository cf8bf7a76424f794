"""Welch cross-powers at any segment length: kernel E and its plain version.

Counterpart of the v1 half of :mod:`pyfft_tpu.ops.pallas_welch`
(``welch_pallas_fused``, ``welch_power_pallas``, ``pallas_welch_applicable``),
whose ``_welch_power_call`` launches ``_accum_kernel``.  The TPU kernel's
dense window-folded DFT tables (``stft_matmul_tables``) have no
counterpart: kernel E runs FFTs.  Contract, as in the JAX package: ``x (nt,)`` reference
and ``y (nch, nt)`` channels, cast to float32; each signal detrended over
its whole span (``detrend_style`` 1 global mean, 0 none, -1 global
least-squares line); ``navr`` segments of ``nwins`` samples every ``hop``,
windowed by ``win``; returns ``(Pxx (nfreq,), Pyy (nch, nfreq), Pxy_re,
Pxy_im)``, the first ``nfreq`` one-sided bins summed over segments and
scaled by ``norm``, with ``Pxy = Y conj(X)``.  The caller applies the
one-sided bin doubling.  ``_run`` returns kernel B's result block.

- On CUDA tensors :func:`welch_dft_cuda` launches kernel E
  (``csrc/welch_dft.cu``): the kept bins of every (signal, segment)
  spectrum go to a scratch buffer, then float64 sums over the segments in
  a fixed order give the outputs.  A segment length that is not a power
  of two (or is below 16) goes through Bluestein's algorithm on ``M``-point
  FFTs cut to the ``nfreq`` kept bins, ``M`` the least power of two ``>=
  max(16, nwins + nfreq - 1)`` (:func:`bluestein_size`; 8192 at the
  heat-pulse geometry, nwins 4871).  The chirp ``exp(-i pi n^2 / nwins)``
  comes from the exact integer ``n^2 mod 2*nwins`` in float64, and the
  chirp filter's FFT is computed once per ``(nwins, nfreq)`` on the host,
  in float64.  Each signal's mean and slope come from a float64 prologue
  in plain torch (:func:`_trend`): block sums of ``x`` and of ``(t -
  tbar) x``.  The scratch holds at most ``SCRATCH_CAP`` bytes (256 MiB):
  the segments are taken in chunks, and the channels too where one
  segment of every signal does not fit (beyond 8189 channels at nfreq
  4097) (:func:`_chunks`), one call of the C entry a chunk.
- On CPU tensors :func:`welch_dft_plain` runs: detrend -> frames ->
  window -> ``torch.fft.fft`` -> sums, in the input's dtype.

``LAUNCHES`` counts the launches of kernel E.  The entries compute on the
port's device (:func:`pyfft_tpu_torch.config.resolve_device`).

Domain of the kernel (re-derived for the card; the TPU's VMEM tiling does
not apply): ``1 <= nwins <= 8192`` (so ``M <= 16384``, 136 KB of complex64
in shared memory), any ``hop >= 1``, ``1 <= nfreq <= nwins // 2 + 1``,
any ``nch >= 0`` (up to 65534), ``detrend_style`` in {-1, 0, 1}, real
float32 signals.  The JAX gate :func:`pallas_welch_applicable` holds only
for ``nwins <= 5452`` (its minimal (8, 128) tiles in 11 MB of VMEM), all
of it inside this domain.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from ..config import resolve_device
from .welch import (_SUM_BLOCK, _block, _row_sums, _signals, _split,
                    _twiddles, welch_plain)
from ..utils.detrend import detrend_func

__all__ = ["welch_pallas_fused", "welch_power_pallas",
           "pallas_welch_applicable", "bluestein_size", "welch_dft_plain",
           "welch_dft_cuda", "kernel_applicable", "MAX_NWINS", "SCRATCH_CAP",
           "LAUNCHES"]

MAX_NWINS = 8192

# Bytes of kernel E's spectra scratch at most (module docstring).
SCRATCH_CAP = 256 << 20

LAUNCHES = 0


# --------------------------------------------------------------------------- #
# The JAX gate of TPU kernel #7 (pure functions of shapes, copied)
# --------------------------------------------------------------------------- #

def _round_up(x, m):
    return ((x + m - 1) // m) * m


# Scoped VMEM budget of the TPU kernel (pallas_welch.py:50-52).
_VMEM_BUDGET = 11 * 1024 * 1024


def _vmem_bytes(nwins, freq_tile, seg_tile):
    tables = 2 * (2 * nwins * freq_tile)
    frames = 2 * (seg_tile * nwins)
    ref = 2 * (2 * seg_tile * freq_tile)
    outs = 2 * (3 * freq_tile)
    return 4 * (tables + frames + ref + outs)


def _choose_tiles(nwins, nfreq, B, seg_tile, freq_tile):
    seg_tile = min(seg_tile, _round_up(B, 8))
    freq_tile = min(freq_tile, _round_up(nfreq, 128))
    while _vmem_bytes(nwins, freq_tile, seg_tile) > _VMEM_BUDGET:
        if freq_tile > 128:
            freq_tile -= 128
        elif seg_tile > 8:
            seg_tile = max(8, seg_tile // 2)
        else:
            return None
    return seg_tile, freq_tile


def pallas_welch_applicable(nwins, nfreq=None, B=1):
    """Whether the JAX package's TPU kernel #7 tiles ``nwins``-sample
    segments in its VMEM (``pallas_welch.py:83-86``): the gate that
    ``fft_pwelch(..., fft_backend='pallas')`` applies before it takes the
    kernel, here as there."""
    nfreq = nfreq if nfreq is not None else nwins // 2 + 1
    return _choose_tiles(nwins, nfreq, B, 128, 256) is not None


def kernel_applicable(nwins, nfreq, hop, navr, detrend_style=1):
    """Whether kernel E takes this geometry (module docstring)."""
    nwins = int(nwins)
    return (1 <= nwins <= MAX_NWINS and 1 <= int(nfreq) <= nwins // 2 + 1
            and int(hop) >= 1 and int(navr) >= 1
            and int(detrend_style) in (-1, 0, 1))


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #

def welch_dft_plain(x, y, win, nfreq, norm, *, navr, nwins, hop,
                    detrend_style=1):
    """Plain PyTorch version of kernel E, in the inputs' dtype: detrend
    each whole signal (:mod:`pyfft_tpu_torch.utils.detrend`), then
    :func:`pyfft_tpu_torch.ops.welch.welch_plain` (``unfold``, window,
    ``torch.fft.fft``, sums over segments)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    if y.dim() == 1:
        y = y[None]
    det = detrend_func(detrend_style)
    return welch_plain(det(x, axis=-1), det(y, axis=-1), win, nfreq, norm,
                       navr=navr, nwins=nwins, hop=hop, detrend_style=0)


# --------------------------------------------------------------------------- #
# Kernel E
# --------------------------------------------------------------------------- #

def _direct(nwins):
    """Whether kernel E transforms ``nwins``-sample segments directly: a
    power of two of at least 16 points (``fft_reg.cuh``'s smallest)."""
    return nwins >= 16 and nwins & (nwins - 1) == 0


def bluestein_size(nwins, nfreq=None):
    """Points of the FFTs kernel E runs for ``nwins``-sample segments.

    With ``nfreq`` (the kernel's plan): ``nwins`` itself for a power of two
    of at least 16, else the least power of two ``>= max(16, nwins + nfreq
    - 1)``, enough for the first ``nfreq`` bins.  Without it, the size for
    all ``nwins`` bins: ``nwins`` for a power of two, else the least power
    of two ``>= 2*nwins - 1``."""
    nwins = int(nwins)
    if nfreq is None:
        if nwins & (nwins - 1) == 0:
            return nwins
        return 1 << (2 * nwins - 2).bit_length()
    if _direct(nwins):
        return nwins
    return 1 << (max(16, nwins + int(nfreq) - 1) - 1).bit_length()


@lru_cache(maxsize=32)
def _chirp(nwins: int) -> np.ndarray:
    """``exp(-i pi n^2 / nwins)``, n < nwins, in float64 from the exact
    integer ``n^2 mod 2*nwins``."""
    n = np.arange(nwins, dtype=np.int64)
    return np.exp(-1j * np.pi * ((n * n) % (2 * nwins)) / nwins)


@lru_cache(maxsize=32)
def bluestein_tables(nwins: int, nfreq=None):
    """``(M, filt, post)`` in complex128 for Bluestein's algorithm on
    ``M = bluestein_size(nwins, nfreq)`` points: ``filt`` the M-point FFT
    of the chirp filter, ``conj(chirp[|m|])`` at ``m mod M`` for ``-(nwins
    - 1) < m < K``, and ``post = chirp[:K] / M``, ``K`` = ``nfreq``, or
    ``nwins`` without it.  For a ``(nwins,)`` segment ``v``, with ``a`` =
    ``v * chirp`` zero-padded to ``M``, ``post * conj(fft(conj(fft(a) *
    filt)))[:K]`` is the first ``K`` bins of ``fft(v)`` (kernel E's
    arithmetic)."""
    M = bluestein_size(nwins, nfreq)
    K = nwins if nfreq is None else int(nfreq)
    w = _chirp(nwins)
    b = np.zeros(M, dtype=np.complex128)
    b[:K] = np.conj(w[:K])
    if nwins > 1:
        b[M - nwins + 1:] = np.conj(w[1:][::-1])
    return M, np.fft.fft(b), w[:K] / M


@lru_cache(maxsize=16)
def _device_tables(nwins: int, nfreq: int, device: str):
    """Kernel E's constant operands on ``device``: ``(M, filt, post,
    twiddles)``; ``filt`` and ``post`` are None for a direct transform."""
    M = bluestein_size(nwins, nfreq)
    tw = _twiddles(M, device)
    if _direct(nwins):
        return M, None, None, tw
    _, filt, post = bluestein_tables(nwins, nfreq)
    return (M, torch.as_tensor(filt.astype(np.complex64), device=device),
            torch.as_tensor(post.astype(np.complex64), device=device), tw)


@lru_cache(maxsize=16)
def _pre_table(win_bytes: bytes, device: str) -> torch.Tensor:
    """Kernel E's ``pre`` operand on ``device``: the float64 window (as
    bytes) times the chirp, or the window alone for a direct transform, as
    complex64."""
    w = np.frombuffer(win_bytes, dtype=np.float64)
    pre = w if _direct(w.size) else w * _chirp(w.size)
    return torch.as_tensor(pre.astype(np.complex64), device=device)


def _chunks(nch, navr, nfreq, cap=None):
    """Kernel E's chunks, ``[(c0, nc, s0, ns), ...]`` in launch order:
    segments ``[s0, s0 + ns)`` of x and of channels ``[c0, c0 + nc)``.
    A chunk's scratch, ``(1 + nc) * ns`` spectra of ``nfreq`` complex64,
    holds at most ``cap`` bytes (at least x and one channel's spectrum of
    one segment): every channel in one group where one segment of every
    signal fits, and as many segments as fit.  ``cap``: ``SCRATCH_CAP``
    by default."""
    cap = SCRATCH_CAP if cap is None else cap
    spec = 8 * nfreq
    nc = max(1, min(nch, cap // spec - 1)) if nch else 0
    ns = max(1, min(navr, cap // (spec * (1 + nc))))
    return [(c0, min(nc, nch - c0), s0, min(ns, navr - s0))
            for c0 in range(0, max(nch, 1), max(nc, 1))
            for s0 in range(0, navr, ns)]


def _sum_split(ncols, ns, nfreq, sms):
    """Segments a group of kernel E's sums pass, for ``ncols`` columns,
    ``ns`` segments and ``nfreq`` bins on a card of ``sms`` SMs: at least
    16, and few enough that the blocks (32 bins of a column and a group
    each) number about 8 an SM where the segments allow."""
    blocks = -(-nfreq // 32) * ncols
    return max(16, -(-ns // -(-8 * sms // blocks)))


def _moments(rows):
    """float64 ``(sum x, sum (t - tbar) x)`` of each row of ``rows (R, nt)``
    (any strides along rows), ``tbar = (nt - 1) / 2``: float32 sums over
    blocks of 4096 samples of ``x`` and of ``(j - c) x`` (``c`` the block's
    centre), combined in float64."""
    R, nt = rows.shape
    tbar = (nt - 1) / 2.0
    m = nt - nt % _SUM_BLOCK
    nb = m // _SUM_BLOCK
    blocks = rows[:, :m].reshape(R, nb, _SUM_BLOCK)
    c = (_SUM_BLOCK - 1) / 2.0
    j = torch.arange(_SUM_BLOCK, dtype=rows.dtype, device=rows.device) - c
    centres = (torch.arange(nb, dtype=torch.float64, device=rows.device)
               * _SUM_BLOCK + c - tbar)
    s_blk = blocks.sum(-1).to(torch.float64)
    tail = rows[:, m:].to(torch.float64)
    t_tail = torch.arange(m, nt, dtype=torch.float64, device=rows.device)
    s0 = s_blk.sum(-1) + tail.sum(-1)
    s1 = ((s_blk * centres).sum(-1)
          + (blocks * j).sum(-1).to(torch.float64).sum(-1)
          + (tail * (t_tail - tbar)).sum(-1))
    return s0, s1


def _trend(rows, detrend_style):
    """float64 ``(mean, slope)`` of each row of ``rows (R, nt)`` for the
    kernel's on-load detrend ``x[t] - (mean + slope * (t - tbar))``."""
    R, nt = rows.shape
    zeros = torch.zeros(R, dtype=torch.float64, device=rows.device)
    if detrend_style == 0:
        return zeros, zeros
    if detrend_style > 0:
        return _row_sums(rows) / nt, zeros
    s0, s1 = _moments(rows)
    if nt < 2:
        return s0 / nt, zeros
    return s0 / nt, s1 / (nt * (nt * nt - 1) / 12.0)


def welch_dft_cuda(x, y, win, nfreq, norm, **kw):
    """:func:`_launch`'s block as ``(Pxx, Pyy, Pxy_re, Pxy_im)``."""
    return _split(_launch(x, y, win, nfreq, norm, **kw))


def _launch(x, y, win, nfreq, norm, *, navr, nwins, hop, detrend_style=1):
    """Launch kernel E; returns the result block.  ``x (nt,)`` contiguous
    and ``y (nch, nt)`` with unit stride along time, float32, on one CUDA
    device.  Raises outside the kernel's domain."""
    global LAUNCHES
    if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            and x.is_cuda and y.device == x.device):
        raise ValueError("welch_dft_cuda needs x and y on one CUDA device")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"welch_dft_cuda takes float32 signals, got "
                         f"{x.dtype} and {y.dtype}")
    if x.dim() != 1 or not x.is_contiguous() or y.dim() != 2 \
            or y.shape[1] != x.shape[0] or (y.shape[0] and y.stride(1) != 1):
        raise ValueError(
            f"welch_dft_cuda takes x (nt,) contiguous and y (nch, nt) with "
            f"unit time stride, got {tuple(x.shape)} and {tuple(y.shape)} "
            f"strides {tuple(y.stride())}")
    nt = x.shape[0]
    nch = y.shape[0]
    if not kernel_applicable(nwins, nfreq, hop, navr, detrend_style) \
            or nch + 1 > 65535:
        raise ValueError(
            f"welch dft kernel: unsupported geometry nwins={nwins} hop={hop} "
            f"navr={navr} nch={nch} nfreq={nfreq} detrend={detrend_style}")
    if (navr - 1) * hop + nwins > nt:
        raise ValueError(f"{navr} segments of {nwins} every {hop} do not "
                         f"fit {nt} samples")
    dev = x.device
    M, filt, post, tw = _device_tables(int(nwins), int(nfreq), str(dev))
    w = np.asarray(win, dtype=np.float64)
    if w.shape != (nwins,):
        raise ValueError(f"window of shape {w.shape}, need ({nwins},)")
    pre = _pre_table(w.tobytes(), str(dev))
    mx, sx = _trend(x[None], detrend_style)
    my, sy = _trend(y, detrend_style)
    mean = torch.cat([mx, my]).contiguous()
    slope = torch.cat([sx, sy]).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = [(c0, nc, s0, ns, _sum_split(1 + nc - (c0 > 0), ns, nfreq, sms))
            for c0, nc, s0, ns in _chunks(nch, navr, nfreq)]
    _, nc, _, ns, _ = plan[0]
    spec = torch.empty(((1 + nc) * ns, nfreq), dtype=torch.complex64,
                       device=dev)
    part = torch.empty(max(-(-ns // spg) * (1 + nc - (c0 > 0))
                           for c0, nc, _, ns, spg in plan) * 3 * nfreq,
                       dtype=torch.float64, device=dev)
    acc = (torch.empty((nch + 1, 3, nfreq), dtype=torch.float64, device=dev)
           if ns < navr else None)
    out = torch.empty((nch + 1, 3, nfreq), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c0, nc, s0, ns, spg in plan:
            rc = lib.pyfft_welch_dft(
                x.data_ptr(), y.data_ptr() if nch else x.data_ptr(),
                y.stride(0) if nch else 0, mean.data_ptr(), slope.data_ptr(),
                (nt - 1) / 2.0, pre.data_ptr(),
                filt.data_ptr() if filt is not None else None,
                post.data_ptr() if post is not None else None, tw.data_ptr(),
                spec.data_ptr(), part.data_ptr(),
                acc.data_ptr() if acc is not None else None, out.data_ptr(),
                nch, c0, nc, s0, ns, spg, int(navr), int(nwins), int(M),
                int(hop), int(nfreq), float(norm), stream)
            _build.check(rc, "welch dft kernel")
    LAUNCHES += 1
    return out


# --------------------------------------------------------------------------- #
# Entries (JAX package names)
# --------------------------------------------------------------------------- #

def _run(x, y, win, nfreq, norm, *, navr, nwins, hop, detrend_style):
    """The block of kernel E on CUDA tensors, else of its plain version."""
    kw = dict(navr=int(navr), nwins=int(nwins), hop=int(hop),
              detrend_style=int(detrend_style))
    if x.is_cuda:
        return _launch(x, y, win, int(nfreq), norm, **kw)
    if not kernel_applicable(nwins, nfreq, hop, navr, detrend_style):
        raise ValueError(
            f"welch dft kernel: unsupported geometry nwins={nwins} hop={hop} "
            f"navr={navr} nfreq={nfreq} detrend={detrend_style}")
    return _block(*welch_dft_plain(x, y, win, int(nfreq), norm, **kw))


def welch_pallas_fused(x, y, win, nfreq, norm, *, navr, nwins, noverlap,
                       detrend_style=1, device=None):
    """One-sided real-input Welch cross-powers (module docstring): global
    detrend, frames, summed one-sided cross-powers times ``norm``.
    Returns ``(Pxx (nfreq,), Pyy (nch, nfreq), Pxy_re, Pxy_im)`` as float32
    tensors on the input's device.  Raises ``ValueError`` outside kernel
    E's domain."""
    x, y = _signals(x, y, torch.float32, device)
    return _split(_run(x, y, win, nfreq, norm, navr=navr, nwins=nwins,
                       hop=int(nwins) - int(noverlap),
                       detrend_style=detrend_style))


def welch_power_pallas(xfr, yfr, win, nfreq, device=None):
    """Segment-summed one-sided cross-powers of pre-framed, un-windowed
    segments ``xfr (B, nwins)`` and ``yfr (nch, B, nwins)``: the same
    kernel with ``hop = nwins``, no detrend and ``norm = 1``.  The caller
    divides by ``navr`` and applies the one-sided scales."""
    dev = resolve_device(device, xfr, yfr)
    xfr = torch.as_tensor(xfr, device=dev)
    yfr = torch.as_tensor(yfr, device=dev)
    B, nwins = xfr.shape
    x, y = _signals(xfr.reshape(-1), yfr.reshape(yfr.shape[0], B * nwins),
                    torch.float32)
    return _split(_run(x, y, win, nfreq, 1.0, navr=B, nwins=nwins,
                       hop=nwins, detrend_style=0))
