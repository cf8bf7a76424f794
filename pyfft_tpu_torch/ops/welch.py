"""Fused FIR -> detrend -> Welch cross-powers: kernel B and its plain version.

Counterpart of :mod:`pyfft_tpu.ops.pallas_welch3` (``welch_fir_pallas3``,
``welch_pallas3_twosided``) and of the entry ``welch_fir_pallas_fused`` of
:mod:`pyfft_tpu.ops.pallas_welch`.  Contract, as in the JAX package:
``x (nt,)`` reference and ``y (nch, nt)`` channels; optional causal
``taps`` (``np.convolve(sig, taps, 'full')[:nt]``) on every signal; the
global mean of each *filtered* signal removed (``detrend_style`` 1) or not
(0); Hann-or-any ``win`` on ``navr`` segments of ``nwins`` samples every
``hop``; returns ``(Pxx, Pyy, Pxy_re, Pxy_im)`` summed over segments and
scaled by ``norm``, with ``Pxy = Y conj(X)``.  The caller applies the
one-sided bin doubling.  ``_run`` returns the kernels' ``(1 + nch, 3,
nfreq)`` result block (row 0 ``Pxx``, row ``1 + c`` channel ``c``'s
``Pyy``, ``Pxy_re``, ``Pxy_im``); ``_split`` cuts it into the four.

- On CUDA tensors :func:`welch_cuda` launches kernel B, both of its
  kernels on ``csrc/fft_reg.cuh``: real signals ``csrc/welch_pair.cu`` (x
  paired with each channel in one complex FFT, each sequence scaled by its
  own power of two, each span filtered once per block), complex ones
  ``csrc/welch.cu`` (one segment a transform, x's and a channel's
  segment transformed side by side in one block).  The filtered channels
  never reach device memory.  With two or more real channels and a filter
  (:func:`_prefilters_x`; not kernel H) the wrapper first filters x alone
  with kernel A (``csrc/fir.cu``) into a scratch row that kernel B's
  channel blocks read, so x is filtered once a call, not once per
  channel, with the same bits.  The per-signal means of
  the filtered signals come from the unfiltered sums by the moment
  identity ``sum(conv(x, t)[:nt]) = sum_k t_k (S - T_k)`` (``T_k`` the sum
  of the last ``k`` samples), in float64, as the JAX package computes it
  in XLA outside its kernel: on the card two float32 block sums (x's and
  y's) and the means kernel (``csrc/means.cu``, one launch for every
  signal), the call's first device work; :func:`_means_plain` is the same
  arithmetic in torch, which CPU tensors run.  The window and the taps go
  to the card once per (content, device): after the first call with
  them, a call copies nothing from the host.
- On CPU tensors :func:`welch_plain` runs: ``fir_plain`` -> mean ->
  frames -> window -> ``torch.fft.fft`` -> sums, in the input's dtype.
- ``welch_cuda(..., packed=True)`` is kernel H (the packed entries of
  :mod:`pyfft_tpu_torch.ops.welch_packed`): the same real kernel for one
  real signal (two of its segments per complex FFT) or one real pair.

``LAUNCHES`` counts the launches of kernel B on real signals,
``COMPLEX_LAUNCHES`` those on complex signals and ``PACKED_LAUNCHES``
those of kernel H; ``X_PREFILTERS`` the calls that filtered x ahead (each
also a launch of kernel A in ``ops.fir.LAUNCHES``); ``MEANS_LAUNCHES`` the
calls whose means came from the means kernel.  In a
``torch.profiler`` trace :func:`welch_cuda` marks two ranges
(:class:`pyfft_tpu_torch.utils.profiling.stage`), for kernels B and H
alike: ``welch_cuda.prologue``, the argument checks and the enqueue of
the means (three device operations, none waited on), and
``welch_cuda.launch``, the window, taps and twiddles lookups, the
library, the buffers, the launch and the mirrored bins; inside the
latter ``welch_cuda.x_filter`` holds kernel A's enqueue where x is
filtered ahead.  The entries compute on the port's device
(:func:`pyfft_tpu_torch.config.resolve_device`): ``device=``, else the
first tensor argument's, else the package default, else the card.

Domain of the kernel (re-derived for the card; the TPU's lane and VMEM
limits do not apply): ``nwins`` a power of two in 16..16384, any hop in
1..nwins, any ``nt >= (navr-1)*hop + nwins``, any ``nch >= 0`` (up to
65534), up to 1024 taps, ``detrend_style`` in {0, 1}, real float32 or
complex64 (two-sided) signals.  Its shared memory is at most 209 KB a
block (real, ``nwins`` 8192 with 1024 taps) and 217 KB (complex, the same
geometry).

Kernel B also stands for TPU kernel #8, the v2 factored kernel
(``pallas_welch.py::_factored_kernel``), which the JAX package's
``welch_fir_pallas_fused`` runs where TPU kernel #1's gate fails and its
``_v2_geometry`` holds (e.g. nwins 2048 every 128 samples): every such
geometry is inside kernel B's domain (``tests/test_torch_welch_v2.py``
holds that against the JAX gate).  The port keeps the global-mean contract
there, where the JAX v2 kernel removes each segment's own mean (ROADMAP
Queue 3).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _build
from . import fir as _fir
from ..config import resolve_device
from ..utils.profiling import stage
from .fir import fir_plain, PALLAS_FIR_MAX_TAPS

__all__ = ["welch_fir_pallas3", "welch_fir_pallas_fused",
           "welch_pallas3_twosided", "pallas_welch2_applicable",
           "welch_plain", "welch_cuda", "LAUNCHES", "COMPLEX_LAUNCHES",
           "PACKED_LAUNCHES", "X_PREFILTERS", "MEANS_LAUNCHES"]

_MIN_NWINS = 16
_MAX_NWINS = 16384

LAUNCHES = 0
COMPLEX_LAUNCHES = 0
PACKED_LAUNCHES = 0
X_PREFILTERS = 0
MEANS_LAUNCHES = 0


# --------------------------------------------------------------------------- #
# Applicability (pure functions of shapes and flags)
# --------------------------------------------------------------------------- #

def _in_domain(nwins, noverlap, navr, taps=None, detrend_style=1):
    nwins = int(nwins)
    hop = nwins - int(noverlap)
    ntaps = 1 if taps is None else int(np.size(taps))
    return (detrend_style in (0, 1)
            and _MIN_NWINS <= nwins <= _MAX_NWINS
            and nwins & (nwins - 1) == 0
            and 1 <= hop <= nwins
            and int(navr) >= 1
            and 1 <= ntaps <= PALLAS_FIR_MAX_TAPS)


def pallas_welch2_applicable(nwins, noverlap, navr, nch=8, taps=None,
                             detrend_style=1):
    """Whether kernel B (:func:`welch_fir_pallas_fused`, and
    :func:`welch_pallas3_twosided` for complex signals) takes this
    configuration.  ``nch`` is accepted for the JAX signature; the kernel
    takes any count."""
    return _in_domain(nwins, noverlap, navr, taps, detrend_style)


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #

def welch_plain(x, y, win, nfreq, norm, *, navr, nwins, hop, taps=None,
                detrend_style=1):
    """Plain PyTorch version of kernel B, in the inputs' dtype.

    ``x (nt,)``, ``y (nch, nt)`` real or complex; returns the first
    ``nfreq`` bins of ``(Pxx, Pyy, Pxy_re, Pxy_im)`` times ``norm``.
    Segments go through ``torch.fft.fft`` in chunks that keep the framed
    copy near 2**25 elements.
    """
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    if y.dim() == 1:
        y = y[None]
    dtype = torch.promote_types(x.dtype, y.dtype)
    sig = torch.cat([x[None].to(dtype), y.to(dtype)])
    if taps is not None:
        sig = fir_plain(sig, taps)
    if detrend_style == 1:
        sig = sig - sig.mean(dim=-1, keepdim=True)
    real = sig.real.dtype if sig.is_complex() else sig.dtype
    w = torch.as_tensor(np.asarray(win), dtype=real, device=sig.device)
    frames = sig.unfold(-1, nwins, hop)                 # (C, nseg, nwins)
    if frames.shape[1] < navr:
        raise ValueError(f"{navr} segments of {nwins} every {hop} do not "
                         f"fit {sig.shape[-1]} samples")
    C = sig.shape[0]
    Pxx = torch.zeros(nfreq, dtype=real, device=sig.device)
    Pyy = torch.zeros(C - 1, nfreq, dtype=real, device=sig.device)
    Pxy = torch.zeros(C - 1, nfreq, dtype=torch.promote_types(
        real, torch.complex64), device=sig.device)
    chunk = max(1, (1 << 25) // (C * nwins))
    for s0 in range(0, navr, chunk):
        Z = torch.fft.fft(frames[:, s0:min(navr, s0 + chunk)] * w,
                          dim=-1)[..., :nfreq]
        X, Y = Z[0], Z[1:]
        Pxx += (X.real ** 2 + X.imag ** 2).sum(0)
        Pyy += (Y.real ** 2 + Y.imag ** 2).sum(1)
        Pxy += (Y * X.conj()).sum(1)
    return Pxx * norm, Pyy * norm, Pxy.real * norm, Pxy.imag * norm


# --------------------------------------------------------------------------- #
# Kernel B
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=None)
def _twiddles(nwins: int, device: str) -> torch.Tensor:
    """``exp(-2 pi i m / nwins)``, m < nwins/2, from float64, as float32
    (re, im) pairs."""
    ang = -2.0 * np.pi * np.arange(nwins // 2) / nwins
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.as_tensor(tw, device=device)


_SUM_BLOCK = 4096


def _block_sums(rows: torch.Tensor) -> torch.Tensor:
    """The float32 (complex64) sums of the whole blocks of 4096 samples of
    each row of ``rows (R, nt)``: :func:`_row_sums`' first step, and what
    the means kernel is fed."""
    m = rows.shape[-1] - rows.shape[-1] % _SUM_BLOCK
    return rows[:, :m].reshape(rows.shape[0], m // _SUM_BLOCK,
                               _SUM_BLOCK).sum(-1)


def _row_sums(rows: torch.Tensor) -> torch.Tensor:
    """float64 (complex128 for complex rows) sums of the rows of ``rows
    (R, nt)``: float32 sums of blocks of 4096 samples (a view of
    ``rows``), then float64 over the blocks.  ``sum(dtype=float64)`` would
    cast a float64 copy of the whole signal first."""
    wide = torch.complex128 if rows.is_complex() else torch.float64
    m = rows.shape[-1] - rows.shape[-1] % _SUM_BLOCK
    return _block_sums(rows).to(wide).sum(-1) + rows[:, m:].to(wide).sum(-1)


@lru_cache(maxsize=32)
def _device_copy(data: bytes, dtype: str, device: str) -> torch.Tensor:
    """The array whose bytes are ``data``, as ``torch.<dtype>`` on
    ``device`` (one host -> device copy per content, type and device)."""
    return torch.frombuffer(bytearray(data),
                            dtype=getattr(torch, dtype)).to(device)


def _window(data: bytes, device: str) -> torch.Tensor:
    """The float32 window whose bytes are ``data``, on ``device``."""
    return _device_copy(data, "float32", device)


def _moment_means(rows: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """float64 (complex128) means of ``conv(row, taps, 'full')[:nt]`` for
    each row of real (complex) ``rows (R, nt)`` (any strides), from the
    unfiltered sums.  A single tap is a scalar factor; longer taps are
    cached on the rows' device."""
    nt = rows.shape[-1]
    K = taps.size
    S = _row_sums(rows)
    if K == 1:
        return S * float(taps.flat[0]) / nt
    t = _device_copy(np.ascontiguousarray(taps, np.float64).tobytes(),
                     "float64", str(rows.device))
    tail = rows[:, max(0, nt - (K - 1)):].flip(-1).to(S.dtype)
    tail = torch.nn.functional.pad(tail, (0, K - 1 - tail.shape[-1]))
    T = torch.cat([torch.zeros_like(S)[:, None], torch.cumsum(tail, -1)], -1)
    return ((S[:, None] - T) @ t.to(S.dtype)) / nt


def _means_plain(x, y, taps, detrend_style, cplx):
    """Kernel B's ``means`` operand: one value per signal (re, im pairs
    for complex signals), reference first, in torch (the means kernel's
    plain version)."""
    n = (1 + y.shape[0]) * (2 if cplx else 1)
    if detrend_style != 1:
        return torch.zeros(n, dtype=torch.float32, device=x.device)
    parts = []
    for sig in (x[None], y):
        m = _moment_means(sig, taps)
        parts.append(torch.view_as_real(m).reshape(-1) if cplx else m)
    return torch.cat(parts).to(torch.float32)


def _means(x, y, taps, detrend_style, cplx):
    """:func:`_means_plain`'s operand; with mean detrend on CUDA tensors
    from the means kernel (``csrc/means.cu``): the float32 block sums of x
    and of y, then one launch for every signal, nothing that waits on the
    card."""
    global MEANS_LAUNCHES
    if detrend_style != 1 or not x.is_cuda:
        return _means_plain(x, y, taps, detrend_style, cplx)
    nch = y.shape[0]
    x_blk = _block_sums(x[None])
    y_blk = _block_sums(y) if nch else x_blk
    dev = x.device
    t = _device_copy(np.ascontiguousarray(taps, np.float64).tobytes(),
                     "float64", str(dev))
    parts = 2 if cplx else 1
    means = torch.empty((1 + nch) * parts, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.pyfft_welch_means(
            x.data_ptr(), (y if nch else x).data_ptr(),
            y.stride(0) * parts if nch else 0, x_blk.data_ptr(),
            y_blk.data_ptr(), x.shape[0], t.data_ptr(), int(taps.size), nch,
            parts, means.data_ptr(), stream), "means kernel")
    MEANS_LAUNCHES += 1
    return means


def _pair_groups(navr: int, nch: int, resident: int) -> int:
    """Segment groups of ``csrc/welch_pair.cu`` and ``csrc/welch.cu``: at
    most one item (group x channel) per block the card holds at once, at
    most one unit a group; a unit is a segment, or two at ``nch = 0``."""
    nunits = navr if nch else -(-navr // 2)
    return max(1, min(nunits, resident // max(nch, 1)))


def _prefilters_x(nch: int, K: int, cplx: bool, packed: bool) -> bool:
    """Whether :func:`welch_cuda` filters x once with kernel A ahead of
    kernel B: real signals, two or more channels (at one channel x is
    filtered once already), a filter of two or more taps, not kernel H."""
    return not cplx and not packed and nch >= 2 and K >= 2


def _block(Pxx, Pyy, Pr, Pi) -> torch.Tensor:
    """The four outputs as the kernels' ``(1 + nch, 3, nfreq)`` block."""
    zero = torch.zeros_like(Pxx)
    return torch.cat([torch.stack([Pxx, zero, zero])[None],
                      torch.stack([Pyy, Pr, Pi], dim=1)])


def _split(block: torch.Tensor):
    """``(Pxx, Pyy, Pxy_re, Pxy_im)`` of a result block, as views."""
    return block[0, 0], block[1:, 0], block[1:, 1], block[1:, 2]


def _mirror(out: torch.Tensor, nwins: int, nfreq: int) -> torch.Tensor:
    """Bins ``nwins/2+1 .. nfreq-1`` of real signals' powers ``out (C, 3,
    nwins/2+1)`` from their mirror images: ``P[N-k] = P[k]`` and ``Im
    Pxy[N-k] = -Im Pxy[k]`` (row 2)."""
    if nfreq <= out.shape[-1]:
        return out
    tail = out[..., nwins - nfreq + 1:nwins // 2].flip(-1)
    tail = torch.cat([tail[..., :2, :], -tail[..., 2:, :]], dim=-2)
    return torch.cat([out, tail], dim=-1)


def welch_cuda(x, y, win, nfreq, norm, **kw):
    """:func:`_launch`'s block as ``(Pxx, Pyy, Pxy_re, Pxy_im)``."""
    return _split(_launch(x, y, win, nfreq, norm, **kw))


def _launch(x, y, win, nfreq, norm, *, navr, nwins, hop, taps=None,
            detrend_style=1, packed=False):
    """Launch kernel B, or with ``packed`` kernel H; returns the result
    block.  ``x (nt,)`` contiguous and ``y (nch, nt)`` with unit stride
    along time, both float32 (one-sided use) or both complex64
    (two-sided), on one CUDA device; ``packed`` takes float32 and ``nch <=
    1``.  Raises outside the kernel's domain."""
    global LAUNCHES, COMPLEX_LAUNCHES, PACKED_LAUNCHES, X_PREFILTERS
    with stage("welch_cuda.prologue"):
        if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                and x.is_cuda and y.device == x.device):
            raise ValueError("welch_cuda needs x and y on one CUDA device")
        cplx = x.is_complex()
        want = torch.complex64 if cplx else torch.float32
        if x.dtype != want or y.dtype != want:
            raise ValueError(f"welch_cuda takes float32 or complex64 pairs, "
                             f"got {x.dtype} and {y.dtype}")
        if x.dim() != 1 or not x.is_contiguous() or y.dim() != 2 \
                or y.shape[1] != x.shape[0] \
                or (y.shape[0] and y.stride(1) != 1):
            raise ValueError(
                f"welch_cuda takes x (nt,) contiguous and y (nch, nt) with "
                f"unit time stride, got {tuple(x.shape)} and "
                f"{tuple(y.shape)} strides {tuple(y.stride())}")
        nt = x.shape[0]
        nch = y.shape[0]
        noverlap = nwins - hop
        if not _in_domain(nwins, noverlap, navr, taps, detrend_style) \
                or nch + 1 > 65535 or not 1 <= nfreq <= nwins \
                or (packed and (cplx or nch > 1)):
            raise ValueError(
                f"welch kernel: unsupported geometry nwins={nwins} hop={hop} "
                f"navr={navr} nch={nch} nfreq={nfreq} detrend={detrend_style} "
                f"packed={packed} complex={cplx}")
        if (navr - 1) * hop + nwins > nt:
            raise ValueError(f"{navr} segments of {nwins} every {hop} do not "
                             f"fit {nt} samples")
        taps64 = (np.ones(1) if taps is None
                  else np.asarray(taps, dtype=np.float64).ravel())
        # the card's first work of the call: the rest is enqueued meanwhile
        means = _means(x, y, taps64, detrend_style, cplx)
        win32 = np.ascontiguousarray(np.asarray(win), dtype=np.float32)
        if win32.shape != (nwins,):
            raise ValueError(f"window of shape {win32.shape}, need ({nwins},)")
        dev = x.device
    with stage("welch_cuda.launch"):
        w = _window(win32.tobytes(), str(dev))
        t = _device_copy(taps64.astype(np.float32).tobytes(), "float32",
                         str(dev))
        K = int(taps64.size)
        tw = _twiddles(int(nwins), str(dev))
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            # complex signals: every bin; real ones: bins 0..nwins/2, the
            # rest mirrored
            name, entry, resident = (
                ("welch", lib.pyfft_welch, lib.pyfft_welch_resident) if cplx
                else ("welch_pair", lib.pyfft_welch_pair,
                      lib.pyfft_welch_pair_resident))
            nbins = nfreq if cplx else min(nfreq, nwins // 2 + 1)
            cap = resident(int(nwins), K)
            if cap < 0:
                _build.check(-cap, f"{name} kernel")
            ngroups = _pair_groups(int(navr), nch, cap)
            part = torch.empty((ngroups, nch + 1, 3, nbins),
                               dtype=torch.float64, device=dev)
            out = torch.empty((nch + 1, 3, nbins), dtype=torch.float32,
                              device=dev)
            # row stride in floats (a complex64 element is two)
            y_stride = y.stride(0) * (2 if cplx else 1) if nch else 0
            xf = None
            if _prefilters_x(nch, K, cplx, packed):
                with stage("welch_cuda.x_filter"):
                    xf = torch.empty_like(x)
                    _build.check(lib.pyfft_fir(
                        x.data_ptr(), t.data_ptr(), xf.data_ptr(), 1, nt, K,
                        stream), "fir kernel")
                    _fir.LAUNCHES += 1
                    X_PREFILTERS += 1
            # the real kernel takes x filtered ahead, or null
            xs = ((x.data_ptr(),) if cplx else
                  (x.data_ptr(), None if xf is None else xf.data_ptr()))
            rc = entry(*xs, y.data_ptr() if nch else x.data_ptr(),
                       y_stride, t.data_ptr(), K, means.data_ptr(),
                       w.data_ptr(), tw.data_ptr(), part.data_ptr(),
                       out.data_ptr(), nch,
                       int(nwins), int(hop), int(navr), ngroups, nbins,
                       float(norm), stream)
            _build.check(rc, f"{name} kernel")
            if not cplx:
                out = _mirror(out, int(nwins), int(nfreq))
        if packed:
            PACKED_LAUNCHES += 1
        elif cplx:
            COMPLEX_LAUNCHES += 1
        else:
            LAUNCHES += 1
        return out


# --------------------------------------------------------------------------- #
# Entries (JAX package names)
# --------------------------------------------------------------------------- #

def _signals(x, y, dtype, device=None):
    """``x`` and ``y`` as tensors of ``dtype`` on the device the entry
    computes on (``resolve_device``); ``y`` as ``(nch, nt)`` rows."""
    dev = resolve_device(device, x, y)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    if y.dim() == 1:
        y = y[None]
    x = x.to(dtype).contiguous()
    y = y.to(dtype)
    if y.shape[0] and y.stride(-1) != 1:
        y = y.contiguous()
    return x, y


def _run(x, y, win, nfreq, norm, *, navr, nwins, hop, taps, detrend_style,
         packed=False):
    """The block of kernel B (kernel H with ``packed``) on CUDA tensors,
    else of the plain version, which is both kernels' plain version."""
    kw = dict(navr=int(navr), nwins=int(nwins), hop=int(hop), taps=taps,
              detrend_style=int(detrend_style))
    if x.is_cuda:
        return _launch(x, y, win, nfreq, norm, packed=packed, **kw)
    return _block(*welch_plain(x, y, win, nfreq, norm, **kw))


def welch_fir_pallas3(x, y, win, nfreq, norm, *, navr, nwins, noverlap,
                      taps=None, detrend_style=1, device=None):
    """One-sided Welch cross-powers of real signals with an optional fused
    FIR (module docstring).  Signals are cast to float32, as the JAX kernel
    casts them; returns ``(Pxx (nfreq,), Pyy (nch, nfreq), Pxy_re,
    Pxy_im)``.  Raises ``ValueError`` outside the kernel's domain."""
    if not _in_domain(nwins, noverlap, navr, taps, detrend_style):
        raise ValueError(
            f"welch kernel: unsupported geometry nwins={nwins} "
            f"noverlap={noverlap} navr={navr} detrend={detrend_style}")
    x, y = _signals(x, y, torch.float32, device)
    return _split(_run(x, y, win, int(nfreq), norm, navr=navr, nwins=nwins,
                       hop=nwins - noverlap, taps=taps,
                       detrend_style=detrend_style))


# The JAX package's v2 entry, which runs TPU kernel #1 wherever it applies
# and TPU kernel #8 at the other v2 geometries; kernel B covers both domains
# with the documented global-mean detrend.
welch_fir_pallas_fused = welch_fir_pallas3


def welch_pallas3_twosided(x, y, win, norm, *, navr, nwins, noverlap,
                           taps=None, detrend_style=1, device=None):
    """Two-sided Welch cross-powers of complex signals (the Doppler IQ
    configuration): ``x (nt,)``, ``y (nchz, nt)`` cast to complex64; returns
    ``(Pxx (nwins,), Pyy (nchz, nwins), Pxy_re, Pxy_im)`` in natural DFT
    bin order (callers apply ``fftshift``), scaled by ``norm``."""
    if not _in_domain(nwins, noverlap, navr, taps, detrend_style):
        raise ValueError(
            f"welch two-sided kernel: unsupported geometry nwins={nwins} "
            f"noverlap={noverlap} navr={navr} detrend={detrend_style}")
    x, y = _signals(x, y, torch.complex64, device)
    return _split(_run(x, y, win, int(nwins), norm, navr=navr, nwins=nwins,
                       hop=nwins - noverlap, taps=taps,
                       detrend_style=detrend_style))
