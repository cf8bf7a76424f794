"""Welch-averaged auto-/cross-spectral estimation on PyTorch.

Counterpart of :mod:`pyfft_tpu.spectral` (the role of the reference's
``fft_pwelch``, reference ``fft_analysis.py:36-791``):

* the per-segment loop becomes one batched ``frame -> window -> FFT ->
  power`` pipeline on the input's device;
* two transform paths, named as in the JAX package:
  - ``'xla'`` (alias ``'mxu'``): ``torch.fft`` on frames (complex input
    handled natively), keeping the per-segment arrays;
  - ``'pallas'``: the kernel the JAX package's gates pick
    (:func:`pallas_route`), on CUDA tensors, or its plain version on CPU
    tensors: kernel B (:mod:`pyfft_tpu_torch.ops.welch`; power-of-two
    ``nwins`` 16..16384, mean or no detrend) for one-sided real and
    two-sided complex input, else kernel E
    (:mod:`pyfft_tpu_torch.ops.welch_v1`; any ``nwins`` that TPU kernel
    #7 tiles, up to 5452, and linear detrend) for one-sided real input.
    With ``PYFFT_PACKED=1`` in the environment (read at each call), a
    one-sided real pair (one channel) whose ``packed_pair_geometry``
    holds takes kernel H (:mod:`pyfft_tpu_torch.ops.welch_packed`)
    instead, as the JAX package takes its packed kernel there (the
    opt-in keeps the routes the JAX package's; on the card kernel H's
    kernel is the faster at one channel).  Where no
    gate holds it takes the ``'xla'`` core, as the JAX package takes
    ``'mxu'``;
* the O(nfreq) finalization (coherence, variances, amplitude spectra,
  lag-domain correlations) runs on the host in float64 NumPy, as in the
  JAX package;
* the normalization contract is bin-for-bin the reference's: one-sided
  energy doubling of interior bins, ``1/S1^2`` then ``1/ENBW`` scaling,
  Bendat'78 coherence variance, lag-domain correlations.

Device (:func:`pyfft_tpu_torch.config.resolve_device`): ``device=`` when
it is given, else the first tensor argument's device, else the package
default (``config.set_default_device``), else ``cuda``; without a card
that last step raises, so the CPU runs only when asked for.

In a ``torch.profiler`` trace, ``fft_pwelch`` marks two ranges
(:class:`pyfft_tpu_torch.utils.profiling.stage`): ``fft_pwelch.h2d``, the
inputs to their device, and ``fft_pwelch.device_core``, the transform path
up to the averaged spectra on the host; the rest of the call is the host
finalization.  ``welch_filtered_cross_spectra`` marks the whole call with
its own name and, inside it, ``welch_filtered_cross_spectra.args`` (the
device, the tensors, the taps and window as NumPy, S1 and ENBW) and, on
the kernel path, ``welch_filtered_cross_spectra.finalize`` (the one copy
of the result block back, ``Pxy`` and ``freq``); between the two, the
kernel core (:func:`_welch_core_pallas`), where kernel B's wrapper marks
``welch_cuda.prologue`` and ``welch_cuda.launch`` (with
``welch_cuda.x_filter`` inside where x is filtered ahead;
:mod:`pyfft_tpu_torch.ops.welch`).  Each copy of a tensor off the CPU to
the host (``config._np``) is a ``copy.d2h`` range, with its wait.  Without
a running profiler no range is opened.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from .config import _np, _tensor, resolve_device
from .filters import _fir_filter
from .ops import welch, welch_v1
from .ops.fir import PALLAS_FIR_MAX_TAPS
from .ops.welch_packed import packed_pair_geometry
from .utils.structure import Struct
from .utils.detrend import detrend_func
from .utils.profiling import stage
from .windows import windows
from . import segmentation as seg


__all__ = ["fft_pwelch", "fftinfosc", "Cxy_Cxy2", "welch_cross_spectra",
           "welch_filtered_cross_spectra", "csd_oracle",
           "backend_supports_complex", "resolve_fft_backend", "pallas_route"]


def backend_supports_complex() -> bool:
    """True: ``torch.fft`` and complex tensors work on every torch device
    (the JAX package's TPU backend is the one without them)."""
    return True


def resolve_fft_backend(fft_backend=None) -> str:
    """Resolve 'auto'/None to a concrete transform path: 'xla'
    (``torch.fft``, which handles complex data on every device)."""
    if fft_backend in ("xla", "mxu", "pallas"):
        return fft_backend
    return "xla"


# --------------------------------------------------------------------------- #
# Output schema (reference fft_analysis.py:796-828)
# --------------------------------------------------------------------------- #

_SEGMENT_FIELDS = ("Pxx_seg", "Pyy_seg", "Pxy_seg", "Xfft_seg", "Yfft_seg",
                   "phixy_seg", "varphi_seg")


class fftinfosc(Struct):
    """Result container with the reference's output schema.

    Field list mirrors reference ``fftinfosc`` (``fft_analysis.py:796-828``):
    window norms (S1, S2, NENBW, ENBW), averaged spectra, coherence/phase with
    propagated variances, linear amplitude spectra, and per-segment arrays.

    The fused-kernel fast path does not materialize the
    per-segment arrays (``Pxx_seg``/``Xfft_seg``/…, reference
    ``fft_analysis.py:391-393``) during the hot dispatch; instead the first
    attribute access transparently recomputes them with the generic batched
    backend (one extra device pass over the retained inputs), so reference
    code consuming ``fftinfo.Pxx_seg`` keeps working.
    """

    def _defer_segments(self, fill):
        """Arm lazy per-segment computation: drop the fields and install a
        one-shot ``fill(info)`` callback run on first access."""
        for f in _SEGMENT_FIELDS:
            self.__dict__.pop(f, None)
        self.__dict__["_lazy_segments"] = fill

    def __getattr__(self, name):
        # only reached when ``name`` is NOT in the instance dict
        if name in _SEGMENT_FIELDS:
            fill = self.__dict__.pop("_lazy_segments", None)
            if fill is not None:
                fill(self)
                return self.__dict__[name]
            raise AttributeError(
                f"fftinfo.{name} is not available: this result came from a "
                "fast path (the fused Welch kernel) that does "
                "not keep per-segment arrays, and the inputs were not "
                "retained for recomputation.  Re-run fft_pwelch with "
                "fft_backend='xla' to populate them.")
        raise AttributeError(
            f"{type(self).__name__!s} object has no attribute {name!r}")

    def __init__(self):
        self.S1 = None
        self.S2 = None
        self.NENBW = None
        self.ENBW = None
        self.freq = None
        self.Pxx = None
        self.Pyy = None
        self.Pxy = None
        self.Cxy = None
        self.varcoh = None
        self.phi_xy = None
        self.varphi = None
        self.Lxx = None
        self.Lyy = None
        self.Lxy = None
        self.varLxx = None
        self.varLyy = None
        self.varLxy = None
        self.Pxx_seg = None
        self.Pyy_seg = None
        self.Pxy_seg = None
        self.Xfft_seg = None
        self.Yfft_seg = None


# --------------------------------------------------------------------------- #
# Coherence (reference fft_analysis.py:1662-1688)
# --------------------------------------------------------------------------- #

def Cxy_Cxy2(Pxx, Pyy, Pxy, ibg=None):
    """Complex coherence and mean-squared coherence (host, NumPy).

    ``Cxy = Pxy / sqrt(|Pxx| |Pyy|)``; ``Cxy2 = Pxy conj(Pxy)/(|Pxx||Pyy|)``
    (reference ``fft_analysis.py:1672-1677``).  With ``ibg`` given, returns
    the imaginary coherence and background-subtracted coherence instead
    (reference ``:1683-1688``).
    """
    Pxx = np.asarray(Pxx)
    Pyy = np.asarray(Pyy)
    Pxy = np.asarray(Pxy)
    if Pxx.ndim < Pyy.ndim:
        Pxx = Pxx.reshape(Pxx.shape + (1,) * (Pyy.ndim - Pxx.ndim))
    denom = np.abs(Pxx) * np.abs(Pyy)
    # zero-power bins yield NaN coherence, exactly like the reference —
    # intentional, so don't let numpy warn about the 0/0
    with np.errstate(invalid="ignore", divide="ignore"):
        Cxy2 = Pxy * np.conj(Pxy) / denom
        Cxy = Pxy / np.sqrt(denom)
    if ibg is None:
        return Cxy, Cxy2
    iCxy = np.imag(Cxy) / (1.0 - np.real(Cxy))
    bg = np.mean(Cxy[:, ibg], axis=-1, keepdims=True)
    Cprime = np.real(Cxy - bg) / (1.0 - np.real(Cxy - bg))
    return iCxy, Cprime


# --------------------------------------------------------------------------- #
# One-sided bin-scaling vectors
# --------------------------------------------------------------------------- #

def _onesided_power_scale(nfft: int, nnyquist: int) -> np.ndarray:
    """Energy-doubling vector for one-sided *power* spectra.

    Reproduces reference ``fft_analysis.py:414-421``: interior bins doubled
    via ``[1:-1]`` on the retained array, plus the last retained bin when
    ``nfft`` is odd.
    """
    s = np.ones(nnyquist)
    s[1:-1] = 2.0
    if nfft % 2:
        s[-1] = 2.0
    return s


@lru_cache(maxsize=None)
def _power_scale_on(nfft: int, nnyquist: int, device: str,
                    dtype=torch.float32) -> torch.Tensor:
    """:func:`_onesided_power_scale` as ``dtype`` on ``device``, copied
    there once per geometry."""
    return torch.as_tensor(_onesided_power_scale(nfft, nnyquist),
                           dtype=dtype, device=device)


def _fold_bins(P, nfft, nnyquist, onesided):
    """Power spectra ``P`` (bins last) as the paths return them: the first
    ``nnyquist`` bins with the one-sided doubling, or all ``fftshift``-ed.
    The doubling is exact, so where it runs does not change the bits."""
    if onesided:
        return P[..., :nnyquist] * _power_scale_on(
            nfft, nnyquist, str(P.device), P.real.dtype)
    return torch.fft.fftshift(P, dim=-1)


def _onesided_amp_scale(nfft: int, nnyquist: int) -> np.ndarray:
    """sqrt(2) doubling for one-sided *amplitude* (FFT-coefficient) spectra.

    Reproduces reference ``fft_analysis.py:2186-2189`` (``fft_win``).
    """
    s = np.ones(nnyquist)
    s[1:-1] = np.sqrt(2.0)
    if nfft % 2:
        s[-1] = np.sqrt(2.0)
    return s


# --------------------------------------------------------------------------- #
# Segment pipelines (device side)
# --------------------------------------------------------------------------- #

def _welch_core_xla(x, y, win, s1sq_enbw, *, navr, nwins, noverlap,
                    nfft, nnyquist, onesided, detrend_style, ntmodel):
    """``torch.fft`` Welch segment spectra.

    Inputs: ``x (nt,)``, ``y (nch, nt)`` tensors on one device, ``win
    (nwins,)`` NumPy, ``s1sq_enbw = S1^2 * ENBW``.  Returns tensors.
    """
    det = detrend_func(detrend_style)
    x = det(x, axis=-1)
    y = det(y, axis=-1)
    hop = nwins - noverlap

    if ntmodel:
        xfr = x[None, :nwins]
    else:
        xfr = seg.frame_signal(x, nwins, hop, navr)          # (navr, nwins)
    yfr = seg.frame_signal(y, nwins, hop, navr)              # (nch, navr, nwins)

    real = xfr.real.dtype if xfr.is_complex() else xfr.dtype
    w = torch.as_tensor(np.asarray(win), dtype=real, device=x.device)
    X = torch.fft.fft(xfr * w, n=nfft, dim=-1)
    Y = torch.fft.fft(yfr * w, n=nfft, dim=-1)
    if ntmodel:
        X = X.expand(navr, nfft)

    Pxx = X * X.conj()                                       # (navr, nfft)
    Pyy = Y * Y.conj()                                       # (nch, navr, nfft)
    Pxy = Y * X.conj()                                       # (nch, navr, nfft)

    norm = 1.0 / s1sq_enbw
    Pxx, Pyy, Pxy = (_fold_bins(P, nfft, nnyquist, onesided) * norm
                     for P in (Pxx, Pyy, Pxy))

    return dict(Pxx_seg=Pxx, Pyy_seg=Pyy, Pxy_seg=Pxy,
                Xfft_seg=X, Yfft_seg=Y,
                Pxx=Pxx.mean(dim=0),
                Pyy=Pyy.mean(dim=1).T,
                Pxy=Pxy.mean(dim=1).T)


def pallas_route(*, nwins, noverlap, navr, nnyquist, onesided,
                 detrend_style, ntmodel, is_cplx, nch=None, taps=None):
    """The kernel ``fft_backend='pallas'`` takes for a geometry, following
    the JAX package's gates (``pyfft_tpu/spectral.py:398-479``) gate for
    gate: ``'H'`` (kernel H, :mod:`~pyfft_tpu_torch.ops.welch_packed`)
    where ``PYFFT_PACKED`` is ``"1"`` in the environment, for one-sided
    real input with ``nch`` = 1 cross channel, detrend mean/none and the
    JAX package's ``packed_pair_geometry``; else ``'B'`` (kernel B,
    :mod:`~pyfft_tpu_torch.ops.welch`; also the two-sided complex path),
    else ``'E'`` (kernel E, :mod:`~pyfft_tpu_torch.ops.welch_v1`) where
    the gate of TPU kernel #7 holds, else None (the ``torch.fft`` core),
    which happens only where the JAX package too leaves Pallas for
    ``'mxu'``.  With FIR ``taps`` (:func:`welch_filtered_cross_spectra`)
    it is ``'B'`` where kernel B takes them, else None."""
    if ntmodel or is_cplx == onesided:
        # per-segment reference model, one-sided complex or two-sided real
        return None
    if (taps is None and os.environ.get("PYFFT_PACKED") == "1"
            and not is_cplx and nch == 1 and detrend_style in (0, 1)
            and packed_pair_geometry(navr, nwins, noverlap) is not None):
        return "H"
    if welch.pallas_welch2_applicable(nwins, noverlap, navr, taps=taps,
                                      detrend_style=detrend_style):
        return "B"
    if (taps is None and not is_cplx
            and welch_v1.pallas_welch_applicable(nwins, nnyquist, navr)):
        return "E"
    return None


def _kernel_block(route, x, y, win, nfreq, norm, *, navr, nwins, hop,
                  taps=None, detrend_style=0):
    """The result block (:mod:`~.ops.welch`) of the kernel ``route`` on ``x
    (nt,)`` against ``y (nch, nt)``: on CUDA tensors the kernel, on CPU
    tensors its plain version."""
    kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=detrend_style)
    if route == "E":
        return welch_v1._run(x, y, win, nfreq, norm, **kw)
    return welch._run(x, y, win, nfreq, norm, taps=taps, packed=route == "H",
                      **kw)


def _kernel_sums(route, x, y, win, nfreq, *, navr, nwins, hop):
    """``(Pxx, Pyy, Pxy_re, Pxy_im)`` of :func:`_kernel_block`, unscaled
    and without detrend: the streaming and mesh tiers' segment sums."""
    return welch._split(_kernel_block(route, x, y, win, nfreq, 1.0,
                                      navr=navr, nwins=nwins, hop=hop))


def _welch_core_pallas(x, y, win, s1sq_enbw, *, navr, nwins, noverlap,
                       nfft, nnyquist, onesided, detrend_style, ntmodel,
                       taps=None):
    """The kernel Welch paths (:func:`pallas_route`; with ``taps``, the
    fused FIR chain) as the float32 result block ``(1 + nch, 3, nfreq)``
    on the inputs' device, or None where no kernel's gate holds.

    ``x (nt,)``, ``y (nch, nt)`` tensors, cast to float32 (complex64 where
    either is complex).  The block is averaged and normalised, one-sided
    doubled or ``fftshift``-ed.  The one-sided bin doubling is a *vector*
    scale, so the scalar ``norm`` handed to the kernel carries only
    ``S1^2*ENBW*navr`` and :func:`_fold_bins` applies the vector to the
    (small) block.
    """
    is_cplx = x.is_complex() or y.is_complex()
    route = pallas_route(nwins=nwins, noverlap=noverlap, navr=navr,
                         nnyquist=nnyquist, onesided=onesided,
                         detrend_style=detrend_style, ntmodel=ntmodel,
                         is_cplx=is_cplx, nch=y.shape[0], taps=taps)
    if route is None:
        return None
    x, y = welch._signals(x, y, torch.complex64 if is_cplx else torch.float32)
    block = _kernel_block(route, x, y, win, nwins if is_cplx else nnyquist,
                          np.float32(1.0 / (s1sq_enbw * navr)), navr=navr,
                          nwins=nwins, hop=nwins - noverlap, taps=taps,
                          detrend_style=detrend_style)
    return _fold_bins(block, nfft, nnyquist, onesided)


def _host_spectra(block, real, cplx):
    """``Pxx (nfreq,)``, ``Pyy (nfreq, nch)`` as ``real`` and ``Pxy`` as
    ``cplx`` from a block of :func:`_welch_core_pallas`, in one copy to the
    host; no per-segment arrays."""
    P = _np(block)
    return dict(Pxx=P[0, 0].astype(real), Pyy=P[1:, 0].T.astype(real),
                Pxy=(P[1:, 1] + 1j * P[1:, 2]).T.astype(cplx),
                **dict.fromkeys(_SEGMENT_FIELDS[:5]))


def _run_welch_core(x_in, y_in, win, s1sq_enbw, *, backend, **static):
    """Dispatch to a transform path; returns NumPy segment results.
    ``x_in (nt,)`` and ``y_in (nt, nch)`` are tensors on one device."""
    if backend == "pallas":
        block = _welch_core_pallas(x_in, y_in.T, win, s1sq_enbw, **static)
        if block is not None:
            return _host_spectra(block, np.complex128, np.complex64)
    out = _welch_core_xla(x_in, y_in.T, win, s1sq_enbw, **static)
    return {k: _np(v) for k, v in out.items()}


def _put_segments(info, out):
    """The reference's ``P??_seg``/``?fft_seg`` fields of ``info``
    (``fft_analysis.py:391-393``) from a core's NumPy ``out``."""
    for f in _SEGMENT_FIELDS[:5]:
        setattr(info, f, out[f])
    info.phixy_seg = np.angle(out["Pxy_seg"])
    info.varphi_seg = np.zeros_like(info.phixy_seg)


def _make_segment_fill(x_in, y_in, win, s1sq_enbw, **static):
    """One-shot per-segment recompute for the fused path (lazy fill): runs
    the ``'xla'`` core over the retained inputs into :func:`_put_segments`."""
    return lambda info: _put_segments(info, _run_welch_core(
        x_in, y_in, win, s1sq_enbw, backend="xla", **static))


def _make_segment_fill_sharded(x_in, y_in, win, s1sq_enbw, mesh, fs,
                               **static):
    """Distributed lazy fill: the per-segment spectra computed where the
    samples live (the ``raw`` mode of :func:`parallel.stft.stft_sharded`,
    ``x_in (nt,)`` and every channel of ``y_in (nt, nch)`` in one pass)
    rather than recomputed on one device, so the reference's
    ``P??_seg``/``?fft_seg`` contract (``fft_analysis.py:391-393``) holds
    when the input only fits the mesh.  Scaling as :func:`_welch_core_xla`:
    ``Xfft_seg`` raw, all ``nfft`` bins in natural order; the power
    segments one-sided-doubled (or ``fftshift``-ed) and divided by ``S1^2
    ENBW``; every field complex128."""
    def fill(info):
        from .parallel.stft import stft_rows
        plan = seg.SegmentPlan(
            nsig=x_in.shape[0], nwins=static["nwins"],
            noverlap=static["noverlap"], navr=static["navr"],
            nfft=static["nfft"], nnyquist=static["nnyquist"])
        dtype = torch.promote_types(x_in.dtype, y_in.dtype)
        rows = torch.cat([x_in[None].to(dtype), y_in.T.to(dtype)])
        _, XY = stft_rows(rows, win, plan, fs, mesh,
                          onesided=static["onesided"],
                          detrend_style=static["detrend_style"], raw=True)
        # the products in complex128 on the rank's device
        XY = XY.to(torch.complex128)
        X, Ys = XY[0], XY[1:]
        P = torch.cat([(X.real ** 2 + X.imag ** 2)[None].to(XY.dtype),
                       (Ys.real ** 2 + Ys.imag ** 2).to(XY.dtype),
                       Ys * X.conj()[None]])
        P = _np(_fold_bins(P, static["nfft"], static["nnyquist"],
                           static["onesided"]) * (1.0 / s1sq_enbw))
        nch = Ys.shape[0]
        _put_segments(info, dict(Pxx_seg=P[0], Pyy_seg=P[1:1 + nch],
                                 Pxy_seg=P[1 + nch:], Xfft_seg=_np(X),
                                 Yfft_seg=_np(Ys)))
    return fill


def welch_cross_spectra(x, y, win, plan: seg.SegmentPlan, fs: float, *,
                        onesided=True, detrend_style=1, ntmodel=False,
                        fft_backend=None, device=None):
    """Functional core: averaged auto-/cross-spectral densities.

    ``x (nt,)``, ``y (nt,) | (nch, nt)`` tensors or arrays (see the module
    docstring for the device).  Returns a dict with ``freq`` plus
    per-segment and averaged spectra (NumPy, complex where applicable).
    """
    dev = resolve_device(device, x, y)
    win = np.asarray(win)
    s1 = seg.get_s1(win)
    enbw = seg.get_enbw(fs, s1, seg.get_s2(win))
    # accept y as (nt,) or channel-first (nch, nt); the runner wants (nt, nch)
    y2 = _tensor(y, dev)
    y2 = y2[:, None] if y2.dim() == 1 else y2.T
    out = _run_welch_core(
        _tensor(x, dev), y2, win, s1 ** 2 * enbw,
        backend=resolve_fft_backend(fft_backend),
        navr=plan.navr, nwins=plan.nwins, noverlap=plan.noverlap,
        nfft=plan.nfft, nnyquist=plan.nnyquist, onesided=bool(onesided),
        detrend_style=int(detrend_style), ntmodel=bool(ntmodel))
    freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
    out["freq"] = freq[:plan.nnyquist] if onesided else np.fft.fftshift(freq)
    return out


def welch_filtered_cross_spectra(x, y, taps, win, plan: seg.SegmentPlan,
                                 fs: float, *, detrend_style=1,
                                 fft_backend=None, device=None):
    """One-sided Welch auto-/cross-spectral densities of FIR-prefiltered
    REAL signals — the framework's headline fused chain.

    ``x (nt,)`` reference, ``y (nt,) | (nch, nt)`` channels, ``taps`` a
    causal FIR applied to every signal (``np.convolve(sig, taps,
    'full')[:nt]``), detrend = global mean/none of the *filtered* span.
    On CUDA tensors the default (``fft_backend`` None/'auto') and
    ``'pallas'`` run filter, detrend, segmentation, transforms and
    cross-power accumulation as kernel B; ``'pallas'`` on CPU tensors runs
    its plain version.  Otherwise (``'xla'``/``'mxu'``, CPU default,
    complex input, linear detrend, or the kernel's gate fails) the signals
    are filtered first (kernel A on CUDA tensors for up to 1024 taps,
    overlap-save otherwise) and handed to
    :func:`welch_cross_spectra`.  Returns the same dict contract (averaged
    spectra; per-segment arrays are ``None`` on the fused path).
    """
    with stage("welch_filtered_cross_spectra"):
        with stage("welch_filtered_cross_spectra.args"):
            dev = resolve_device(device, x, y)
            x = _tensor(x, dev)
            y2 = _tensor(y, dev)
            if y2.dim() == 1:
                y2 = y2[None]
            taps_np = np.asarray(taps, np.float64)
            win_np = np.asarray(win)
            s1 = seg.get_s1(win_np)
            enbw = seg.get_enbw(fs, s1, seg.get_s2(win_np))
            backend = fft_backend
            if backend not in ("xla", "mxu", "pallas"):
                backend = "pallas" if dev.type == "cuda" else "xla"
        block = None
        if backend == "pallas":
            block = _welch_core_pallas(
                x, y2, win_np, s1 ** 2 * enbw, navr=plan.navr,
                nwins=plan.nwins, noverlap=plan.noverlap, nfft=plan.nfft,
                nnyquist=plan.nnyquist, onesided=True,
                detrend_style=int(detrend_style), ntmodel=False,
                taps=taps_np)
        if block is not None:
            with stage("welch_filtered_cross_spectra.finalize"):
                out = _host_spectra(block, np.float64, np.complex128)
                freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
                out["freq"] = freq[:plan.nnyquist]
            return out
        # on the card the filter-first route filters with kernel A, the role
        # the FIR kernel plays as the feeder of the JAX package's unfused path
        fir_backend = ("pallas" if dev.type == "cuda"
                       and taps_np.size <= PALLAS_FIR_MAX_TAPS else "os")
        xf = _fir_filter(x, taps_np, backend=fir_backend)
        yf = _fir_filter(y2, taps_np, backend=fir_backend)
        return welch_cross_spectra(xf, yf, win_np, plan, fs, onesided=True,
                                   detrend_style=detrend_style,
                                   fft_backend=backend)


# --------------------------------------------------------------------------- #
# Independent-oracle CSD path (role of matplotlib.mlab.csd; reference :288-303)
# --------------------------------------------------------------------------- #

def csd_oracle(x, y, nfft, fs, detrend=None, window=None, noverlap=0,
               sides="onesided"):
    """NumPy cross-spectral density with matplotlib.mlab conventions.

    Role of the reference's ``useMLAB`` cross-check path
    (``fft_analysis.py:288-303``): per-segment detrend, window, FFT,
    ``conj(X) * Y`` averaged, scaled by ``1/(Fs * S2)``, with one-sided
    doubling of non-DC/non-Nyquist bins.  Kept in NumPy on purpose — it is
    the *independent* implementation used to validate the TPU path.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if window is None:
        window = np.hanning(nfft)
    win = np.asarray(window)
    if detrend is None:
        detrend = lambda d: d  # noqa: E731

    step = nfft - noverlap
    starts = np.arange(0, len(x) - nfft + 1, step)
    navr = len(starts)
    acc = 0.0
    for s0 in starts:
        xs = detrend(x[s0:s0 + nfft]) * win
        ys = detrend(y[s0:s0 + nfft]) * win
        X = np.fft.fft(xs, n=nfft)
        Y = np.fft.fft(ys, n=nfft)
        acc = acc + np.conj(X) * Y
    Pxy = acc / navr
    Pxy /= fs * (win ** 2).sum()

    freqs = np.fft.fftfreq(nfft, 1.0 / fs)
    if sides == "onesided":
        nret = nfft // 2 + 1
        Pxy = Pxy[:nret].copy()
        if nfft % 2:
            Pxy[1:] *= 2.0
        else:
            Pxy[1:-1] *= 2.0
        freqs = np.abs(freqs[:nret])
        if nfft % 2 == 0:
            freqs[-1] = fs / 2.0
    else:
        Pxy = np.fft.fftshift(Pxy)
        freqs = np.fft.fftshift(freqs)
    return Pxy, freqs


# --------------------------------------------------------------------------- #
# fft_pwelch — full-parity public API
# --------------------------------------------------------------------------- #

def fft_pwelch(tvec, sigx, sigy, tbounds=None, Navr=None, windowoverlap=None,
               windowfunction=None, useMLAB=None, plotit=None, verbose=None,
               detrend_style=None, onesided=None, fft_backend=None,
               mesh=None, device=None, **kwargs):
    """Welch-averaged cross-spectral analysis of two signals.

    Computes the cross- and auto-power spectral densities, coherence,
    cross-phase (with propagated uncertainties), linear amplitude spectra and
    lag-domain correlations of ``sigx`` against (possibly multi-channel)
    ``sigy``.

    Calling convention, defaulting rules and outputs are those of the JAX
    package's ``fft_pwelch`` and the reference (``fft_analysis.py:36-791``):

    - ``windowfunction`` default 'Hanning'; ``windowoverlap`` defaults to the
      window's recommended overlap (``:104-111``);
    - ``minFreq``/``tper`` kwargs override the segment length
      (``nwins = int(Fs * tper)``, ``tper = 2/minFreq``; ``:180-183``);
    - ``onesided`` defaults to False for complex inputs (``:123-128``);
    - ``detrend_style``: 1 mean (default), 0 none, -1 linear;
    - full-span inputs are reflect-extended at the boundaries (``:196-205``);
    - ``useMLAB=True`` runs the independent NumPy oracle path instead of the
      device pipeline (role of ``matplotlib.mlab.csd``; ``:288-303``).

    ``sigx``/``sigy`` are tensors (computed on their device) or arrays
    (computed on ``device``; see the module docstring).  ``fft_backend``:
    None/'auto' or 'xla'/'mxu' (``torch.fft``), or 'pallas' (kernel B where
    its gate holds, else kernel E, else ``torch.fft``: :func:`pallas_route`).
    ``mesh`` (a ``('ch', 't')`` mesh of :mod:`pyfft_tpu_torch.parallel`,
    or ``'auto'`` for ``make_mesh(ch=1)`` over every rank of the world)
    runs the sharded Welch pipeline (:func:`parallel.welch_psd_sharded`),
    SPMD: every rank of the mesh calls with the same inputs and gets the
    same result; the per-segment arrays are then filled on first access by
    the sharded raw STFT (the nT-model's by the single-device pipeline),
    whose collectives need every rank of the mesh to touch them too.

    Returns ``(freq, Pxy, Pxx, Pyy, Cxy, phi_xy, fftinfo)`` as NumPy
    arrays.  Where segment arithmetic after reflect-extension would index
    past the analyzed span, ``Navr`` is clamped to the largest count that
    fits.
    """
    calcNavr = Navr is None
    if windowfunction is None:
        windowfunction = "Hanning"
    if windowoverlap is None:
        windowoverlap = windows(windowfunction, verbose=False)
    if useMLAB is None:
        useMLAB = False
    if plotit is None:
        plotit = True
    if verbose is None:
        verbose = False
    if detrend_style is None:
        detrend_style = 1
    tvec = _np(tvec)
    if tbounds is None:
        tbounds = [tvec[0], tvec[-1]]

    dev = resolve_device(device, sigx, sigy)
    with stage("fft_pwelch.h2d"):
        sigx = _tensor(sigx, dev)
        if sigy is None:
            # auto-spectra shorthand (reference fft_analysis.py:1714)
            sigy = sigx
        sigy = _tensor(sigy, dev)
    if onesided is None:
        onesided = not (sigx.is_complex() or sigy.is_complex())

    Fs = (len(tvec) - 1) / (tvec[-1] - tvec[0])

    i0 = int(np.floor(Fs * (tbounds[0] - tvec[0])))
    i1 = int(np.floor(1 + Fs * (tbounds[1] - tvec[0])))
    nsig = np.size(tvec[i0:i1])

    # --- shape handling: sigy -> (nt, nch) (reference :163-167)
    if sigy.dim() < 2:
        sigy = sigy.reshape(1, -1)
    if sigy.shape[1] == len(tvec):
        sigy = sigy.T
    nch = sigy.shape[1]

    # --- segment-length resolution (reference :170-191)
    nTmodel = sigx.shape[0] != sigy.shape[0]
    if nTmodel:
        if calcNavr:
            nwins = sigx.shape[0]
        else:
            nwins = seg.get_nwins(nsig, Navr, windowoverlap)
    else:
        if "minFreq" in kwargs:
            kwargs["tper"] = 2.0 / kwargs["minFreq"]
        if "tper" in kwargs:
            nwins = int(Fs * kwargs["tper"])
        else:
            if Navr is None:
                Navr = 8
            calcNavr = False
            nwins = seg.get_nwins(nsig, Navr, windowoverlap)

    noverlap = seg.get_noverlap(nwins, windowoverlap)

    # --- reflect-extension at full span (reference :196-205)
    reflecting = False
    if i0 == 0 and i1 == len(tvec):
        reflecting = True
        if not nTmodel:
            sigx = seg.reflect_extend(sigx, nwins, axis=0)
        sigy = seg.reflect_extend(sigy, nwins, axis=0)
        nsig = sigy.shape[0]

    if calcNavr:
        Navr = seg.get_navr(nsig, nwins, noverlap)

    if nwins >= nsig:
        Navr = 1
        nwins = nsig
    nfft = nwins
    Nnyquist = seg.get_nnyquist(nfft)

    # --- window + norms (reference :231-246)
    win, winparams = windows(windowfunction, nwins=nwins, verbose=verbose,
                             msgout=True, **({"beta": kwargs["beta"]}
                                             if "beta" in kwargs else {}))

    fftinfo = fftinfosc()
    fftinfo.win = win
    fftinfo.winparams = winparams
    fftinfo.windowoverlap = windowoverlap
    fftinfo.ibnds = [i0, i1]
    fftinfo.S1 = seg.get_s1(win)
    fftinfo.S2 = seg.get_s2(win)
    fftinfo.NENBW = seg.get_nenbw(Nnyquist, fftinfo.S1, fftinfo.S2)
    fftinfo.ENBW = seg.get_enbw(Fs, fftinfo.S1, fftinfo.S2)

    detrend = detrend_func(detrend_style)

    # --- analyzed spans (reference :282-283, :346-354)
    if nTmodel:
        x_in = sigx
        y_in = sigy[i0:i1, :]
    else:
        x_in = sigx[i0:i1]
        y_in = sigy[i0:i1, :]

    # clamp Navr so all segments fit the analyzed span (see docstring)
    max_navr = seg.get_navr(y_in.shape[0], nwins, noverlap)
    if Navr > max_navr:
        Navr = max_navr

    static = dict(navr=int(Navr), nwins=int(nwins), noverlap=int(noverlap),
                  nfft=int(nfft), nnyquist=int(Nnyquist),
                  onesided=bool(onesided), detrend_style=int(detrend_style),
                  ntmodel=bool(nTmodel))
    if useMLAB:
        sides = "onesided" if onesided else "twosided"
        if verbose:
            print("using the independent NumPy oracle path for spectra")

        def _det(d):
            return _np(detrend(torch.as_tensor(d), axis=0))

        xm = _np(x_in)
        y_np = _np(y_in)
        if nTmodel:
            while xm.shape[0] < y_np.shape[0]:
                xm = np.r_[xm, xm[-1:-nwins:-1]]
            if xm.shape[0] > y_np.shape[0]:
                xm = xm[:y_np.shape[0]]
        Pxx, freq = csd_oracle(xm, xm, nfft, fs=Fs, detrend=_det, window=win,
                               noverlap=noverlap, sides=sides)
        Pyy = np.zeros((nch, len(freq)), dtype=np.float64)
        Pxy = np.zeros((nch, len(freq)), dtype=np.complex128)
        for ii in range(nch):
            pyy_ii, _ = csd_oracle(y_np[:, ii], y_np[:, ii], nfft, fs=Fs,
                                   detrend=_det, window=win,
                                   noverlap=noverlap, sides=sides)
            Pyy[ii, :] = pyy_ii.real
            Pxy[ii, :], _ = csd_oracle(xm, y_np[:, ii], nfft, fs=Fs,
                                       detrend=_det, window=win,
                                       noverlap=noverlap, sides=sides)
        if onesided:
            freq = freq[:Nnyquist]
            Pxx = Pxx[:Nnyquist]
            Pyy = Pyy[:, :Nnyquist]
            Pxy = Pxy[:, :Nnyquist]
        Pyy = Pyy.T
        Pxy = Pxy.T
    elif mesh is not None:
        # distributed path: time-split blocks with a halo exchange over a
        # mesh, the single-device pipeline's normalization contract
        from . import parallel as par
        if isinstance(mesh, str) and mesh == "auto":
            mesh = par.make_mesh(ch=1, device=dev)
        if verbose:
            print("using the sharded Welch pipeline over mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        plan = seg.SegmentPlan(nsig=int(y_in.shape[0]), nwins=int(nwins),
                               noverlap=int(noverlap), navr=int(Navr),
                               nfft=int(nfft), nnyquist=int(Nnyquist))
        with stage("fft_pwelch.device_core"):
            freq, Pxx, Pyy_s, Pxy_s = par.welch_psd_sharded(
                x_in, y_in.T, win, plan, Fs, mesh, onesided=bool(onesided),
                detrend_style=int(detrend_style), fft_backend=fft_backend,
                ntmodel=bool(nTmodel))
        Pyy = Pyy_s.T
        Pxy = Pxy_s.T
        s1sq_enbw = fftinfo.S1 ** 2 * fftinfo.ENBW
        if nTmodel:
            # the nT-model holds one reference window: the single-device
            # recompute is small
            fftinfo._defer_segments(_make_segment_fill(
                x_in, y_in, win, s1sq_enbw, **static))
        else:
            fftinfo._defer_segments(_make_segment_fill_sharded(
                x_in, y_in, win, s1sq_enbw, mesh, Fs,
                **{k: v for k, v in static.items() if k != "ntmodel"}))
    else:
        if verbose:
            print("using the batched device Welch pipeline "
                  f"({resolve_fft_backend(fft_backend)} transform path "
                  f"on {dev})")
        with stage("fft_pwelch.device_core"):
            out = _run_welch_core(x_in, y_in, win,
                                  fftinfo.S1 ** 2 * fftinfo.ENBW,
                                  backend=resolve_fft_backend(fft_backend),
                                  **static)

        freq = np.fft.fftfreq(nfft, 1.0 / Fs)
        freq = freq[:Nnyquist] if onesided else np.fft.fftshift(freq)

        Pxx = out["Pxx"]
        Pyy = out["Pyy"]
        Pxy = out["Pxy"]

        if out["Pxy_seg"] is None:
            # fused fast path: per-segment arrays on first access
            fftinfo._defer_segments(_make_segment_fill(
                x_in, y_in, win, fftinfo.S1 ** 2 * fftinfo.ENBW, **static))
        else:
            _put_segments(fftinfo, out)

    # ---------------- shared finalization (host, reference :489-648) -------
    Cxy, Cxy2 = Cxy_Cxy2(Pxx, Pyy, Pxy)

    # Bendat'78-derived coherence variance (reference :496-498)
    fftinfo.varCxy = ((1.0 - Cxy * np.conj(Cxy)) / np.sqrt(2 * Navr)) ** 2.0
    fftinfo.varCxy2 = 4.0 * Cxy2 * fftinfo.varCxy

    fftinfo.varPxx = (Pxx / np.sqrt(Navr)) ** 2.0
    fftinfo.varPyy = (Pyy / np.sqrt(Navr)) ** 2.0
    fftinfo.varPxy = (Pxy / np.sqrt(Navr)) ** 2.0

    # A.E. White, Phys. Plasmas 17 056103 (2010) phase variance; reference :514
    # evaluates to sqrt(1-|C2|) / (2 Navr sqrt(|C2|)) via operator precedence
    with np.errstate(divide="ignore", invalid="ignore"):
        fftinfo.varPhxy = (np.sqrt(1.0 - np.abs(Cxy2))
                           / (2.0 * Navr * np.sqrt(np.abs(Cxy2))))

    phi_xy = np.arctan2(Pxy.imag, Pxy.real)

    # Linear amplitude spectra (reference :526-540)
    Lxx = np.sqrt(np.abs(fftinfo.ENBW * Pxx))
    Lyy = np.sqrt(np.abs(fftinfo.ENBW * Pyy))
    Lxy = np.sqrt(np.abs(fftinfo.ENBW * Pxy))
    if onesided:
        amp = _onesided_amp_scale(nfft, Nnyquist)
        Lxx = Lxx * amp
        Lyy = Lyy * amp[:, None]
        Lxy = Lxy * amp[:, None]
    fftinfo.Lxx, fftinfo.Lyy, fftinfo.Lxy = Lxx, Lyy, Lxy

    # Lag-domain correlations from the spectra (reference :544-597)
    if onesided:
        inv = 1.0 / _onesided_power_scale(nfft, Nnyquist)

        def _to_lags(P):
            sc = inv if P.ndim == 1 else inv[:, None]
            return np.fft.irfft(P * sc, n=nfft, axis=0)

        Rxx = _to_lags(Pxx)
        Ryy = _to_lags(Pyy)
        Rxy = _to_lags(Pxy)
        iCxy = np.fft.irfft(Cxy, n=nfft, axis=0)
    else:
        def _to_lags2(P):
            return np.fft.ifft(np.fft.ifftshift(P, axes=0), n=nfft, axis=0)

        Rxx = _to_lags2(Pxx)
        Ryy = _to_lags2(Pyy)
        Rxy = _to_lags2(Pxy)
        iCxy = _to_lags2(Cxy)

    rt = np.sqrt(nfft)
    Rxx = Rxx * rt
    Ryy = Ryy * rt
    Rxy = Rxy * rt
    iCxy = iCxy * rt

    Ex = Rxx[0, ...].copy()
    Ey = Ryy[0, ...].copy()
    corrcoef = Rxy / np.sqrt(Ex * Ey)

    fftinfo.Rxx = np.fft.fftshift(Rxx, axes=0)
    fftinfo.Ryy = np.fft.fftshift(Ryy, axes=0)
    fftinfo.Rxy = np.fft.fftshift(Rxy, axes=0)
    fftinfo.iCxy = np.fft.fftshift(iCxy, axes=0)
    fftinfo.corrcoef = np.fft.fftshift(corrcoef, axes=0)
    fftinfo.Ex = Ex
    fftinfo.Ey = Ey
    fftinfo.lags = (np.arange(1, nfft + 1) - Nnyquist) / Fs

    with np.errstate(divide="ignore", invalid="ignore"):
        fftinfo.varLxx = (Lxx ** 2) * (fftinfo.varPxx / np.abs(Pxx) ** 2)
        fftinfo.varLyy = (Lyy ** 2) * (fftinfo.varPyy / np.abs(Pyy) ** 2)
        fftinfo.varLxy = (Lxy ** 2) * (fftinfo.varPxy / np.abs(Pxy) ** 2)

    if nch == 1:
        Pyy = Pyy.flatten()
        Pxy = Pxy.flatten()
        Cxy = Cxy.flatten()
        Cxy2 = Cxy2.flatten()
        phi_xy = phi_xy.flatten()
        for name in ("Rxx", "Ryy", "Rxy", "corrcoef", "iCxy", "Lxx", "Lyy",
                     "Lxy", "varLxx", "varLyy", "varLxy", "varCxy", "varCxy2",
                     "varPxx", "varPyy", "varPxy", "varPhxy"):
            setattr(fftinfo, name, np.asarray(getattr(fftinfo, name)).flatten())
        fftinfo.lags = fftinfo.lags.flatten()

    fftinfo.nch = nch
    fftinfo.Fs = Fs
    fftinfo.Navr = Navr
    fftinfo.nwins = nwins
    fftinfo.nfft = nfft
    fftinfo.Nnyquist = Nnyquist
    fftinfo.noverlap = noverlap
    fftinfo.overlap = windowoverlap
    fftinfo.window = windowfunction
    fftinfo.minFreq = 2.0 * Fs / nwins
    fftinfo.freq = freq
    fftinfo.Pxx = Pxx
    fftinfo.Pyy = Pyy
    fftinfo.Pxy = Pxy
    fftinfo.Cxy = Cxy
    fftinfo.Cxy2 = Cxy2
    fftinfo.phi_xy = phi_xy

    if plotit:  # pragma: no cover - plotting side effects
        from . import plotting
        plotting.plot_pwelch_summary(tvec, _np(sigx), _np(sigy), tbounds,
                                     freq, Pxx, Pyy, Pxy, Cxy2, phi_xy,
                                     fftinfo,
                                     onesided=onesided, reflecting=reflecting,
                                     nwins=nwins, navr=Navr, **kwargs)

    return freq, Pxy, Pxx, Pyy, Cxy, phi_xy, fftinfo
