"""Sharded STFT: segment spectra computed where the samples live.

Counterpart of :mod:`pyfft_tpu.parallel.stft`.  Spectrogram workloads keep
every segment, so the output stays big: ``(navr, nfreq)`` a signal.  Each
rank of a ``'t'`` line takes its time block, removes the global detrend
moments and receives the halo exactly as
:mod:`pyfft_tpu_torch.parallel.welch` does, then transforms the segments
whose start lies in its block: kernel C (``csrc/stft.cu``) on CUDA tensors
for every signal of the call in one launch, in float32 (complex64); its
plain version on CPU tensors, in the signals' dtype; ``torch.fft`` for
``'xla'`` or a geometry the kernel does not take.  The reference
``fft_win`` scaling (sqrt2-amplitude one-sided, ``1/(S1 sqrt(ENBW))``),
or none in ``raw`` mode, is applied on the device; the tiles are
all-gathered over ``'t'`` and put in global segment order.  The ``'ch'``
axis holds copies.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import segmentation as seg
from ..ops.stft import stft_applicable, stft_cuda, stft_plain
from ..spectral import _onesided_amp_scale
from . import _comm
from .mesh import axis_size, coordinate, group, mesh_device
from .welch import (_floating, compute_dtype, local_block, owned_segments,
                    plan_shard_segments, prepared_block)

__all__ = ["stft_sharded", "specgram_sharded"]


def _uses_kernel(fft_backend, device, plan, detrend_style):
    """Kernel C's route, as :func:`~pyfft_tpu_torch.fftanal.stft_segments`
    takes it: ``'pallas'``, or None/'auto' on the card, where the kernel
    takes the geometry."""
    backend = fft_backend
    if backend not in ("xla", "mxu", "pallas"):
        backend = "pallas" if device.type == "cuda" else "xla"
    return (backend == "pallas" and plan.nfft == plan.nwins
            and stft_applicable(plan.nwins, plan.noverlap, detrend_style))


def segment_means(tvec, plan):
    """The mean of ``tvec`` over each segment (float64, host)."""
    tvec = np.asarray(tvec, dtype=np.float64)
    frames = np.lib.stride_tricks.sliding_window_view(tvec, plan.nwins)
    return frames[::plan.hop][:plan.navr].mean(axis=-1)


def stft_rows(sig, win, plan: seg.SegmentPlan, fs, mesh, *, onesided=True,
              detrend_style=1, fft_backend=None, raw=False, power=False):
    """Per-segment spectra of every row of ``sig (C, nt)`` (NumPy or a
    tensor, the same on every rank), split over the mesh's ``'t'`` axis.

    Returns ``(freq, X (C, navr, nfreq))``, ``freq`` NumPy and ``X`` a
    tensor on the rank's device in global segment order: complex, or the
    real ``|X|^2`` with ``power``, in the compute dtype; the scaling of
    :func:`stft_sharded`.
    """
    tshards = axis_size(mesh, "t")
    d, tgrp = coordinate(mesh, "t"), group(mesh, "t")
    dev = mesh_device(mesh)
    nwins, hop, navr, nfft = plan.nwins, plan.hop, plan.navr, plan.nfft
    nt_true = sig.shape[-1]
    L = -(-nt_true // tshards) * tshards
    B, M = plan_shard_segments(L, nwins, hop, navr, tshards)
    win_np = np.asarray(win, dtype=np.float64)
    s1 = seg.get_s1(win_np)
    enbw = seg.get_enbw(fs, s1, seg.get_s2(win_np))

    with _comm.step("host", dev):
        v = local_block(sig, slice(None), d, B, dev)
    kernel = _uses_kernel(fft_backend, dev, plan, 0)
    cdt = compute_dtype(_floating(v.dtype), kernel, dev)
    sig_h = prepared_block(v, detrend_style, tgrp, d, nt_true, cdt,
                           nwins - 1)

    C = sig_h.shape[0]
    nfreq = nfft if raw or not onesided else plan.nnyquist
    real = torch.empty(0, dtype=cdt).real.dtype
    g0, m = owned_segments(d, B, hop, navr)
    tile = torch.zeros((C, M, nfreq),
                       dtype=real if power else (real.to_complex()),
                       device=dev)
    with _comm.step("kernel", dev):
        if m:
            span = sig_h[:, g0 * hop - d * B:][:, :(m - 1) * hop + nwins]
            kw = dict(navr=m, nwins=nwins, hop=hop, detrend_style=0)
            if kernel:
                run = stft_cuda if dev.type == "cuda" else stft_plain
                X = run(span[0].contiguous(), span[1:] if C > 1 else None,
                        win_np, 1.0, **kw)
            else:
                w = torch.as_tensor(win_np, dtype=real, device=dev)
                X = torch.fft.fft(seg.frame_signal(span, nwins, hop, m) * w,
                                  n=nfft, dim=-1)
            if not raw:
                if onesided:
                    amp = torch.as_tensor(_onesided_amp_scale(nfft, nfreq),
                                          dtype=real, device=dev)
                    X = X[..., :nfreq] * amp
                else:
                    X = torch.fft.fftshift(X, dim=-1)
                X = X * (1.0 / (s1 * np.sqrt(enbw)))
            # power-spectrogram consumers gather the real |X|^2 grid, half
            # the bytes of the complex one
            tile[:, :m] = X.real ** 2 + X.imag ** 2 if power else X
    with _comm.step("reductions", dev):
        tiles = _comm.all_gather(tile, tgrp)                 # (t, C, M, nf)
        out = torch.cat([tiles[r, :, :owned_segments(r, B, hop, navr)[1]]
                         for r in range(tshards)], dim=1)
    freq = np.fft.fftfreq(nfft, 1.0 / fs)
    if not raw:
        freq = freq[:plan.nnyquist] if onesided else np.fft.fftshift(freq)
    return freq, out


def _host(X):
    """``X`` as NumPy, widened to float64 (complex128)."""
    return X.cpu().numpy().astype(np.complex128 if X.is_complex()
                                  else np.float64)


def stft_sharded(x, tvec, win, plan: seg.SegmentPlan, fs, mesh, *,
                 onesided=True, detrend_style=1, fft_backend=None,
                 raw=False, power=False):
    """Distributed STFT of ``x (nt,)`` over the ``'t'`` mesh axis.

    Real or complex input (complex is normally analysed two-sided, as
    :func:`~pyfft_tpu_torch.fftanal.stft_segments` does).  Returns NumPy
    ``(tt (navr,), freq, Xfft (navr, nfreq) complex)`` under the
    :func:`stft_segments` scaling contract, on every rank of the mesh.
    Any length works: the signal is zero-padded to a multiple of the
    shards, and the padding counts in no moment and no segment.

    ``raw=True`` returns the Welch core's per-segment convention instead
    (all ``nfft`` bins, natural order, no coefficient scaling: the
    ``Xfft_seg`` contract of reference ``fft_analysis.py:391-393``), which
    the lazy segment fill of ``fft_pwelch(mesh=...)`` uses.

    ``power=True`` reduces to ``|X|^2`` on the device and gathers the real
    power grid, half the bytes (returns ``(tt, freq, P (navr, nfreq))``
    real).
    """
    x = x if isinstance(x, torch.Tensor) else np.asarray(x)
    freq, X = stft_rows(x.reshape(1, -1), win, plan, fs, mesh,
                        onesided=onesided, detrend_style=detrend_style,
                        fft_backend=fft_backend, raw=raw, power=power)
    with _comm.step("host", X.device):
        return segment_means(tvec, plan), freq, _host(X[0])


def specgram_sharded(t, s, mesh, wl=512, hanning=True, overlap=True,
                     windowAverage=None, fft_backend=None):
    """Distributed simple spectrogram: the reference ``specgram`` contract
    (``spectrogram.py:49-134``: per-window two-sided power ``|FFT(hanning *
    seg)|^2 / wl`` with the sqrt(8/3) Hann correction, hop ``wl/2`` with
    overlap, the reference time-axis formulas) computed where the samples
    live, gathering only the real ``(wl, nW)`` power grid.

    Returns ``(time, fAxis, spectrogram[wl, nW])`` as
    :func:`pyfft_tpu_torch.spectrogram.specgram` does.
    """
    s = s.reshape(-1) if isinstance(s, torch.Tensor) \
        else np.asarray(s).flatten()
    t = np.asarray(t)
    n = s.shape[0]
    dt = np.abs(t[1] - t[0])
    wl = int(wl)
    if windowAverage is not None:
        overlap = False
    if overlap:
        nW = 2 * (n - (n % wl)) // wl - 1
        hop = wl // 2
    else:
        nW = (n - (n % wl)) // wl - 1
        hop = wl
    if nW < 1:
        raise ValueError(f"window length {wl} too long for {n} samples")
    win = np.hanning(wl) if hanning else np.ones(wl)

    plan = seg.SegmentPlan(nsig=n, nwins=wl, noverlap=wl - hop, navr=nW,
                           nfft=wl, nnyquist=wl // 2 + 1)
    _, Pw = stft_rows(s.reshape(1, -1), win, plan, 1.0 / dt, mesh,
                      onesided=False, detrend_style=0,
                      fft_backend=fft_backend, raw=True, power=True)
    Pw = _host(Pw[0]) / wl
    if hanning:
        Pw = np.sqrt(8.0 / 3.0) * Pw
    spectrogram_arr = Pw.T                                # (wl, nW)

    fAxis = np.fft.fftfreq(wl, dt)
    if windowAverage is not None:
        windowAverage = int(windowAverage)
        nA = nW // windowAverage
        avg = spectrogram_arr[:, :nA * windowAverage]
        avg = avg.reshape(wl, nA, windowAverage).mean(axis=-1)
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW - 1) + 1 / 2), num=nA)
        return time, fAxis, avg
    if not overlap:
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW - 1) + 1 / 2), num=nW)
    else:
        time = np.linspace(t[0] + wl * dt / 2,
                           t[0] + wl * dt * ((nW / 2 - 1) + 1 / 2), num=nW)
    return time, fAxis, spectrogram_arr
