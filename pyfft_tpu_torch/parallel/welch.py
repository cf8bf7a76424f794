"""Sharded Welch cross-spectral estimation (time over ``'t'``, channels
over ``'ch'``).

Counterpart of :mod:`pyfft_tpu.parallel.welch`, run SPMD on
``torch.distributed``: every rank of the mesh calls
:func:`welch_psd_sharded` with the same global signals, takes its own
block, and returns the same full result.

- The **time axis** is split over ``'t'``: rank ``d`` owns samples ``[d*B,
  (d+1)*B)`` and computes the segments whose *start* lies there, the
  contiguous global segments ``g0 .. g0 + m - 1``.  A segment that runs
  past the block reads the first ``nwins - 1`` samples of the next rank's,
  received in one halo exchange (the last rank's segments end inside its
  block).
- The **channel axis** is split over ``'ch'``; the reference ``x`` goes to
  every rank.
- The **global detrend moments** (the mean, and for linear detrend the
  slope against the global sample index) are float64 sums all-reduced
  over ``'t'`` and divided by the unpadded length, so the zeros that pad
  the signal to a multiple of the shards do not count.  They are removed
  in float64 before the block is rounded to the compute dtype.
- The **local sums** are the route's kernel, as the single-device path
  takes it (:func:`~pyfft_tpu_torch.spectral.pallas_route` with
  ``fft_backend='pallas'``): kernel B for real (``csrc/welch_pair.cu``)
  and complex (``csrc/welch.cu``) signals on CUDA tensors, in float32
  (complex64), launched once a rank with ``navr = m`` and no detrend; E or
  H where the route says so; their plain versions on CPU tensors, in the
  signals' dtype.  ``'xla'``, a geometry no kernel takes, and the
  nT-model (one model window against every segment) take ``torch.fft``.
  A rank with no segment launches nothing and adds zeros.
- The float64 sums are all-reduced over ``'t'``, then divided by
  ``navr``, scaled (one-sided doubling, or ``fftshift``) and normalised by
  ``1/(S1^2 ENBW)`` in the JAX package's order, and all-gathered over
  ``'ch'``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import segmentation as seg
from ..spectral import (_fold_bins, _kernel_sums, pallas_route,
                        resolve_fft_backend)
from ..utils.detrend import detrend_func
from . import _comm
from .mesh import axis_size, coordinate, group, mesh_device

__all__ = ["welch_psd_sharded", "plan_shard_segments"]


def plan_shard_segments(nt: int, nwins: int, hop: int, navr: int, dshards: int):
    """Static segment -> rank assignment.

    Rank ``d`` owns time block ``[d*B, (d+1)*B)`` and computes the global
    segments whose start index lies in its block.  ``nt`` may include
    zero-padding to a shard multiple (the segments are limited by
    ``navr``).  Returns ``(B, M)`` with ``M`` the largest per-rank segment
    count.
    """
    if nt % dshards:
        raise ValueError(f"time axis {nt} not divisible by {dshards} shards")
    B = nt // dshards
    if nwins - 1 > B:
        raise ValueError(
            f"segment length {nwins} needs a halo of {nwins - 1} > block {B};"
            " use fewer time shards or longer signals")
    counts = np.zeros(dshards, dtype=int)
    for g in range(navr):
        counts[(g * hop) // B] += 1
    return B, int(counts.max())


def owned_segments(d, B, hop, navr):
    """``(g0, m)``: rank ``d``'s first global segment ``ceil(d*B/hop)`` and
    how many it owns, those with ``g*hop < (d+1)*B`` and ``g < navr``."""
    g0 = -(-d * B // hop)
    g1 = min(navr, -(-(d + 1) * B // hop))
    return g0, max(0, g1 - g0)


def _floating(dtype):
    """``dtype`` itself if floating or complex, else float64 (integers are
    promoted as the JAX package casts them)."""
    return dtype if dtype.is_floating_point or dtype.is_complex \
        else torch.float64


def local_block(sig, rows, d, B, device, dtype=None):
    """Rows ``rows`` of ``sig (C, nt)`` (NumPy or a tensor) over samples
    ``[d*B, (d+1)*B)``, zero past ``nt``, as a contiguous tensor on
    ``device`` in ``dtype`` (default: ``sig``'s floating dtype)."""
    nt = sig.shape[-1]
    part = sig[rows, d * B:min((d + 1) * B, nt)]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    dtype = dtype or _floating(part.dtype)
    out = torch.zeros(part.shape[:-1] + (B,), dtype=dtype, device=device)
    out[..., :part.shape[-1]] = part.to(device)
    return out


def detrend_block(v, style, grp, d, nt_true):
    """Remove the global mean (``style`` 1) or line (-1) of each row of the
    block ``v (R, B)`` of rank ``d``, from float64 (complex128) moments
    all-reduced over ``grp``; returns the float64 (complex128) block.
    Padding samples (global index ``>= nt_true``) hold zeros and count in
    no sum."""
    wide = torch.complex128 if v.is_complex() else torch.float64
    v = v.to(wide)
    if style == 0:
        return v
    B = v.shape[-1]
    if style > 0:
        s = _comm.all_reduce(v.sum(-1, keepdim=True), grp)
        return v - s / nt_true
    # linear: fit against the *global* sample index, the pad excluded
    tloc = torch.arange(B, dtype=torch.float64, device=v.device) + d * B
    tc = (tloc - (nt_true - 1) / 2.0) * (tloc < nt_true)
    mom = _comm.all_reduce(torch.stack([v.sum(-1), (v * tc).sum(-1)], -1),
                           grp)
    # sum of tc^2 over the global centred grid, in closed form
    denom = (nt_true * (nt_true ** 2 - 1)) / 12.0
    return v - mom[:, :1] / nt_true - (mom[:, 1:] / denom) * tc


def compute_dtype(dtype, kernel, device):
    """The dtype the local step runs in: the kernels take float32
    (complex64) on the card; the plain versions and ``torch.fft`` run in
    the signals' dtype."""
    if kernel and device.type == "cuda":
        return torch.complex64 if dtype.is_complex else torch.float32
    return dtype


def prepared_block(v, style, grp, d, nt_true, cdt, halo):
    """The rank's block after the global detrend, rounded to ``cdt``,
    with the next rank's first ``halo`` samples appended: ``(R, B +
    halo)``, or ``(R, B)`` on the last rank, whose segments end inside its
    block."""
    device = v.device
    with _comm.step("moments", device):
        if style:
            v = detrend_block(v, style, grp, d, nt_true)
        v = v.to(cdt)
    with _comm.step("halo", device):
        h = _comm.halo(v, halo, grp, from_right=True)
        return v if h is None else torch.cat([v, h], -1)


def _fft_sums(x, y, win, *, nfft, nfreq, navr, nwins, hop, model=False):
    """``torch.fft`` segment sums ``(Pxx, Pyy, Pxy_re, Pxy_im)`` of ``y
    (nch, span)`` against ``x (span,)``, or with ``model`` against the one
    window ``x (nwins,)`` for every segment; the first ``nfreq`` of
    ``nfft`` bins, unscaled."""
    real = y.real.dtype if y.is_complex() else y.dtype
    w = torch.as_tensor(np.asarray(win), dtype=real, device=y.device)
    Y = torch.fft.fft(seg.frame_signal(y, nwins, hop, navr) * w, n=nfft,
                      dim=-1)[..., :nfreq]
    X = torch.fft.fft((x[:nwins] if model else
                       seg.frame_signal(x, nwins, hop, navr)) * w, n=nfft,
                      dim=-1)[..., :nfreq]
    px = X.real ** 2 + X.imag ** 2
    Pxx = px * navr if model else px.sum(0)
    Pxy = (Y * X.conj()).sum(-2)
    return Pxx, (Y.real ** 2 + Y.imag ** 2).sum(-2), Pxy.real, Pxy.imag


def welch_psd_sharded(x, y, win, plan: seg.SegmentPlan, fs, mesh, *,
                      onesided=True, detrend_style=1, fft_backend=None,
                      ntmodel=False):
    """Distributed Welch auto-/cross-spectra over a ``('ch','t')`` mesh.

    ``x (nt,)`` is the reference signal (time-split), or with
    ``ntmodel=True`` a one-window model that every rank holds whole
    (reference ``fft_analysis.py:170-191``); ``y (nch, nt)`` is split over
    channels and time.  NumPy arrays or tensors, the same on every rank;
    real or complex (complex signals one- or two-sided, the Doppler IQ
    configuration).  A length that is not a multiple of the time shards is
    zero-padded (left out of the moments and of every segment).  Returns
    NumPy ``(freq, Pxx, Pyy, Pxy)`` under the single-device pipeline's
    normalization on every rank of the mesh; ``nch`` must be a multiple of
    the ``'ch'`` shards.
    """
    y = y if isinstance(y, torch.Tensor) else np.asarray(y)
    y = y[None] if y.ndim == 1 else y
    x = x if isinstance(x, torch.Tensor) else np.asarray(x)
    win_np = np.asarray(win)
    s1 = seg.get_s1(win_np)
    norm = 1.0 / (s1 ** 2 * seg.get_enbw(fs, s1, seg.get_s2(win_np)))
    dt_shards, dch = axis_size(mesh, "t"), axis_size(mesh, "ch")
    nch, nt = y.shape
    if nch % dch:
        raise ValueError(f"nch={nch} not divisible by ch shards {dch}")
    nwins, hop, navr = plan.nwins, plan.hop, plan.navr
    pad = (-nt) % dt_shards
    B, _ = plan_shard_segments(nt + pad, nwins, hop, navr, dt_shards)
    d, c = coordinate(mesh, "t"), coordinate(mesh, "ch")
    tgrp, chgrp = group(mesh, "t"), group(mesh, "ch")
    dev = mesh_device(mesh)
    nch_l = nch // dch
    rows = slice(c * nch_l, (c + 1) * nch_l)
    nfreq = plan.nnyquist if onesided else plan.nfft

    with _comm.step("host", dev):
        sig = local_block(y, rows, d, B, dev)
        xm = torch.as_tensor(x).to(dev) if ntmodel else None
        if not ntmodel:
            sig = torch.cat([local_block(x[None], slice(0, 1), d, B, dev),
                             sig])
    base = _floating(torch.promote_types(sig.dtype, xm.dtype)
                     if ntmodel else sig.dtype)
    is_cplx = base.is_complex
    route = None
    if (resolve_fft_backend(fft_backend) == "pallas"
            and plan.nfft == nwins):
        route = pallas_route(nwins=nwins, noverlap=plan.noverlap, navr=navr,
                             nnyquist=plan.nnyquist, onesided=onesided,
                             detrend_style=0, ntmodel=ntmodel,
                             is_cplx=is_cplx, nch=nch_l)
    cdt = compute_dtype(base, route is not None, dev)
    sig_h = prepared_block(sig.to(base), detrend_style, tgrp, d, nt, cdt,
                           nwins - 1)

    g0, m = owned_segments(d, B, hop, navr)
    acc = torch.zeros(1 + 3 * nch_l, nfreq, dtype=torch.float64, device=dev)
    with _comm.step("kernel", dev):
        if m:
            span = sig_h[:, g0 * hop - d * B:][:, :(m - 1) * hop + nwins]
            kw = dict(navr=m, nwins=nwins, hop=hop)
            if ntmodel:
                xw = detrend_func(detrend_style)(xm.to(cdt)[:nwins], axis=-1)
                sums = _fft_sums(xw, span, win_np, nfft=plan.nfft,
                                 nfreq=nfreq, model=True, **kw)
            elif route is None:
                sums = _fft_sums(span[0], span[1:], win_np, nfft=plan.nfft,
                                 nfreq=nfreq, **kw)
            else:
                sums = _kernel_sums(route, span[0].contiguous(), span[1:],
                                    win_np, nfreq, **kw)
            acc[0] = sums[0]
            acc[1:] = torch.cat(sums[1:])
    with _comm.step("reductions", dev):
        _comm.all_reduce(acc, tgrp)
        acc = _fold_bins(acc / navr, plan.nfft, nfreq, onesided) * norm
        ych = _comm.all_gather(acc[1:], chgrp)            # (dch, 3 nch_l, nf)
        ych = ych.reshape(dch, 3, nch_l, nfreq).transpose(0, 1)
        ych = ych.reshape(3, nch, nfreq)
    with _comm.step("host", dev):
        Pxx = acc[0].cpu().numpy()
        Pyy, Pr, Pi = ych.cpu().numpy()
    freq = np.fft.fftfreq(plan.nfft, 1.0 / fs)
    freq = freq[:plan.nnyquist] if onesided else np.fft.fftshift(freq)
    return freq, Pxx, Pyy, Pr + 1j * Pi
