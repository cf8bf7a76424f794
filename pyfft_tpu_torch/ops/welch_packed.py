"""Packed one-sided Welch of one real signal or one real pair: kernel H.

Counterpart of the packed entries of :mod:`pyfft_tpu.ops.pallas_welch3`
(``welch_auto_packed``, ``welch_pair_packed``), which run TPU kernel #1 in
its lane-packing modes (``vmask``, ``paircross``).  The function is kernel
B's (:mod:`pyfft_tpu_torch.ops.welch`) at ``nch = 0`` or ``1``: optional
causal FIR (up to 1024 taps), the global mean of each filtered signal
removed (``detrend_style`` 1) or not (0), ``navr`` segments of ``nwins``
every ``hop`` through ``win``, sums of ``|X|^2`` (auto) or of ``|X|^2``,
``|Y|^2``, ``Y conj(X)`` (pair), times ``norm``; the caller applies the
one-sided doubling.

The TPU's packing (parts of the segment range as virtual channels, to fill
128 lanes) is a layout of that machine and is not carried over.  On the
card two real sequences share one complex FFT: segments ``2p`` and
``2p+1`` of the signal (auto), or segment ``s`` of ``x`` and of ``y``
(pair), split again by the symmetry ``Z_{N-k}``: half the FFTs of kernel B
for the same inputs.  Kernel H is kernel B's real kernel
(``csrc/welch_pair.cu``) in its packed modes, launched by the one wrapper
of both.

- On CUDA tensors ``ops.welch.welch_cuda(..., packed=True)`` launches
  kernel H, counted by ``ops.welch.PACKED_LAUNCHES``.
- On CPU tensors :func:`~pyfft_tpu_torch.ops.welch.welch_plain` runs, in
  the input's dtype: it is kernel H's plain version too.
- The entries compute on the port's device
  (:func:`pyfft_tpu_torch.config.resolve_device`): ``device=``, else the
  first tensor argument's, else the package default, else the card.

The geometry gates are copies of the JAX package's
(``_v3_geometry``, ``packed_parts_geometry``, ``packed_pair_geometry``):
they decide the entries' domain and the ``PYFFT_PACKED`` route
(:func:`pyfft_tpu_torch.spectral.pallas_route`), not the kernel's layout,
which takes any power of two ``nwins`` in 16..16384 and any hop.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from .welch import _run, _split

__all__ = ["welch_auto_packed", "welch_pair_packed", "packed_parts_geometry",
           "packed_pair_geometry"]

_LANES = 128


# --------------------------------------------------------------------------- #
# The JAX package's gates (copies of pyfft_tpu/ops/pallas_welch3.py)
# --------------------------------------------------------------------------- #

def _v3_geometry(nwins, noverlap, nch):
    """(R, hr, Sseg, blk, L) when TPU kernel #1 applies, else None."""
    if nwins % _LANES:
        return None
    R = nwins // _LANES
    if _LANES % R:
        return None
    hop = nwins - noverlap
    if hop <= 0 or hop % _LANES:
        return None
    hr = hop // _LANES
    Sseg = _LANES // R
    blk = Sseg * hr
    L = blk + R
    if L > 2 * _LANES:
        return None
    if blk % max(R, 8):
        return None
    if nch + 1 > 16:
        return None
    return R, hr, Sseg, blk, L


def packed_parts_geometry(navr, nwins, noverlap, parts=16):
    """``(P, q, Lp)`` where the JAX package packs one signal into ``P``
    virtual channels of ``q`` segments spanning ``Lp`` samples, or None
    (then :func:`welch_auto_packed` raises)."""
    hop = nwins - noverlap
    P = int(min(parts, navr, 16))
    if P <= 1:
        return None
    q = -(-navr // P)
    P = -(-navr // q)
    if P <= 1 or _v3_geometry(nwins, noverlap, P - 1) is None:
        return None
    Lp = (q - 1) * hop + nwins
    return P, q, Lp


def packed_pair_geometry(navr, nwins, noverlap, parts=8):
    """``(P, q, Lp)`` of the paired packing (two channels per part,
    ``P <= 8``), or None (then :func:`welch_pair_packed` raises and the
    ``PYFFT_PACKED`` route is not taken)."""
    hop = nwins - noverlap
    P = int(min(parts, navr, 8))
    if P <= 1:
        return None
    q = -(-navr // P)
    P = -(-navr // q)
    if P <= 1 or _v3_geometry(nwins, noverlap, 2 * P - 1) is None:
        return None
    return P, q, (q - 1) * hop + nwins


# --------------------------------------------------------------------------- #
# Entries (JAX package names)
# --------------------------------------------------------------------------- #

def _signal(a, device):
    a = torch.as_tensor(a, device=device)
    return a.to(torch.float32).reshape(-1).contiguous()


def _packed(x, ys, win, nfreq, norm, *, navr, nwins, noverlap, taps,
            detrend_style):
    """The four outputs of kernel H (plain version on the CPU) on ``x
    (nt,)`` and ``ys (0, nt)`` or ``(1, nt)``."""
    return _split(_run(x, ys, win, int(nfreq), norm, navr=navr, nwins=nwins,
                       hop=int(nwins) - int(noverlap), taps=taps,
                       detrend_style=detrend_style, packed=True))


def welch_auto_packed(x, win, nfreq, norm, *, navr, nwins, noverlap,
                      taps=None, detrend_style=1, parts=16, device=None):
    """Single-signal Welch auto-PSD: ``welch_fir_pallas3(x, zeros((0, nt)),
    ...)[0]`` with two segments per complex FFT (kernel H on the card).
    ``x`` is cast to float32, as the JAX entry casts it; returns ``Pxx
    (nfreq,)``.  Raises ``ValueError`` where the JAX package's
    :func:`packed_parts_geometry` (with ``parts``) is None, or for a
    detrend other than mean/none."""
    if packed_parts_geometry(navr, nwins, noverlap, parts) is None:
        raise ValueError("packing not applicable for this geometry")
    if detrend_style not in (0, 1):
        raise ValueError("v3 welch kernel supports detrend mean/none")
    x = _signal(x, resolve_device(device, x))
    return _packed(x, x.new_empty((0, x.shape[0])), win, nfreq, norm,
                   navr=navr, nwins=nwins, noverlap=noverlap, taps=taps,
                   detrend_style=detrend_style)[0]


def welch_pair_packed(x, y, win, nfreq, norm, *, navr, nwins, noverlap,
                      taps=None, detrend_style=1, parts=8, device=None):
    """Single-cross-channel Welch: ``welch_fir_pallas3(x, y[None], ...)``
    with ``x`` and ``y`` segments sharing one complex FFT (kernel H on the
    card).  ``y`` is ``(nt,)`` or ``(1, nt)``; both are cast to float32.
    Returns ``(Pxx (nfreq,), Pyy (1, nfreq), Pxy_re (1, nfreq), Pxy_im (1,
    nfreq))`` with ``Pxy = Y conj(X)``.  Raises ``ValueError`` where the
    JAX package's :func:`packed_pair_geometry` (with ``parts``) is None, or
    for a detrend other than mean/none."""
    if packed_pair_geometry(navr, nwins, noverlap, parts) is None:
        raise ValueError("pair packing not applicable for this geometry")
    if detrend_style not in (0, 1):
        raise ValueError("v3 welch kernel supports detrend mean/none")
    dev = resolve_device(device, x, y)
    return _packed(_signal(x, dev), _signal(y, dev)[None], win, nfreq, norm,
                   navr=navr, nwins=nwins, noverlap=noverlap, taps=taps,
                   detrend_style=detrend_style)
