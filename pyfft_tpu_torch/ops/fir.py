"""Causal multichannel FIR: kernel A and its plain PyTorch version.

Counterpart of :mod:`pyfft_tpu.ops.pallas_fir`.  ``fir_pallas(x, taps)``
computes ``np.convolve(x[c], taps, 'full')[:nt]`` for every channel of
``x (nch, nt)`` (or ``(nt,)``):

- on a CUDA tensor it launches kernel A (``csrc/fir.cu``, float32);
- on a CPU tensor it runs :func:`fir_plain`, in the tensor's own dtype.

A CUDA tensor never falls back to the plain version: the kernel launches or
the call raises.  ``LAUNCHES`` counts the launches of kernel A, also those
by which kernel B's wrapper filters its reference ahead
(:mod:`pyfft_tpu_torch.ops.welch`).  The entries compute on the port's
device (:func:`pyfft_tpu_torch.config.resolve_device`): ``device=``, else
the first tensor argument's, else the package default, else the card.

``tile_rows`` / ``untile_rows`` / ``fir_pallas_tiled`` are thin aliases of
the JAX package's row-view entries.  The ``(nch, nrows, 128)`` row view is
a TPU layout device (it avoids a physical retiling there); here it is a
free reshape, and the tiled entry filters the flattened rows.

``fir_transpose_pallas`` is the FIR-transpose feeder (TPU kernel #6,
``pallas_fir.py::_fir_t_kernel``): the same filter of ``x`` and the rows
of ``y`` written into the channel-interleaved ``(nrows_out, C*128)``
layout, ``out[r, c*128 + l] = fir(sig_c)[128 r + l] - sub_row[0, c*128 +
l]``, rows past the signal exactly zero.  On CUDA tensors it launches
kernel I (``csrc/fir.cu``, counted by ``FIR_T_LAUNCHES``); on CPU tensors
:func:`fir_transpose_plain` runs.  It keeps the JAX entry's domain and
errors (``nt % 128``, more than 1024 taps, no legal row blocking), though
the kernel itself needs no row blocking.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ..config import resolve_device

__all__ = ["fir_pallas", "fir_plain", "fir_cuda", "fir_pallas_tiled",
           "tile_rows", "untile_rows", "fir_transpose_pallas",
           "fir_transpose_blocking", "fir_transpose_plain", "fir_t_cuda",
           "PALLAS_FIR_MAX_TAPS", "LAUNCHES", "FIR_T_LAUNCHES"]

PALLAS_FIR_MAX_TAPS = 1024
_LANES = 128
# the JAX feeder's VMEM budget, which its row blocking must fit
_VMEM_BUDGET = 14 * 1024 * 1024

LAUNCHES = 0
FIR_T_LAUNCHES = 0


def _check_taps(taps):
    taps = np.asarray(taps, dtype=np.float64).ravel()
    if not 1 <= taps.size <= PALLAS_FIR_MAX_TAPS:
        raise ValueError(
            f"{taps.size} taps outside 1..{PALLAS_FIR_MAX_TAPS}; use the "
            "overlap-save path (filters.oaconvolve) for long filters")
    return taps


def fir_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """Plain version of kernel A: left-pad by K-1 zeros, then ``conv1d``
    with the reversed taps, in ``x``'s dtype (real or complex)."""
    taps = np.asarray(taps, dtype=np.float64).ravel()
    if x.is_complex():
        return torch.complex(fir_plain(x.real, taps), fir_plain(x.imag, taps))
    lead = x.shape[:-1]
    nt = x.shape[-1]
    w = torch.as_tensor(taps[::-1].copy(), dtype=x.dtype, device=x.device)
    xp = F.pad(x.reshape(-1, 1, nt), (taps.size - 1, 0))
    return F.conv1d(xp, w.view(1, 1, -1)).reshape(*lead, nt)


def fir_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    """Kernel A on ``x (nch, nt)`` float32, contiguous, on a CUDA device."""
    global LAUNCHES
    taps = _check_taps(taps)
    if not x.is_cuda:
        raise ValueError(f"fir_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            "fir_cuda takes a contiguous (nch, nt) float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    nch, nt = x.shape
    if nch > 65535:
        raise ValueError(f"fir_cuda takes at most 65535 channels, got {nch}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    t = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pyfft_fir(x.data_ptr(), t.data_ptr(), y.data_ptr(), nch, nt,
                           int(t.numel()), stream)
        _build.check(rc, "fir kernel")
    LAUNCHES += 1
    return y


def fir_pallas(x, taps, device=None) -> torch.Tensor:
    """Causal FIR of ``x (nch, nt) | (nt,)`` with ``taps`` (K <= 1024).

    CUDA tensors go through kernel A in float32 (as the JAX kernel casts
    to float32); CPU tensors take :func:`fir_plain` in their own dtype.
    """
    taps = _check_taps(taps)
    x = torch.as_tensor(x, device=resolve_device(device, x))
    squeeze = x.dim() == 1
    x2 = x[None] if squeeze else x
    if x2.is_cuda:
        y = fir_cuda(x2.to(torch.float32).contiguous(), taps)
    else:
        y = fir_plain(x2, taps)
    return y[0] if squeeze else y


def tile_rows(x, block_rows=512, device=None):
    """``x (nch, nt) | (nt,) -> (xr (nch, nrows, 128), nt)``, zero-padded
    so ``nrows`` is a multiple of ``block_rows`` (rounded up to 8)."""
    x = torch.as_tensor(x, device=resolve_device(device, x))
    if x.dim() == 1:
        x = x[None]
    nch, nt = x.shape
    block_rows = max(8, int(block_rows) + (-int(block_rows)) % 8)
    nrows = -(-nt // (block_rows * _LANES)) * block_rows
    x = F.pad(x, (0, nrows * _LANES - nt))
    return x.reshape(nch, nrows, _LANES), nt


def untile_rows(xr, nt):
    """Inverse of :func:`tile_rows`: ``(nch, nrows, 128) -> (nch, nt)``."""
    return xr.reshape(xr.shape[0], -1)[:, :nt]


def fir_pallas_tiled(xr, taps, device=None):
    """Causal FIR on the row view, same layout in and out: channel ``c``
    of the flattened rows is filtered as one signal."""
    xr = torch.as_tensor(xr, device=resolve_device(device, xr))
    if xr.dim() != 3 or xr.shape[-1] != _LANES:
        raise ValueError(f"expected (nch, nrows, {_LANES}) from tile_rows, "
                         f"got {tuple(xr.shape)}")
    nch = xr.shape[0]
    return fir_pallas(xr.reshape(nch, -1), taps).reshape(xr.shape)


# --------------------------------------------------------------------------- #
# FIR-transpose feeder: kernel I
# --------------------------------------------------------------------------- #

def fir_transpose_blocking(nt, nrows_out, ntaps, block_rows=512):
    """The JAX package's row blocking for this geometry (a copy of
    ``pallas_fir.fir_transpose_blocking``), or None where none is legal:
    ``nt % 128``, or no common divisor of ``nt//128`` and ``nrows_out`` at
    or below ``block_rows`` above the halo row count.  It sets the entry's
    domain; kernel I does not block by rows."""
    if nt % _LANES:
        return None
    nr = nt // _LANES
    m = -(-(ntaps - 1) // _LANES)
    rows = int(max(1, min(block_rows, 1024)))
    while nr % rows or nrows_out % rows:
        rows //= 2
        if rows < 1:
            return None
    return rows if rows > m else None


def fir_transpose_plain(x, y, taps, nrows_out, sub_row=None):
    """Plain version of kernel I: :func:`fir_plain` of ``[x; y]``, then the
    interleave by reshape and permute, ``sub_row`` subtracted, and zero
    rows past the signal, in the inputs' dtype."""
    sig = torch.cat([x[None], y.to(x.dtype)])
    C, nt = sig.shape
    nr = nt // _LANES
    f = fir_plain(sig, taps).reshape(C, nr, _LANES)
    if sub_row is not None:
        f = f - torch.as_tensor(sub_row, dtype=f.dtype,
                                device=f.device).reshape(C, 1, _LANES)
    f = f.permute(1, 0, 2).reshape(nr, C * _LANES)
    out = f.new_zeros((nrows_out, C * _LANES))
    rows = min(nr, nrows_out)
    out[:rows] = f[:rows]
    return out


def fir_t_cuda(x, y, taps, nrows_out, sub_row=None):
    """Kernel I on ``x (nt,)`` contiguous and ``y (nch, nt)`` with unit time
    stride, float32 on one CUDA device; ``sub_row`` None or ``C*128``
    float32 values.  Returns ``(nrows_out, C*128)`` float32."""
    global FIR_T_LAUNCHES
    taps = _check_taps(taps)
    if not (x.is_cuda and y.device == x.device):
        raise ValueError("fir_t_cuda needs x and y on one CUDA device")
    nch, nt = y.shape
    if x.dtype != torch.float32 or y.dtype != torch.float32 \
            or x.shape != (nt,) or not x.is_contiguous() \
            or (nch and y.stride(1) != 1):
        raise ValueError(
            "fir_t_cuda takes x (nt,) contiguous and y (nch, nt) with unit "
            f"time stride, float32, got {tuple(x.shape)} {x.dtype} and "
            f"{tuple(y.shape)} {y.dtype}")
    C = nch + 1
    if nt % _LANES or C > 65535 or nrows_out < 1:
        raise ValueError(f"fir_t_cuda: unsupported nt={nt}, C={C}, "
                         f"nrows_out={nrows_out}")
    sub = None
    if sub_row is not None:
        sub = torch.as_tensor(sub_row, dtype=torch.float32,
                              device=x.device).reshape(-1).contiguous()
        if sub.numel() != C * _LANES:
            raise ValueError(f"sub_row of {sub.numel()} values, need "
                             f"{C * _LANES}")
    out = torch.empty((nrows_out, C * _LANES), dtype=torch.float32,
                      device=x.device)
    t = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pyfft_fir_t(
            x.data_ptr(), y.data_ptr() if nch else x.data_ptr(),
            y.stride(0) if nch else 0, nch, t.data_ptr(), int(t.numel()),
            None if sub is None else sub.data_ptr(), out.data_ptr(), nt,
            int(nrows_out), stream)
        _build.check(rc, "fir-transpose kernel")
    FIR_T_LAUNCHES += 1
    return out


def fir_transpose_pallas(x, y, taps, nrows_out, block_rows=512,
                         sub_row=None, device=None):
    """Filter ``[x; y]`` and emit the interleaved ``(nrows_out, C*128)``
    layout (module docstring), ``C = nch + 1`` (1 when ``y`` has no
    channels).  ``taps=(1.0,)`` gives a pure interleave.  ``sub_row``
    (``(1, C*128)``): subtracted from every signal row after filtering;
    rows past the signal stay exactly zero.  Signals are cast to float32;
    CUDA tensors launch kernel I, CPU tensors take the plain version.
    Raises ``ValueError`` where the JAX entry does."""
    taps = np.asarray(taps, dtype=np.float64)
    K = taps.size
    if K > PALLAS_FIR_MAX_TAPS:
        raise ValueError(f"{K} taps > {PALLAS_FIR_MAX_TAPS}")
    dev = resolve_device(device, x, y)
    x = torch.as_tensor(x, device=dev).to(torch.float32).contiguous()
    y = torch.as_tensor(y, device=dev).to(torch.float32)
    if y.shape[0] and y.stride(-1) != 1:
        y = y.contiguous()
    nt = x.shape[-1]
    C = y.shape[0] + 1
    if nt % _LANES:
        raise ValueError("fir_transpose_pallas needs nt % 128 == 0")
    m = -(-(K - 1) // _LANES)
    rows = fir_transpose_blocking(nt, nrows_out, K, block_rows)
    while rows is not None and 2 * (2 * C * rows * _LANES * 4) > _VMEM_BUDGET:
        rows = fir_transpose_blocking(nt, nrows_out, K, rows // 2)
    if rows is None:
        raise ValueError(
            f"no row blocking > m={m} divides nr={nt // _LANES} and "
            f"nrows_out={nrows_out}; use fir_pallas with padding instead")
    if x.is_cuda:
        return fir_t_cuda(x, y, taps, int(nrows_out), sub_row)
    return fir_transpose_plain(x, y, taps, int(nrows_out), sub_row)
