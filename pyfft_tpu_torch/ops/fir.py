"""Causal multichannel FIR: kernel A and its plain PyTorch version.

Counterpart of :mod:`pyfft_tpu.ops.pallas_fir`.  ``fir_pallas(x, taps)``
computes ``np.convolve(x[c], taps, 'full')[:nt]`` for every channel of
``x (nch, nt)`` (or ``(nt,)``):

- on a CUDA tensor it launches kernel A (``csrc/fir.cu``, float32);
- on a CPU tensor it runs :func:`fir_plain`, in the tensor's own dtype.

A CUDA tensor never falls back to the plain version: the kernel launches or
the call raises.  ``LAUNCHES`` counts the launches of kernel A.

``tile_rows`` / ``untile_rows`` / ``fir_pallas_tiled`` are thin aliases of
the JAX package's row-view entries.  The ``(nch, nrows, 128)`` row view is
a TPU layout device (it avoids a physical retiling there); here it is a
free reshape, and the tiled entry filters the flattened rows.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fir_pallas", "fir_plain", "fir_cuda", "fir_pallas_tiled",
           "tile_rows", "untile_rows", "PALLAS_FIR_MAX_TAPS", "LAUNCHES"]

PALLAS_FIR_MAX_TAPS = 1024
_LANES = 128

LAUNCHES = 0


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


def fir_pallas(x, taps) -> torch.Tensor:
    """Causal FIR of ``x (nch, nt) | (nt,)`` with ``taps`` (K <= 1024).

    CUDA tensors go through kernel A in float32 (as the JAX kernel casts
    to float32); CPU tensors take :func:`fir_plain` in their own dtype.
    """
    taps = _check_taps(taps)
    x = torch.as_tensor(x)
    squeeze = x.dim() == 1
    x2 = x[None] if squeeze else x
    if x2.is_cuda:
        y = fir_cuda(x2.to(torch.float32).contiguous(), taps)
    else:
        y = fir_plain(x2, taps)
    return y[0] if squeeze else y


def tile_rows(x, block_rows=512):
    """``x (nch, nt) | (nt,) -> (xr (nch, nrows, 128), nt)``, zero-padded
    so ``nrows`` is a multiple of ``block_rows`` (rounded up to 8)."""
    x = torch.as_tensor(x)
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


def fir_pallas_tiled(xr, taps):
    """Causal FIR on the row view, same layout in and out: channel ``c``
    of the flattened rows is filtered as one signal."""
    xr = torch.as_tensor(xr)
    if xr.dim() != 3 or xr.shape[-1] != _LANES:
        raise ValueError(f"expected (nch, nrows, {_LANES}) from tile_rows, "
                         f"got {tuple(xr.shape)}")
    nch = xr.shape[0]
    return fir_pallas(xr.reshape(nch, -1), taps).reshape(xr.shape)
