"""The middle section of the factored analytic-signal transform: kernel D
and its plain version.

Counterpart of :func:`pyfft_tpu.hilbert._hilb_slab_kernel` (launched by
``_analytic_factored_slab``).  The transform of ``N = n1 * M`` samples is
split as a four-step FFT: ``x`` viewed as ``(n1, M)``; the outer n1-point
DFT over its columns (``torch.fft``, as the JAX package leaves the outer
stage to XLA); then, for each row ``k1`` of that outer spectrum, the rows'
section that this module computes:

    twiddle W_N^(m k1) -> M-point DFT -> analytic mask at k = k1 + n1 k'
    -> inverse M-point DFT (1/M) -> conjugate twiddle;

then the inverse n1-point DFT over the columns (its 1/n1 completes 1/N).

The split is a pure function of ``nfft`` (:func:`row_split`): ``M`` is the
largest power of two that divides ``nfft``, capped at ``ROW_DEFAULT =
8192``, and ``n1 = nfft / M``.  A length whose power-of-two part is below
16 has no split.  Bench config 4 (``nfft = 2**24``) gives ``n1 = 2048``,
``M = 8192``; ``9 * 2**20`` gives ``n1 = 1152``.  The kernel takes rows of
up to ``ROW_MAX = 16384`` points (139 KB of padded complex64 in shared
memory, one block per SM); rows of 8192 (68 KB, two blocks per SM)
measured faster on the card (PERF.md, config 4).

- On CUDA tensors :func:`hilbert_cuda` launches kernel D
  (``csrc/hilbert.cu``, both row transforms on ``csrc/fft_reg.cuh``) on
  complex64 rows.
- On CPU tensors :func:`hilbert_plain` runs the same rows through
  ``torch.fft`` in the input's dtype (twiddles from float64).

``LAUNCHES`` counts the launches of kernel D.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .welch import _twiddles

__all__ = ["row_split", "hilbert_rows", "hilbert_plain", "hilbert_cuda",
           "blocks_per_sm", "ROW_MIN", "ROW_MAX", "ROW_DEFAULT", "LAUNCHES"]

ROW_MIN = 16
ROW_MAX = 16384
ROW_DEFAULT = 8192

LAUNCHES = 0


def row_split(nfft, max_row=ROW_DEFAULT):
    """``(n1, M)`` with ``n1 * M == nfft``: ``M`` the largest power of two
    dividing ``nfft`` and at most ``max_row``; None when that is below 16."""
    nfft = int(nfft)
    if nfft < ROW_MIN:
        return None
    M = min(nfft & -nfft, int(max_row))
    if M < ROW_MIN:
        return None
    return nfft // M, M


def _nyquist(N):
    return (N + 1) // 2 if N % 2 else N // 2


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #

def hilbert_plain(rows):
    """Plain PyTorch version of kernel D on ``rows (n1, M)`` complex, in
    their dtype: twiddle, ``torch.fft.fft`` along the rows, analytic mask,
    ``torch.fft.ifft``, conjugate twiddle."""
    n1, M = rows.shape
    N = n1 * M
    dev = rows.device
    k1 = torch.arange(n1, dtype=torch.int64, device=dev)[:, None]
    m = torch.arange(M, dtype=torch.int64, device=dev)[None, :]
    ang = (-2.0 * np.pi / N) * ((k1 * m) % N).to(torch.float64)
    w = torch.polar(torch.ones_like(ang), ang).to(rows.dtype)
    X = torch.fft.fft(rows * w, dim=-1)
    k = k1 + n1 * m                                  # bin of X[k1, k']
    nyq = _nyquist(N)
    real = X.real.dtype
    h = torch.where((k == 0) | (k == nyq), 1.0,
                    torch.where(k < nyq, 2.0, 0.0)).to(real)
    return torch.fft.ifft(X * h, dim=-1) * w.conj()


# --------------------------------------------------------------------------- #
# Kernel D
# --------------------------------------------------------------------------- #

def hilbert_cuda(rows):
    """Launch kernel D on ``rows (n1, M)`` complex64, contiguous, on a CUDA
    device, ``M`` a power of two in 16..16384.  Returns new rows."""
    global LAUNCHES
    if not (isinstance(rows, torch.Tensor) and rows.is_cuda):
        raise ValueError("hilbert_cuda needs rows on a CUDA device")
    if rows.dtype != torch.complex64 or rows.dim() != 2 \
            or not rows.is_contiguous():
        raise ValueError(f"hilbert_cuda takes contiguous (n1, M) complex64 "
                         f"rows, got {tuple(rows.shape)} {rows.dtype}")
    n1, M = rows.shape
    if not (ROW_MIN <= M <= ROW_MAX and M & (M - 1) == 0) or n1 < 1 \
            or n1 >= 1 << 31:
        raise ValueError(f"hilbert kernel: unsupported rows n1={n1} M={M}")
    dev = rows.device
    out = torch.empty_like(rows)
    tw = _twiddles(M, str(dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pyfft_hilbert(rows.data_ptr(), out.data_ptr(), tw.data_ptr(),
                               int(n1), int(M), stream)
        _build.check(rc, "hilbert kernel")
    LAUNCHES += 1
    return out


def blocks_per_sm(M):
    """Resident blocks of kernel D per SM for rows of ``M`` points, as the
    CUDA occupancy calculator gives them on the current device."""
    n = _build.library().pyfft_hilbert_blocks_per_sm(int(M))
    if n < 0:
        _build.check(-n, "hilbert occupancy")
    return n


def hilbert_rows(rows):
    """The rows' section on ``rows``' device: kernel D on a CUDA tensor
    (cast to complex64), :func:`hilbert_plain` on a CPU tensor."""
    if rows.is_cuda:
        return hilbert_cuda(rows.to(torch.complex64).contiguous())
    return hilbert_plain(rows)
