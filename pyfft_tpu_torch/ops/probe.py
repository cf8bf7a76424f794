"""Kernels F and G, the probes of
:func:`pyfft_tpu_torch.utils.profiling.measure_pipeline_overlap`, and their
plain versions.

Counterparts of ``mem_kernel`` and ``fused_kernel`` in
:func:`pyfft_tpu.utils.profiling.measure_pipeline_overlap`, over ``x
(nrows, N)`` float32 in row blocks of ``rows_blk`` rows:

- :func:`colsum` (kernel F, ``csrc/probe.cu``): the column sums of ``x``,
  ``(1, N)`` float32, reading every row block once (the memory probe);
- :func:`chain` (kernel G, ``csrc/probe.cu``): for every 128-row group of a
  row block, ``passes`` chained products ``y <- bf16(T @ y)`` (``T (128,
  128)`` bf16, float32 accumulation, ``y`` starting as ``bf16(x)``), then
  the column sums of all groups' results, ``(1, N)`` float32.  ``resident``
  reads row block 0 at every step (the compute probe); otherwise row block
  ``b`` at step ``b`` (the streamed probe).

On CUDA tensors the kernels launch; on CPU tensors :func:`colsum_plain`
and :func:`chain_plain` run.  ``LAUNCHES`` counts each kernel's launches
(``{"colsum": n, "chain": n}``).

Kernel G adds its products on the tensor cores, in another order than the
plain version's float32 loop, so with a dense ``T`` the two round a few
elements of each pass to neighbouring bf16 values and the chain carries
them on.  :func:`two_tap_T` gives a ``T`` whose chain every order computes
bit for bit, so that a check can hold the kernel to its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["colsum", "chain", "colsum_plain", "chain_plain", "colsum_cuda",
           "chain_cuda", "two_tap_T", "GROUP", "LAUNCHES"]

GROUP = 128

LAUNCHES = {"colsum": 0, "chain": 0}


def _blocks(x, rows_blk):
    nrows, N = x.shape
    if nrows % rows_blk:
        raise ValueError(f"{nrows} rows do not split into blocks of "
                         f"{rows_blk}")
    return x.reshape(nrows // rows_blk, rows_blk, N)


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def colsum_plain(x, rows_blk):
    """Plain version of kernel F: float32 column sums of each row block,
    then of the blocks, ``(1, N)``."""
    return _blocks(x, rows_blk).sum(1).sum(0, keepdim=True)


def chain_plain(x, T, rows_blk, passes, resident=False):
    """Plain version of kernel G, ``(1, N)``: the chain as float32
    ``torch.matmul`` of bf16 values (exact products, float32 sums, as the
    kernel and the TPU's ``preferred_element_type`` accumulate), rounded to
    bf16 after each pass.  In resident mode the one block's result counts
    once per row block."""
    blocks = _blocks(x, rows_blk)
    nb, _, N = blocks.shape
    if rows_blk % GROUP:
        raise ValueError(f"rows_blk {rows_blk} is not a multiple of {GROUP}")
    if resident:
        blocks = blocks[:1]
    y = blocks.reshape(-1, GROUP, N).to(torch.bfloat16)
    Tf = T.to(torch.float32)
    for _ in range(passes):
        y = torch.matmul(Tf, y.to(torch.float32)).to(torch.bfloat16)
    out = y.to(torch.float32).sum(dim=(0, 1)).reshape(1, N)
    return out * nb if resident else out


def two_tap_T(seed, device="cpu"):
    """A ``(128, 128)`` bf16 ``T`` with two entries of 0.5 in each row, at
    columns ``pi(i)`` and ``pi(i + 1)`` of a random permutation ``pi``.
    Every output of a pass is the sum of two halved bf16 values, which
    float32 holds exactly (unless they lie 2^15 apart, and then any order
    rounds it to the larger one's neighbourhood alike), so the chain does
    not depend on the order of the sums, while the bf16 rounding after each
    pass still drops bits."""
    pi = torch.as_tensor(np.random.default_rng(seed).permutation(GROUP))
    T = torch.zeros((GROUP, GROUP), dtype=torch.float32)
    rows = torch.arange(GROUP)
    T[rows, pi] = 0.5
    T[rows, torch.roll(pi, -1)] = 0.5
    return T.to(device=device, dtype=torch.bfloat16)


# --------------------------------------------------------------------------- #
# Kernels F and G
# --------------------------------------------------------------------------- #

def _check(x, what):
    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and x.dtype == torch.float32 and x.dim() == 2
            and x.is_contiguous()):
        raise ValueError(f"{what} takes a contiguous (nrows, N) float32 "
                         f"tensor on a CUDA device")


def colsum_cuda(x, rows_blk):
    """Launch kernel F on ``x (nrows, N)``, ``N`` a multiple of 4."""
    _check(x, "colsum_cuda")
    nrows, N = x.shape
    if N % 4 or rows_blk < 1 or nrows % rows_blk or x.data_ptr() % 16:
        raise ValueError(f"colsum kernel: unsupported shape {tuple(x.shape)} "
                         f"in blocks of {rows_blk} rows")
    part = torch.empty((nrows // rows_blk, N), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((1, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pyfft_colsum(x.data_ptr(), part.data_ptr(), out.data_ptr(),
                              nrows, N, int(rows_blk), stream)
        _build.check(rc, "colsum kernel")
    LAUNCHES["colsum"] += 1
    return out


def chain_cuda(x, T, rows_blk, passes, resident=False):
    """Launch kernel G on ``x (nrows, N)`` with ``T (128, 128)`` bf16."""
    _check(x, "chain_cuda")
    nrows, N = x.shape
    if not (isinstance(T, torch.Tensor) and T.device == x.device
            and T.dtype == torch.bfloat16 and T.shape == (GROUP, GROUP)
            and T.is_contiguous()):
        raise ValueError("chain_cuda takes T (128, 128) bf16, contiguous, "
                         "on x's device")
    if rows_blk < GROUP or rows_blk % GROUP or nrows % rows_blk \
            or passes < 0:
        raise ValueError(f"chain kernel: unsupported shape {tuple(x.shape)} "
                         f"in blocks of {rows_blk} rows, {passes} passes")
    nparts = nrows // GROUP
    part = torch.empty((nparts, N), dtype=torch.float32, device=x.device)
    out = torch.empty((1, N), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pyfft_chain(x.data_ptr(), T.data_ptr(), part.data_ptr(),
                             out.data_ptr(), nrows, N, int(rows_blk),
                             int(passes), int(bool(resident)), stream)
        _build.check(rc, "chain kernel")
    LAUNCHES["chain"] += 1
    return out


def colsum(x, rows_blk):
    """Kernel F on a CUDA tensor, :func:`colsum_plain` on a CPU tensor."""
    if x.is_cuda:
        return colsum_cuda(x, rows_blk)
    return colsum_plain(x, rows_blk)


def chain(x, T, rows_blk, passes, resident=False):
    """Kernel G on a CUDA tensor, :func:`chain_plain` on a CPU tensor."""
    if x.is_cuda:
        return chain_cuda(x, T, rows_blk, passes, resident)
    return chain_plain(x, T, rows_blk, passes, resident)
