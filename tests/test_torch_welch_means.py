"""The means kernel (``pyfft_tpu_torch/csrc/means.cu``) as a NumPy model.

The kernel runs only on a card (tests/test_torch_cuda.py holds it there
to its torch twin, ``welch._means_plain``).  Here its float64 steps are
repeated in NumPy, each addition and product rounded on its own as the
kernel rounds them: the total over the float32 block sums (torch's sums of
4096 samples, as the kernel is fed them) and the total over the
remainder, each as ``kThreads`` strided partials, a shuffle tree in each
warp and the warps in order; the tail's suffix sums as one sequential
prefix; the tap dot in tap order; the divide by ``nt``; the float32 cast.
The twin (``welch._means`` on CPU tensors) does the same float64
arithmetic in a different order (torch's float64 sums, a BLAS dot for
the taps), so the two need not agree for every input: they are equal
after the float32 cast on the seeded inputs here, over a range of ``nt``,
taps counts and row strides, on real and complex signals.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfft_tpu_torch.ops import welch as pw

_SRC = Path(pw.__file__).resolve().parent.parent / "csrc" / "means.cu"


def _constant(name):
    """An ``int`` constant of ``csrc/means.cu``."""
    m = re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text())
    return int(m.group(1))


_THREADS = _constant("kThreads")


def _block_sum(v):
    """``block_sum`` of csrc/means.cu over the float64 values ``v``."""
    acc = np.zeros(_THREADS)
    for s in range(0, v.size, _THREADS):
        chunk = v[s:s + _THREADS]
        acc[:chunk.size] = acc[:chunk.size] + chunk
    lanes = acc.reshape(_THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
    total = lanes[0, 0]
    for w in range(1, _THREADS // 32):
        total = total + lanes[w, 0]
    return total


def _model_means(x, y, taps):
    """``means_kernel``'s operand for ``x (nt,)`` and ``y (nch, nt)`` (CPU
    tensors, float32 or complex64) and float64 ``taps``."""
    rows = torch.cat([x[None], y])
    blk = pw._block_sums(rows)
    if rows.is_complex():
        rows, blk = torch.view_as_real(rows), torch.view_as_real(blk)
    else:
        rows, blk = rows[..., None], blk[..., None]
    rows = rows.numpy().astype(np.float64)
    blk = blk.numpy().astype(np.float64)
    nt = rows.shape[1]
    m = blk.shape[1] * pw._SUM_BLOCK
    K = taps.size
    out = []
    for r in range(rows.shape[0]):
        for p in range(rows.shape[2]):
            row = rows[r, :, p]
            S = _block_sum(blk[r, :, p]) + _block_sum(row[m:])
            if K == 1:
                acc = S * taps[0]
            else:
                T = acc = 0.0
                for k in range(K):
                    T = T + (row[nt - k] if 1 <= k <= nt else 0.0)
                    acc = acc + (S - T) * taps[k]
            out.append(acc / nt)
    return np.asarray(out).astype(np.float32)


def test_model_reads_the_kernels_block():
    """The model's block sums and the kernel's agree on the sizes: the
    block of csrc/means.cu is the wrapper's ``_SUM_BLOCK`` and whole
    warps."""
    assert _constant("kSumBlock") == pw._SUM_BLOCK
    assert _THREADS % 32 == 0


@pytest.mark.parametrize("nt", [300, 4096, 9001, 65536 + 123])
@pytest.mark.parametrize("K", [1, 2, 129, 1024])
@pytest.mark.parametrize("cplx", [False, True])
def test_means_kernel_model_matches_the_twin(nt, K, cplx):
    """The NumPy model of csrc/means.cu gives ``welch._means``' float32
    operand, equal on these seeded inputs: x and three channel rows with a
    row stride, each with an offset; ``K - 1 > nt`` at the shortest
    signal."""
    rng = np.random.default_rng(nt * 7 + K)
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((3, nt)) - 0.2
    dt = torch.float32
    if cplx:
        x = x + 1j * (rng.standard_normal(nt) - 0.1)
        y = y + 1j * (rng.standard_normal((3, nt)) + 0.4)
        dt = torch.complex64
    x = torch.as_tensor(x, dtype=dt)
    y = torch.nn.functional.pad(torch.as_tensor(y, dtype=dt), (0, 5))[:, :nt]
    taps = rng.standard_normal(K) / K
    twin = pw._means(x, y, taps, 1, cplx).numpy()
    assert twin.dtype == np.float32
    np.testing.assert_array_equal(_model_means(x, y, taps), twin)
    # no channels (kernel H's one signal)
    np.testing.assert_array_equal(_model_means(x, y[:0], taps),
                                  pw._means(x, y[:0], taps, 1, cplx).numpy())
