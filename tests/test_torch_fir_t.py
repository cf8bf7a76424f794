"""Kernel I's entry (pyfft_tpu_torch.ops.fir.fir_transpose_pallas) against
the JAX package's FIR-transpose feeder.

On the CPU the port's entry runs kernel I's plain version; the JAX side
runs its Pallas kernel in interpret mode at precision 'highest'.  Both
compute in float32: max |diff| <= 1e-5 * max |JAX|, and the rows past the
signal are exact zeros on both sides.  The kernel itself runs only on a
CUDA card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu.filters import firwin
from pyfft_tpu.ops import pallas_fir as jfir

from pyfft_tpu_torch.ops import fir as pfir
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


@pytest.mark.parametrize("nch,nr,ntaps,nrows_out,sub", [
    (3, 256, 129, 384, True),     # zero tail rows, sub_row
    (3, 256, 129, 256, False),    # no tail
    (0, 128, 33, 192, True),      # no channels: C = 1
    (2, 96, 1, 128, False),       # taps = (1.0,): a pure interleave
    (1, 512, 700, 512, True),     # taps over five rows of halo
    (4, 64, 63, 32, False),       # fewer rows out than in the signal
])
def test_fir_transpose_matches_jax(nch, nr, ntaps, nrows_out, sub):
    rng = np.random.default_rng(nr + ntaps)
    nt = 128 * nr
    C = nch + 1
    x = (rng.standard_normal(nt) + 0.3).astype(np.float32)
    y = rng.standard_normal((nch, nt)).astype(np.float32)
    taps = (np.ones(1) if ntaps == 1
            else np.asarray(firwin(ntaps, [0.05, 0.45], pass_zero=False)))
    sub_row = (rng.standard_normal((1, C * 128)).astype(np.float32)
               if sub else None)
    J = np.asarray(jfir.fir_transpose_pallas(
        x, y, taps, nrows_out, interpret=True, precision="highest",
        sub_row=None if sub_row is None else jnp.asarray(sub_row)))
    P = pfir.fir_transpose_pallas(torch.from_numpy(x), torch.from_numpy(y),
                                  taps, nrows_out,
                                  sub_row=None if sub_row is None
                                  else torch.from_numpy(sub_row))
    assert P.dtype == torch.float32 and P.shape == J.shape == (nrows_out,
                                                               C * 128)
    assert np.abs(P.numpy() - J).max() <= 1e-5 * np.abs(J).max()
    if nrows_out > nr:
        assert not np.any(P.numpy()[nr:]) and not np.any(J[nr:])


def test_fir_transpose_layout():
    """out[r, c*128 + l] is signal c's filtered sample 128 r + l, less
    sub_row[0, c*128 + l], in float64 to 1e-12; taps (1.0,) interleave
    exactly."""
    rng = np.random.default_rng(0)
    nt = 128 * 20
    x = torch.as_tensor(rng.standard_normal(nt))
    y = torch.as_tensor(rng.standard_normal((2, nt)))
    taps = rng.standard_normal(200)
    sub = rng.standard_normal((1, 3 * 128))
    out = pfir.fir_transpose_plain(x, y, taps, 24, torch.as_tensor(sub))
    sig = np.stack([x.numpy(), *y.numpy()])
    for c in range(3):
        f = np.convolve(sig[c], taps, "full")[:nt]
        want = f.reshape(20, 128) - sub[0, c * 128:(c + 1) * 128]
        got = out.numpy()[:20, c * 128:(c + 1) * 128]
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert not out[20:].any()
    inter = pfir.fir_transpose_pallas(x, y, (1.0,), 20)
    assert torch.equal(inter.reshape(20, 3, 128).permute(1, 0, 2)
                       .reshape(3, nt), torch.cat([x[None], y]).float())


def test_fir_transpose_raises_as_jax_does():
    """The JAX entry's three errors, with the same domain: more than 1024
    taps, nt % 128, and no row blocking above the halo row count."""
    x = np.zeros(128 * 998, np.float32)
    y = np.zeros((1, x.size), np.float32)
    for pkg in (jfir, pfir):
        with pytest.raises(ValueError, match="taps > 1024"):
            pkg.fir_transpose_pallas(x, y, np.ones(1025), 998)
        with pytest.raises(ValueError, match="nt % 128"):
            pkg.fir_transpose_pallas(x[:-1], y[:, :-1], np.ones(3), 998)
        with pytest.raises(ValueError, match="no row blocking"):
            pkg.fir_transpose_pallas(x, y, np.ones(200), 998)
    for args in ((128 * 998, 998, 200), (128 * 1024, 1536, 129),
                 (128 * 250, 250, 1), (100, 1, 3), (128 * 64, 96, 300)):
        assert pfir.fir_transpose_blocking(*args) == \
            jfir.fir_transpose_blocking(*args)
    # the kernel wrapper never runs CPU tensors: it raises
    with pytest.raises(ValueError, match="CUDA"):
        pfir.fir_t_cuda(torch.zeros(256), torch.zeros(1, 256), np.ones(3),
                        2)
