"""Kernel B's module (pyfft_tpu_torch.ops.welch) against the JAX package.

On the CPU the port's entries run kernel B's plain version; the JAX side
runs its fused Pallas kernel in interpret mode at precision 'highest'.
Geometries follow tests/test_pallas_welch.py, with nt capped at 2**15.
The kernel itself runs only on a CUDA card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from pyfft_tpu.filters import firwin
from pyfft_tpu.ops.pallas_welch import welch_fir_pallas_fused as jax_fused
from pyfft_tpu.ops.pallas_welch3 import pallas_welch3_cplx_applicable
from pyfft_tpu.ops.pallas_welch3 import welch_pallas3_twosided as jax_twosided

from pyfft_tpu_torch.ops import welch as pw
from test_pallas_welch import _welch_oracle
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _geometry_inputs(nch, nt, nwins, hop, ntaps, seed):
    rng = np.random.default_rng(seed)
    taps = (np.asarray(firwin(ntaps, [0.05, 0.45], pass_zero=False))
            if ntaps else None)
    x = rng.standard_normal(nt).astype(np.float32) + 0.25
    y = rng.standard_normal((nch, nt)).astype(np.float32) - 0.5
    win = np.hanning(nwins + 1)[:-1]
    navr = (nt - (nwins - hop)) // hop
    return x, y, taps, win, navr


@pytest.mark.parametrize("nch,nt,nwins,hop,ntaps,detrend", [
    (3, 1 << 15, 2048, 1024, 0, 1),     # bench geometry, no FIR
    (3, 1 << 15, 2048, 1024, 129, 1),   # fused FIR
    (2, 1 << 14, 1024, 512, 129, 0),    # no detrend
    (1, 1 << 14, 2048, 2048, 0, 1),     # zero overlap
    (2, 1 << 14, 512, 128, 63, 1),      # 75% overlap, short taps
    (3, 30000, 2048, 1024, 129, 1),     # non-multiple nt, odd navr
    (2, 128 * 250, 512, 256, 200, 1),   # long taps, nt/128 even
])
def test_plain_matches_jax_kernel(nch, nt, nwins, hop, ntaps, detrend):
    """float32 on both sides: rtol 2e-5, atol 3e-5 * max (the bound of
    tests/test_pallas_welch.py for the JAX kernel against float64)."""
    x, y, taps, win, navr = _geometry_inputs(nch, nt, nwins, hop, ntaps,
                                             nch * nt % 7919)
    nov = nwins - hop
    nf = nwins // 2 + 1
    assert pw.pallas_welch2_applicable(nwins, nov, navr, nch, taps, detrend)
    kw = dict(navr=navr, nwins=nwins, noverlap=nov, taps=taps,
              detrend_style=detrend)
    J = jax_fused(x, y, win, nf, 1.0, precision="highest", interpret=True,
                  **kw)
    P = pw.welch_fir_pallas_fused(torch.from_numpy(x), torch.from_numpy(y),
                                  win, nf, 1.0, **kw)
    assert all(p.dtype == torch.float32 for p in P)
    assert P[0].shape == (nf,) and P[1].shape == (nch, nf)
    scl = np.max(np.abs(np.asarray(J[0])))
    for p, j in zip(P, J):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=3e-5 * scl)


@pytest.mark.parametrize("nch,nt,nwins,hop,ntaps,detrend", [
    (20, 1 << 13, 512, 256, 33, 1),     # more channels than the TPU's 15
    (2, 20000, 1024, 200, 129, 1),      # hop not a multiple of 128
    (1, 5000, 16, 7, 5, 0),             # smallest window, odd hop
    (0, 1 << 13, 256, 128, 0, 1),       # auto-only (no channels)
    (2, 3000, 64, 64, 1024, 1),         # taps longer than a segment
])
def test_plain_float64_matches_oracle(nch, nt, nwins, hop, ntaps, detrend):
    """Port-only geometries against the float64 loop oracle of
    tests/test_pallas_welch.py: float64 on both sides, rtol 1e-10 with
    atol 1e-10 * max (bins near zero)."""
    x, y, taps, win, navr = _geometry_inputs(nch, nt, nwins, hop, ntaps, nt)
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    nf = nwins // 2
    assert pw.pallas_welch2_applicable(nwins, nwins - hop, navr, nch, taps,
                                       detrend)
    Pxx, Pyy, Pr, Pi = pw.welch_plain(
        torch.from_numpy(x), torch.from_numpy(y), win, nf, 0.5, navr=navr,
        nwins=nwins, hop=hop, taps=taps, detrend_style=detrend)
    assert Pxx.dtype == torch.float64 and Pyy.shape == (nch, nf)
    PxxN, PyyN, PxyN = _welch_oracle(x, y, win, navr, nwins, hop, taps,
                                     detrend)
    scl = 0.5 * np.max(np.abs(PxxN))
    np.testing.assert_allclose(Pxx.numpy(), 0.5 * PxxN[:nf], rtol=1e-10,
                               atol=1e-10 * scl)
    if nch:
        np.testing.assert_allclose(Pyy.numpy(), 0.5 * PyyN[:, :nf],
                                   rtol=1e-10, atol=1e-10 * scl)
        np.testing.assert_allclose((Pr + 1j * Pi).numpy(), 0.5 * PxyN[:, :nf],
                                   rtol=1e-10, atol=1e-10 * scl)


@pytest.mark.parametrize("nchz,ntaps,detrend,nwins,nov", [
    (2, 97, 1, 512, 256),      # fused real FIR
    (1, 0, 1, 512, 256),       # one channel, no taps (the fft_pwelch route)
    (1, 97, 0, 1024, 512),     # no detrend
    (3, 0, 0, 256, 128),       # three channels
    (3, 129, 1, 512, 384),     # three channels, 75% overlap, FIR
])
def test_twosided_plain_matches_jax_kernel(nchz, ntaps, detrend, nwins, nov):
    """Complex two-sided path, with and without a fused real FIR, complex64
    on both sides, inside the JAX kernel's gate: rtol 2e-5, atol 3e-5 *
    max."""
    rng = np.random.default_rng(11 + nchz + ntaps)
    nt = 1 << 14
    navr = (nt - nov) // (nwins - nov)
    assert pallas_welch3_cplx_applicable(nwins, nov, navr, nchz, detrend)
    z = (rng.standard_normal(nt) + 1j * rng.standard_normal(nt) + 0.3)
    w = (rng.standard_normal((nchz, nt))
         + 1j * rng.standard_normal((nchz, nt)))
    taps = np.asarray(firwin(ntaps, 0.3)) if ntaps else None
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, noverlap=nov, taps=taps,
              detrend_style=detrend)
    J = jax_twosided(z.astype(np.complex64), w.astype(np.complex64), win,
                     1.0 / navr, precision="highest", interpret=True, **kw)
    P = pw.welch_pallas3_twosided(torch.from_numpy(z), torch.from_numpy(w),
                                  win, 1.0 / navr, **kw)
    assert P[0].shape == (nwins,) and P[1].shape == (nchz, nwins)
    scl = np.max(np.abs(np.asarray(J[0])))
    for p, j in zip(P, J):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=3e-5 * scl)


@pytest.mark.parametrize("K,nt", [(1, 1000), (129, 1000), (700, 300),
                                  (129, 9000)])
@pytest.mark.parametrize("cplx", [False, True])
def test_moment_identity_means(K, nt, cplx):
    """The kernel's prologue gets the filtered means from unfiltered sums
    (including K-1 > nt, more than one 4096-sample block, and channel rows
    with a stride): equal to filtering then averaging, to the
    float32 rounding of the kernel's operand (rtol 1e-6)."""
    rng = np.random.default_rng(K + nt)
    x = rng.standard_normal(nt) + 0.4
    y = rng.standard_normal((3, nt)) - 0.2
    if cplx:
        x = x + 1j * rng.standard_normal(nt)
        y = y + 1j * rng.standard_normal((3, nt))
    x = torch.from_numpy(x)
    y = torch.nn.functional.pad(torch.from_numpy(y), (0, 5))[:, :nt]
    taps = rng.standard_normal(K)
    got = pw._means(x, y, taps, 1, cplx).double()
    from pyfft_tpu_torch.ops.fir import fir_plain
    m = fir_plain(torch.cat([x[None], y]), taps).mean(-1)
    ref = torch.view_as_real(m).reshape(-1) if cplx else m
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-7 * ref.abs().max().item())
    assert pw._means(x, y, taps, 0, cplx).abs().max().item() == 0.0
    # no channels (the auto-only case)
    got0 = pw._means(x, y[:0], taps, 1, cplx).double()
    np.testing.assert_allclose(got0.numpy(), got[:got0.numel()].numpy())


def test_applicability_gates():
    taps = np.ones(129)
    assert pw.pallas_welch2_applicable(2048, 1024, 100, 8, taps)
    assert pw.pallas_welch2_applicable(2048, 1000, 100, 8)     # any hop
    assert pw.pallas_welch2_applicable(512, 256, 100, 512)     # any nch
    assert pw.pallas_welch2_applicable(16, 0, 1, 1)
    assert pw.pallas_welch2_applicable(16384, 8192, 3, 1, np.ones(1024))
    assert not pw.pallas_welch2_applicable(2000, 1000, 100, 8)  # not 2^k
    assert not pw.pallas_welch2_applicable(8, 4, 100, 8)        # < 16
    assert not pw.pallas_welch2_applicable(32768, 16384, 9, 1)  # > 16384
    assert not pw.pallas_welch2_applicable(2048, 2048, 100, 8)  # hop 0
    assert not pw.pallas_welch2_applicable(2048, 1024, 100, 8,
                                           detrend_style=-1)
    assert not pw.pallas_welch2_applicable(2048, 1024, 100, 8,
                                           np.ones(1025))
    assert pw.pallas_welch2_applicable(512, 200, 8, 20)
    assert not pw.pallas_welch2_applicable(500, 250, 8, 1)


def test_entries_reject_bad_geometry():
    with pytest.raises(ValueError, match="unsupported geometry"):
        pw.welch_fir_pallas_fused(np.zeros(4096, np.float32),
                                  np.zeros((1, 4096), np.float32),
                                  np.hanning(2001)[:-1], 1000, 1.0,
                                  navr=3, nwins=2000, noverlap=1000)
    with pytest.raises(ValueError, match="unsupported geometry"):
        pw.welch_pallas3_twosided(np.zeros(4096, np.complex64),
                                  np.zeros((1, 4096), np.complex64),
                                  np.hanning(500), 1.0, navr=8, nwins=500,
                                  noverlap=250)
    with pytest.raises(ValueError, match="do not fit"):
        pw.welch_fir_pallas3(np.zeros(1000, np.float32),
                             np.zeros((1, 1000), np.float32),
                             np.hanning(256), 128, 1.0, navr=10, nwins=256,
                             noverlap=128)
    # the kernel wrapper never runs CPU tensors: it raises
    with pytest.raises(ValueError, match="CUDA"):
        pw.welch_cuda(torch.zeros(512), torch.zeros(1, 512), np.hanning(256),
                      128, 1.0, navr=1, nwins=256, hop=128)
