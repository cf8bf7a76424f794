"""Kernel C's plain version, ``stft_segments`` and ``ops/transform`` of
pyfft_tpu_torch against the JAX package on the CPU.

- ``stft_plain`` (through the port's ``stft_pallas3``, which casts to
  float32 as the JAX entry does) against JAX ``stft_pallas3`` in interpret
  mode with 'highest' precision: both are float32 DFTs of the same
  windowed frames, so they agree to atol 3e-5 of max|X| (the bound
  tests/test_pallas_welch.py puts on float32 spectra).
- Outside the JAX kernel's domain the port is held alone against a
  float64 NumPy DFT at rtol 1e-10 (same arithmetic, float64).
- ``stft_segments('xla')`` in float64 against JAX 'xla' in x64
  (tests/conftest.py): rtol 1e-10, the FFT libraries' rounding only.
- ``stft_segments('pallas')`` against JAX 'pallas' at the tolerances that
  tests/test_fftanal.py puts on the JAX kernel path against its float64
  core (float32 spectra).
- ``ops/transform`` against NumPy at rtol 1e-12.
"""
import numpy as np
import pytest
import torch

import pyfft_tpu as ft
from pyfft_tpu import segmentation as jseg
from pyfft_tpu.ops.pallas_welch3 import stft_pallas3 as jstft

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import segmentation as pseg
from pyfft_tpu_torch.ops import stft as ps
from pyfft_tpu_torch.ops import transform as ptr
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _sigs(nt, ny, cplx, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(nt) + 0.7
    y = rng.standard_normal((ny, nt)) - 0.2 if ny else None
    if cplx:
        x = x + 1j * (rng.standard_normal(nt) - 0.4)
        if ny:
            y = y + 1j * rng.standard_normal((ny, nt))
    return x, y


@pytest.mark.parametrize("nwins,hop,nt,ny,cplx,detrend", [
    (512, 256, 1 << 13, 0, False, 1),
    (512, 256, (1 << 13) + 77, 2, False, 0),
    (512, 256, (1 << 13) + 77, 1, True, 1),
    (512, 256, 1 << 13, 0, True, 0),
    (1024, 512, 1 << 13, 1, False, 1),
    (1024, 512, 1 << 13, 2, True, 1),
    (1024, 512, (1 << 13) + 77, 0, False, 0),
    (1024, 512, 1 << 13, 1, True, 0),
])
def test_stft_plain_matches_jax_kernel(nwins, hop, nt, ny, cplx, detrend):
    """``nt % 128 != 0`` is the JAX package's padded route (#5); the others
    take its fused kernel (#4).  The CPU entry runs the plain version and
    launches nothing."""
    x, y = _sigs(nt, ny, cplx, seed=nt + nwins + ny)
    win = np.hanning(nwins + 1)[:-1]
    navr = (nt - nwins) // hop + 1
    kw = dict(navr=navr, nwins=nwins, noverlap=nwins - hop,
              detrend_style=detrend)
    jr, ji = jstft(x, y, win, 0.5, interpret=True, precision="highest", **kw)
    before = ps.LAUNCHES
    pr, pi = ps.stft_pallas3(x, y, win, 0.5, **kw)
    assert ps.LAUNCHES == before
    assert pr.dtype == pi.dtype == torch.float32
    J = np.asarray(jr) + 1j * np.asarray(ji)
    P = pr.numpy() + 1j * pi.numpy()
    assert P.shape == J.shape == (1 + ny, navr, nwins)
    np.testing.assert_allclose(P, J, rtol=0, atol=3e-5 * np.abs(J).max())


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("detrend", [0, 1])
def test_stft_plain_outside_jax_domain_matches_numpy_dft(cplx, detrend):
    """nwins 16, hop 7 and 3 signals: no JAX kernel takes this geometry.
    float64 against a NumPy DFT matrix: rtol 1e-10."""
    nwins, hop, nt = 16, 7, 200
    x, y = _sigs(nt, 2, cplx, seed=3)
    win = np.hamming(nwins)
    navr = (nt - nwins) // hop + 1
    X = ps.stft_plain(torch.from_numpy(x), torch.from_numpy(y), win, 0.25,
                      navr=navr, nwins=nwins, hop=hop, detrend_style=detrend)
    sig = np.vstack([x[None], y])
    if detrend:
        sig = sig - sig.mean(axis=-1, keepdims=True)
    n = np.arange(nwins)
    F = np.exp(-2j * np.pi * np.outer(n, n) / nwins)
    idx = np.arange(navr)[:, None] * hop + n[None, :]
    ref = 0.25 * (sig[:, idx] * win) @ F.T
    assert X.dtype == torch.complex128 and tuple(X.shape) == ref.shape
    np.testing.assert_allclose(X.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def test_stft_kernel_domain_and_cpu_contract():
    ok = ps.stft_applicable
    assert ok(16, 9) and ok(16384, 0) and ok(2048, 1024) and ok(512, 511)
    assert not ok(8, 4) and not ok(32768, 0) and not ok(1000, 500)
    assert not ok(512, 512) and not ok(512, -1) and not ok(512, 256, -1)
    x = np.ones(4096)
    with pytest.raises(ValueError, match="unsupported geometry"):
        ps.stft_pallas3(x, None, np.ones(1000), navr=3, nwins=1000,
                        noverlap=500)
    with pytest.raises(ValueError, match="unsupported geometry"):
        ps.stft_pallas3(x, None, np.ones(512), navr=3, nwins=512,
                        noverlap=256, detrend_style=-1)
    with pytest.raises(TypeError, match="window"):
        ps.stft_pallas3(x, None, None, navr=3, nwins=512, noverlap=256)
    with pytest.raises(ValueError, match="CUDA"):
        ps.stft_cuda(torch.ones(4096), None, np.ones(512), 1.0, navr=3,
                     nwins=512, hop=256)
    with pytest.raises(ValueError, match="segments"):
        ps.stft_plain(torch.ones(1000), None, np.ones(512), 1.0, navr=3,
                      nwins=512, hop=256)


def _plan_pair(nt, nwins, ov=0.5):
    return (pseg.plan_segments(nt, nwins=nwins, windowoverlap=ov),
            jseg.plan_segments(nt, nwins=nwins, windowoverlap=ov))


def _chirp(nt, cplx, seed=11, fs=1e3):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) / fs
    f = 50 + 150 * np.arange(nt) / nt
    ph = 2 * np.pi * np.cumsum(f) / fs
    if cplx:
        s = np.exp(1j * ph) + 0.1 * (rng.standard_normal(nt)
                                     + 1j * rng.standard_normal(nt))
    else:
        s = np.sin(ph) + 2.0 + 0.1 * rng.standard_normal(nt)
    return t, s


@pytest.mark.parametrize("nt,nwins,ov,cplx,onesided,detrend,dwin", [
    (1 << 12, 512, 0.5, False, True, 1, False),
    (1 << 12, 512, 0.5, True, False, 1, False),
    (4001, 333, 0.25, False, True, -1, False),
    (4001, 333, 0.25, True, True, 0, False),
    (1 << 12, 256, 0.5, False, True, 1, True),
    (1 << 12, 256, 0.75, False, False, -1, True),
])
def test_stft_segments_xla_float64_matches_jax(nt, nwins, ov, cplx, onesided,
                                               detrend, dwin):
    t, s = _chirp(nt, cplx)
    plan, jplan = _plan_pair(nt, nwins, ov)
    win = np.hamming(plan.nwins)
    fs = 1e3
    kw = dict(onesided=onesided, detrend_style=detrend, detrendwin=dwin,
              fft_backend="xla")
    a = pt.stft_segments(s, t, win, plan, fs, **kw)
    b = ft.stft_segments(s, t, win, jplan, fs, **kw)
    for name, u, v in zip(("tt", "freq", "X", "pseg"), a, b):
        v = np.asarray(v)
        assert u.shape == v.shape and u.dtype == v.dtype, name
        np.testing.assert_allclose(u, v, rtol=1e-10,
                                   atol=1e-10 * np.abs(v).max(), err_msg=name)


@pytest.mark.parametrize("nt,nwins,cplx,onesided,detrend", [
    (1 << 13, 512, False, True, 1),
    (1 << 13, 512, True, False, 1),
    ((1 << 13) + 77, 1024, False, True, 0),
    ((1 << 13) + 77, 512, True, True, 1),
])
def test_stft_segments_pallas_matches_jax_pallas(nt, nwins, cplx, onesided,
                                                 detrend):
    """The port's kernel route (plain version on the CPU) against the JAX
    kernel (interpret): the tolerances of tests/test_fftanal.py's kernel vs
    float64 core check."""
    t, s = _chirp(nt, cplx)
    plan, jplan = _plan_pair(nt, nwins)
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(onesided=onesided, detrend_style=detrend, fft_backend="pallas")
    tt1, f1, X1, p1 = ft.stft_segments(s, t, win, jplan, 1e3, **kw)
    before = ps.LAUNCHES
    tt2, f2, X2, p2 = pt.stft_segments(s, t, win, plan, 1e3, **kw)
    assert ps.LAUNCHES == before
    assert X2.dtype == np.complex128 and X2.shape == np.asarray(X1).shape
    np.testing.assert_allclose(tt2, np.asarray(tt1), rtol=1e-9)
    np.testing.assert_allclose(f2, f1, atol=1e-12)
    sc = np.abs(np.asarray(X1)).max()
    np.testing.assert_allclose(X2, np.asarray(X1), rtol=1e-4, atol=1e-5 * sc)
    np.testing.assert_allclose(p2, np.asarray(p1), rtol=1e-5, atol=1e-9)
    # and against the port's own float64 core, as the JAX test holds its
    # kernel against its core
    tt3, f3, X3, p3 = pt.stft_segments(s, t, win, plan, 1e3,
                                       onesided=onesided,
                                       detrend_style=detrend,
                                       fft_backend="xla")
    np.testing.assert_allclose(tt2, tt3, rtol=1e-9)
    np.testing.assert_allclose(X2, X3, rtol=1e-4, atol=1e-5 * sc)
    np.testing.assert_allclose(p2, p3, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("case", ["late_jitter", "nwins_not_pow2",
                                  "detrendwin", "linear", "mxu", "default"])
def test_stft_segments_gates_take_the_torch_core(case):
    """Where a gate of the kernel path fails (or 'xla'/'mxu'/the CPU
    default is asked for) the result is exactly the 'xla' core's, and it
    agrees with the JAX package's float64 core."""
    nt, nwins = 1 << 12, 512
    t, s = _chirp(nt, False)
    kw = dict(detrend_style=1, detrendwin=False, fft_backend="pallas")
    if case == "late_jitter":
        t = t.copy()
        t[3000:] += 1e-6 * np.sin(np.arange(nt - 3000))
    elif case == "nwins_not_pow2":
        nwins = 500
    elif case == "detrendwin":
        kw["detrendwin"] = True
    elif case == "linear":
        kw["detrend_style"] = -1
    elif case == "mxu":
        kw["fft_backend"] = "mxu"
    else:
        kw["fft_backend"] = None
    plan, jplan = _plan_pair(nt, nwins)
    win = np.hanning(nwins)
    got = pt.stft_segments(s, t, win, plan, 1e3, **kw)
    core = pt.stft_segments(s, t, win, plan, 1e3,
                            **{**kw, "fft_backend": "xla"})
    for u, v in zip(got, core):
        np.testing.assert_array_equal(u, v)
    ref = ft.stft_segments(s, t, win, jplan, 1e3,
                           **{**kw, "fft_backend": "xla"})
    for u, v in zip(got, ref):
        v = np.asarray(v)
        np.testing.assert_allclose(u, v, rtol=1e-10,
                                   atol=1e-10 * np.abs(v).max())


@pytest.mark.parametrize("fn", ["fft", "ifft", "rfft", "irfft"])
def test_transform_matches_numpy(fn):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 100))
    if fn in ("ifft", "irfft"):
        x = x + 1j * rng.standard_normal((3, 100))
    ref = getattr(np.fft, fn)
    for n, axis in ((None, -1), (128, -1), (5, 0)):
        if fn == "irfft" and n is None:
            n = 198
        got = getattr(ptr, fn)(x, n=n, axis=axis)
        want = ref(x, n=n, axis=axis)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    jgot = getattr(ft.ops.transform, fn)(x, n=64, axis=-1)
    np.testing.assert_allclose(getattr(ptr, fn)(x, n=64, axis=-1),
                               np.asarray(jgot), rtol=1e-12,
                               atol=1e-12 * np.abs(jgot).max())
