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
- Kernel C's arithmetic, which runs only on a card, as a float64
  emulation of its plan (``csrc/fft_reg.cuh``'s passes, twiddle indices
  and padded buffer; ``csrc/stft.cu``'s pairing of real segments and the
  split per bin) against ``torch.fft.fft`` of each frame at 1e-12 of the
  largest bin; the pair's per-segment power-of-two scaling in float32,
  which keeps a quiet segment beside a loud one at 2e-5 of its own max;
  its wrapper's means and cached window on CPU tensors.
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


# --------------------------------------------------------------------------- #
# Kernel C's plan (csrc/stft.cu on csrc/fft_reg.cuh), emulated in float64
# --------------------------------------------------------------------------- #

_PT = 16        # complex points a thread holds


def _radices(logn):
    """``fftreg::radix``: 16 for every pass but the last, which takes the
    remainder (2, 4, 8 or 16)."""
    npass = (logn + 3) // 4
    return [16 if p + 1 < npass else 1 << (logn - 4 * p)
            for p in range(npass)]


def _pad(i):
    """``fftreg::pad``: one float2 of padding after every 16."""
    return i + (i >> 4)


def _fft_points(v, R):
    """``fft_points<R>`` along the last axis: radix-2 decimation in
    frequency with the 16th roots (``rot16``), then the bit reversal."""
    v = v.clone()
    half = R // 2
    while half >= 1:
        for i in range(R):
            if not i & half:
                a, b = v[..., i].clone(), v[..., i + half].clone()
                q = (i & (half - 1)) * 8 // half
                v[..., i] = a + b
                v[..., i + half] = (a - b) * np.exp(-2j * np.pi * q / 16)
        half //= 2
    bits = R.bit_length() - 1
    return v[..., [int(f"{k:0{bits}b}"[::-1], 2) for k in range(R)]]


def _transform(v, logn):
    """``fftreg::transform``: ``v (..., T, 16)`` holds thread t's pass-0
    points (sample t + r*T); returns the padded shared-memory buffer that
    the last pass leaves the spectrum in."""
    N = 1 << logn
    T = N // _PT
    tw = torch.exp(-2j * np.pi * torch.arange(N // 2, dtype=torch.float64)
                   / N)                              # the half table
    t = torch.arange(T)[:, None]
    buf = None
    for p, R in enumerate(_radices(logn)):
        Ns = 1 << (4 * p)
        j = t + torch.arange(_PT // R) * T           # (T, 16/R) butterflies
        r = torch.arange(R)
        if p == 0:
            v = v.reshape(*v.shape[:-1], 1, _PT)
        else:                                        # load_pass, twiddles
            v = buf[..., _pad(j[..., None] + r * (N // R))]
            m = r * (j[..., None] % Ns) * (N // (Ns * R))
            v = v * torch.where(m < N // 2, tw[m % (N // 2)],
                                -tw[m % (N // 2)])
        v = _fft_points(v, R)
        buf = torch.zeros(*v.shape[:-3], _pad(N), dtype=torch.complex128)
        d = (j // Ns) * Ns * R + j % Ns              # store_pass
        buf[..., _pad(d[..., None] + r * Ns)] = v
    return buf


def _emulate_kernel_c(x, y, win, norm, *, navr, nwins, hop, detrend_style):
    """Kernel C's arithmetic in float64: real signals two segments per
    transform (2p and 2p + 1 of one signal, the last of an odd navr alone),
    split per bin from Z_k and Z_{N-k}; complex signals one segment per
    transform.  Returns ``(nsig, navr, nwins)`` complex128."""
    sig = torch.cat([torch.as_tensor(x)[None],
                     torch.as_tensor(y).reshape(-1, len(x))])
    if detrend_style == 1:
        sig = sig - sig.mean(-1, keepdim=True)
    N = nwins
    logn = N.bit_length() - 1
    T = N // _PT
    n = torch.arange(T)[:, None] + torch.arange(_PT) * T     # (T, 16)
    w = torch.as_tensor(win, dtype=torch.float64)[n]
    k = torch.arange(N)
    out = torch.zeros(sig.shape[0], navr, N, dtype=torch.complex128)

    def frames(s):                       # (nsig, len(s), T, 16)
        return sig[:, (torch.as_tensor(s) * hop)[:, None, None] + n] * w

    if sig.is_complex():
        spec = _transform(frames(range(navr)), logn)
        return norm * spec[..., _pad(k)]
    s = torch.arange(0, navr - 1, 2)                         # pairs
    a, b = frames(s), frames(s + 1)
    ka, kb = _pow2(_scale_exponent(a)), _pow2(_scale_exponent(b))
    spec = _transform(a / ka + 1j * (b / kb), logn)
    zk, zm = spec[..., _pad(k)], spec[..., _pad((N - k) & (N - 1))]
    out[:, s] = 0.5 * norm * ka[..., 0] * torch.complex(zk.real + zm.real,
                                                        zk.imag - zm.imag)
    out[:, s + 1] = 0.5 * norm * kb[..., 0] * torch.complex(
        zk.imag + zm.imag, zm.real - zk.real)
    if navr % 2:                                             # alone
        a = frames([navr - 1])
        ka = _pow2(_scale_exponent(a))
        lone = _transform(a / ka + 0j, logn)
        out[:, navr - 1] = norm * ka[:, 0, 0] * lone[:, 0, _pad(k)]
    return out


def _scale_exponent(v):
    """``scale_exponent`` of ``csrc/stft.cu`` for each segment of ``v (...,
    T, 16)``: the integer e with sum(v^2) / 4^e in [0.5, 2) (0 for a zero
    segment), kept to +-100; shape ``(..., 1, 1)``."""
    _, e2 = torch.frexp(v.double().square().sum((-2, -1), keepdim=True))
    return torch.div(e2, 2, rounding_mode="floor").clamp(-100, 100)


def _pow2(e):
    """2^e in float64, exact."""
    return 2.0 ** e.to(torch.float64)


@pytest.mark.parametrize("logn", range(4, 15))
def test_kernel_c_fft_plan_matches_torch_fft(logn):
    """The register-radix Stockham plan (pass radices, thread and butterfly
    indexing, twiddle indices on the half table with its sign symmetry,
    padded buffer) gives the DFT in natural order: float64, 1e-12 of the
    largest bin; the padding slots stay unwritten."""
    N = 1 << logn
    rng = np.random.default_rng(logn)
    z = torch.as_tensor(rng.standard_normal((3, N))
                        + 1j * rng.standard_normal((3, N)))
    T = N // _PT
    v = z[:, torch.arange(T)[:, None] + torch.arange(_PT) * T]
    buf = _transform(v, logn)
    got = buf[:, _pad(torch.arange(N))]
    ref = torch.fft.fft(z)
    assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()
    pads = torch.ones(_pad(N), dtype=torch.bool)
    pads[_pad(torch.arange(N))] = False
    assert pads.sum() == _pad(N) - N and not buf[:, pads].abs().any()


@pytest.mark.parametrize("nsig,nt,nwins,hop,cplx,detrend", [
    (3, 16 * 9 + 5, 16, 16, False, 1),         # navr 9 (odd), three signals
    (2, 1024 + 512 * 5, 1024, 512, False, 0),  # navr 6 (even)
    (1, 2048 + 3, 2048, 2048, False, 1),       # navr 1: one segment alone
    (2, 256 + 40, 256, 1, False, 1),           # hop 1, navr 41
    (2, 512 * 4, 512, 256, True, 1),           # complex: one per transform
    (1, 16384 * 2, 16384, 8192, False, 1),     # navr 3, radices 16.16.16.4
    (1, 8192 + 4096, 8192, 4096, True, 0),     # radices 16.16.16.2
])
def test_kernel_c_pair_plan_matches_each_frame(nsig, nt, nwins, hop, cplx,
                                               detrend):
    """Two real segments per transform, split per bin into all nwins bins
    of both (bins 0 and nwins/2 pair with themselves), the last segment of
    an odd navr alone, pairs within a signal: float64 against
    ``torch.fft.fft`` of each frame (the plain version), 1e-12 of max."""
    x, y = _sigs(nt, nsig - 1, cplx, seed=nt + nwins)
    win = np.hanning(nwins + 1)[:-1]
    navr = (nt - nwins) // hop + 1
    kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=detrend)
    yt = None if y is None else torch.from_numpy(y)
    ref = ps.stft_plain(torch.from_numpy(x), yt, win, 0.5, **kw)
    got = _emulate_kernel_c(x, np.zeros((0, nt)) if y is None else y, win,
                            0.5, **kw)
    assert got.shape == ref.shape == (nsig, navr, nwins)
    assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()


@pytest.mark.parametrize("ratio", [1e4, 1e30])
def test_kernel_c_pair_scaling_keeps_a_quiet_segment_accurate(ratio):
    """The pair's per-segment power-of-two scaling, in float32 with a
    complex64 ``torch.fft.fft`` for the transform: a segment with 1/ratio
    of its partner's amplitude keeps 2e-5 of its own max |ref| (the card's
    tolerance), as a segment alone does.  The control, the same pair
    unscaled, carries the loud segment's error and misses it."""
    N = 1024
    rng = np.random.default_rng(int(ratio))
    win = np.hanning(N)
    a = torch.as_tensor(rng.standard_normal((8, N)) * win,
                        dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((8, N)) * win / ratio,
                        dtype=torch.float32)
    refs = [torch.fft.fft(v.double()) for v in (a, b)]
    k = torch.arange(N)

    def pair(scaled):
        ka, kb = ((_pow2(_scale_exponent(v.reshape(8, -1, _PT)))[..., 0]
                   if scaled else torch.ones(8, 1)).float() for v in (a, b))
        z = torch.fft.fft(torch.complex(a / ka, b / kb))
        zk, zm = z, z[..., (N - k) % N]
        return (0.5 * ka * torch.complex(zk.real + zm.real, zk.imag - zm.imag),
                0.5 * kb * torch.complex(zk.imag + zm.imag, zm.real - zk.real))

    def worst(got):
        return max(((g.to(torch.complex128) - r).abs().amax(-1)
                    / r.abs().amax(-1)).max().item()
                   for g, r in zip(got, refs))

    assert worst(pair(True)) <= 2e-5
    assert worst(pair(False)) > 2e-5


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("ny", [0, 2])
def test_kernel_c_means_and_window_operands(cplx, ny):
    """The wrapper's operands, on CPU tensors: each signal's mean (re, im
    pairs for complex signals, first signal first) from float32 block sums
    added in float64, within 1e-6 of the largest sample; the window is the
    same device tensor for the same content (one copy per content)."""
    nt = 3 * 4096 + 77
    x, y = _sigs(nt, ny, cplx, seed=ny + 7)
    dt = torch.complex64 if cplx else torch.float32
    xt = torch.as_tensor(x, dtype=dt)
    yt = torch.as_tensor(np.zeros((0, nt)) if y is None else y, dtype=dt)
    got = ps._means(xt, yt, 1, cplx).numpy()
    sig = np.vstack([xt.numpy()[None], yt.numpy()]).astype(
        np.complex128 if cplx else np.float64)
    want = sig.mean(-1)
    if cplx:
        want = np.stack([want.real, want.imag], -1).reshape(-1)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(sig).max())
    assert not ps._means(xt, yt, 0, cplx).any()
    w = np.hanning(512).astype(np.float32).tobytes()
    assert ps._window(w, "cpu") is ps._window(bytes(w), "cpu")
