"""The analysis tier of pyfft_tpu_torch against the JAX package on the CPU.

Same inputs (seeded NumPy) through both packages.  Tolerances:

- Host NumPy code that the port copies (Butterworth, notch/peak design,
  ``freqz``, ``lfilter_zi``, ``dft``, ``crosscheck`` on ``csd_oracle``):
  rtol 1e-12.
- The IIR filters: the port steps over blocks (Toeplitz products and a
  scan over block states), the JAX package over samples (``lax.scan``),
  both in float64: atol 1e-10 * max|ref|, with the JAX package in x64
  (tests/conftest.py).  For the stiff 5th-order low-pass at 0.02 Nyquist
  the bound is 1e-9: there the JAX recursion itself is up to 1.5e-10 (the
  output) and 5e-10 (the final state) from a recursion in extended
  precision, to which the port is held at 1e-10
  (``test_lfilter_stiff_filter_against_extended_precision``).
- FFT-based functions in float64 (overlap-save, ``fft_deriv``,
  ``laplace_1d``, ``ccf``, ``cog``...): atol 1e-10 * max|ref|, the FFT
  libraries' rounding; 1e-5 relative where both sides run float32
  (``laplace_1d`` of float32 input, the float32 PCA projection).
"""
import importlib

import numpy as np
import pytest
import torch

import pyfft_tpu as ft
from pyfft_tpu import crosscheck as jcc
from pyfft_tpu import deriv as jderiv
from pyfft_tpu import dft as jdft
from pyfft_tpu import doppler as jdop
from pyfft_tpu import examples as jex
from pyfft_tpu import filters as jf
from pyfft_tpu import notch as jnotch
from pyfft_tpu import pca as jpca
from pyfft_tpu.laplace import laplace_1d as j_laplace_1d
from pyfft_tpu.laplace import test_laplace as j_test_laplace

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import crosscheck as pcc
from pyfft_tpu_torch import deriv as pderiv
from pyfft_tpu_torch import dft as pdft
from pyfft_tpu_torch import doppler as pdop
from pyfft_tpu_torch import examples as pex
from pyfft_tpu_torch import filters as pf
from pyfft_tpu_torch import notch as pnotch
from pyfft_tpu_torch import pca as ppca
from pyfft_tpu_torch.laplace import laplace_1d as p_laplace_1d
from pyfft_tpu_torch.laplace import test_laplace as p_test_laplace
from pyfft_tpu_torch.utils.detrend import detrend_linear, detrend_mean
from pyfft_tpu.utils.detrend import (detrend_linear as j_detrend_linear,
                                     detrend_mean as j_detrend_mean)
from pyfft_tpu_torch.config import default_device

# both packages export a function `ccf` over the module's name
jccf_mod = importlib.import_module("pyfft_tpu.ccf")
pccf_mod = importlib.import_module("pyfft_tpu_torch.ccf")


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def close(got, want, rel=1e-10):
    """max |got - want| <= rel * max |want| (and equal shapes)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def rng_(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------- #
# filters: design (host copies)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("order,Wn,btype", [
    (2, 0.2, "low"), (5, 0.02, "low"), (4, 0.3, "high"),
    (3, [0.1, 0.4], "band"), (2, [0.2, 0.3], "stop")])
def test_butter_matches_jax(order, Wn, btype):
    for got, want in zip(pt.filters.butter(order, Wn, btype),
                         jf.butter(order, Wn, btype)):
        close(got, want, 1e-12)


def test_filter_design_helpers_match_jax():
    b, a = jf.butter(4, 0.15)
    close(pf.butter_lowpass(100.0, 1000.0, 3)[1],
          jf.butter_lowpass(100.0, 1000.0, 3)[1], 1e-12)
    close(pf.freqz(b, a, worN=64)[1], jf.freqz(b, a, worN=64)[1], 1e-12)
    close(pf.freqz(b, a, worN=np.array([0.0, 10.0, 99.0]), fs=200.0)[1],
          jf.freqz(b, a, worN=np.array([0.0, 10.0, 99.0]), fs=200.0)[1],
          1e-12)
    close(pf.lfilter_zi(b, a), jf.lfilter_zi(b, a), 1e-12)
    close(pf.lfilter_zi([1.0, 0.5], [2.0]), jf.lfilter_zi([1.0, 0.5], [2.0]),
          1e-12)


# --------------------------------------------------------------------------- #
# filters: the blocked IIR
# --------------------------------------------------------------------------- #

_IIR = [(2, 0.001, "low"), (2, 0.2, "low"), (5, 0.02, "low"),
        (4, 0.3, "high"), (3, [0.1, 0.4], "band")]


def _iir_rel(spec):
    return 1e-9 if spec == (5, 0.02, "low") else 1e-10


def _lfilter_extended(b, a, x, zi):
    """TDF-II recursion over samples in extended precision (NumPy
    longdouble), as float64."""
    b, a = pf._normalize(b, a)
    b, a = b.astype(np.longdouble), a.astype(np.longdouble)
    n = len(a) - 1
    z = np.asarray(zi, dtype=np.longdouble)
    y = np.empty(len(x), dtype=np.longdouble)
    for i, xn in enumerate(np.asarray(x, dtype=np.longdouble)):
        y[i] = b[0] * xn + z[0]
        z = np.concatenate([b[1:n] * xn + z[1:n] - a[1:n] * y[i],
                            [b[n] * xn - a[n] * y[i]]])
    return y.astype(np.float64), z.astype(np.float64)


@pytest.mark.parametrize("spec", _IIR)
@pytest.mark.parametrize("shape,axis", [((3000,), -1), ((2, 2500), -1),
                                        ((1700, 3), 0)])
def test_lfilter_matches_jax(spec, shape, axis):
    b, a = jf.butter(*spec)
    x = rng_(len(b) + shape[0]).standard_normal(shape)
    close(pf.lfilter(b, a, x, axis=axis, device="cpu"),
          jf.lfilter(b, a, x, axis=axis), _iir_rel(spec))


@pytest.mark.parametrize("spec", _IIR)
def test_lfilter_with_zi_matches_jax(spec):
    b, a = jf.butter(*spec)
    r = rng_(len(a))
    x = r.standard_normal((2, 2100))
    zi = jf.lfilter_zi(b, a)[None] * x[:, :1]
    y, zf = pf.lfilter(b, a, x, zi=zi)
    yj, zfj = jf.lfilter(b, a, x, zi=zi)
    close(y, yj, _iir_rel(spec))
    close(zf, zfj, _iir_rel(spec))


@pytest.mark.parametrize("spec", [(5, 0.02, "low"), (2, 0.001, "low")])
def test_lfilter_stiff_filter_against_extended_precision(spec):
    """Poles crowding z = 1: the port (default blocks) within 1e-10 of the
    extended-precision recursion, output and final state."""
    b, a = jf.butter(*spec)
    x = rng_(17).standard_normal(6000)
    zi = jf.lfilter_zi(b, a) * x[0]
    y, zf = _lfilter_extended(b, a, x, zi)
    got, gzf = pf.lfilter(b, a, x, zi=zi)
    close(got, y)
    close(gzf, zf)


@pytest.mark.parametrize("block", [16, 64, 333, 1024])
@pytest.mark.parametrize("nt", [1, 15, 1000, 4097])
def test_lfilter_blocks_and_tails_match_jax(block, nt):
    """The block loop itself: ragged last blocks, one-sample signals, more
    blocks than samples per block (a deep scan), a random start state."""
    b, a = jf.butter(3, 0.2)
    r = rng_(block + nt)
    x = r.standard_normal((2, nt))
    zi = r.standard_normal((2, 3))
    y, zf = pf._lfilter_t(*pf._normalize(b, a), torch.as_tensor(x),
                          torch.as_tensor(zi), block=block)
    yj, zfj = jf.lfilter(b, a, x, zi=zi)
    close(y.numpy(), yj)
    close(zf.numpy(), zfj)


def test_lfilter_fir_and_gain_only_match_jax():
    x = rng_(3).standard_normal(500)
    close(pf.lfilter([0.5, 0.25, 0.25], [1.0], x),
          jf.lfilter([0.5, 0.25, 0.25], [1.0], x))
    close(pf.lfilter([3.0], [2.0], x), jf.lfilter([3.0], [2.0], x))
    y, zf = pf.lfilter([3.0], [2.0], x[None], zi=np.zeros((1, 0)))
    assert zf.shape == (1, 0)


@pytest.mark.parametrize("spec", _IIR)
@pytest.mark.parametrize("shape,axis", [((3000,), -1), ((1200, 2), 0)])
def test_filtfilt_matches_jax(spec, shape, axis):
    b, a = jf.butter(*spec)
    x = rng_(7 + shape[0]).standard_normal(shape)
    close(pf.filtfilt(b, a, x, axis=axis), jf.filtfilt(b, a, x, axis=axis),
          _iir_rel(spec))


def test_filtfilt_too_short_raises_like_jax():
    b, a = jf.butter(2, 0.2)
    with pytest.raises(ValueError, match="padlen"):
        pf.filtfilt(b, a, np.ones(9))


def test_iir_wrappers_match_jax():
    r = rng_(11)
    x = r.standard_normal(4000)
    z = x + 1j * r.standard_normal(4000)
    b, a = jf.butter(3, 0.1)
    close(pf.complex_filtfilt(b, a, z), jf.complex_filtfilt(b, a, z))
    close(pf.complex_filtfilt(b, a, x), jf.complex_filtfilt(b, a, x))
    close(pf.butter_bandpass(x, fs=1e5, lf=1e3, hf=2e4),
          jf.butter_bandpass(x, fs=1e5, lf=1e3, hf=2e4))
    X = r.standard_normal((4000, 2))
    close(pf.butter_lowpass_filter(X, 50.0, 1000.0, order=3),
          jf.butter_lowpass_filter(X, 50.0, 1000.0, order=3))


@pytest.mark.parametrize("spec", [(2, 0.2, "low"), (4, 0.05, "low")])
def test_iir_to_fir_matches_jax(spec):
    b, a = jf.butter(*spec)
    close(pf.iir_to_fir(b, a), jf.iir_to_fir(b, a))
    close(pf.iir_to_fir(b, a, ntaps=100), jf.iir_to_fir(b, a, ntaps=100))


# --------------------------------------------------------------------------- #
# filters: FIR, resampling, smoothing
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ntaps,shape,axis", [(31, (500,), -1),
                                              (64, (2, 700), -1),
                                              (15, (300, 2), 0)])
def test_fir_filtfilt_matches_jax(ntaps, shape, axis):
    taps = jf.firwin(ntaps, 0.2) if ntaps % 2 else np.hanning(ntaps)
    x = rng_(ntaps).standard_normal(shape)
    close(pf.fir_filtfilt(x, taps, axis=axis),
          jf.fir_filtfilt(x, taps, axis=axis))


@pytest.mark.parametrize("up,down,shape,axis,taps", [
    (3, 7, (2, 999), -1, None), (5, 2, (400, 2), 0, None),
    (1, 4, (1000,), -1, None), (4, 4, (50,), -1, None),
    (2, 3, (300,), -1, np.hanning(17))])
def test_resample_poly_matches_jax(up, down, shape, axis, taps):
    x = rng_(up * 10 + down).standard_normal(shape)
    close(pf.resample_poly(x, up, down, axis=axis, taps=taps),
          jf.resample_poly(x, up, down, axis=axis, taps=taps))


@pytest.mark.parametrize("fn", ["downsample", "downsample_efficient"])
@pytest.mark.parametrize("shape", [(5000,), (5000, 3)])
def test_downsample_matches_jax(fn, shape):
    x = rng_(len(shape)).standard_normal(shape)
    close(getattr(pf, fn)(x, 1e4, 1.3e3), getattr(jf, fn)(x, 1e4, 1.3e3))


def test_downsample_efficient_options_match_jax():
    x = rng_(5).standard_normal((4000, 2))
    kw = dict(halforder=3, lowpass=300.0)
    close(pf.downsample_efficient(x, 1e4, 2e3, **kw),
          jf.downsample_efficient(x, 1e4, 2e3, **kw))


@pytest.mark.parametrize("window", ["flat", "hanning", "hamming",
                                    "bartlett", "blackman"])
@pytest.mark.parametrize("window_len", [2, 11, 30])
def test_smooth_matches_jax(window, window_len):
    x = rng_(window_len).standard_normal(200)
    close(pf.smooth(x, window_len, window), jf.smooth(x, window_len, window))


def test_smooth_demo_matches_jax():
    got, want = pf.smooth_demo(), jf.smooth_demo()
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


def test_tile_aliases_filter_like_fir_filter():
    """The tile-layout names are thin aliases: the row view round-trips and
    filters like ``fir_filter(backend='pallas')`` (the plain version on the
    CPU, float32)."""
    x = torch.as_tensor(rng_(9).standard_normal((2, 1000)),
                        dtype=torch.float32)
    taps = jf.firwin(21, 0.3)
    xr, nt = pf.tile_rows(x, block_rows=8)
    assert xr.shape[-1] == 128 and nt == 1000
    y = pf.untile_rows(pf.fir_filter_tiled(xr, taps), nt)
    ref = pf.fir_filter(x, taps, backend="pallas")
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pf.untile_rows(xr, nt).numpy(), x.numpy())


# --------------------------------------------------------------------------- #
# notch
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("w0,Q", [(0.1, 30.0), (0.5, 2.0), (0.9, 10.0)])
def test_notch_design_and_filters_match_jax(w0, Q):
    for got, want in ((pt.iirnotch(w0, Q), jnotch.iirnotch(w0, Q)),
                      (pt.iirpeak(w0, Q), jnotch.iirpeak(w0, Q))):
        close(got[0], want[0], 1e-12)
        close(got[1], want[1], 1e-12)
    x = rng_(int(w0 * 10)).standard_normal((2, 3000))
    for zp in (True, False):
        close(pnotch.notch_filter(x, w0, Q, zero_phase=zp),
              jnotch.notch_filter(x, w0, Q, zero_phase=zp))
        close(pnotch.peak_filter(x, w0, Q, zero_phase=zp),
              jnotch.peak_filter(x, w0, Q, zero_phase=zp))


def test_notch_rejects_bad_w0_like_jax():
    with pytest.raises(ValueError, match="w0"):
        pt.iirnotch(1.5, 3.0)


# --------------------------------------------------------------------------- #
# deriv
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [
    {}, {"modified": False}, {"Fs_new": 20.0, "lowpass": 10.0},
    {"lowpass": False}, {"window": lambda n: np.hanning(n + 2)[1:-1]},
    {"detrend": "mean"}, {"detrend": "linear"}])
def test_fft_deriv_matches_jax(kw):
    xx = np.linspace(0, 10, 500)
    y = np.sin(xx) + 0.1 * xx ** 2
    jkw, pkw = dict(kw), dict(kw)
    if "detrend" in kw:
        jkw["detrend"] = {"mean": j_detrend_mean,
                          "linear": j_detrend_linear}[kw["detrend"]]
        pkw["detrend"] = {"mean": detrend_mean,
                          "linear": detrend_linear}[kw["detrend"]]
    d, x = pt.fft_deriv(y, xx, **pkw)
    dj, xj = jderiv.fft_deriv(y, xx, **jkw)
    close(d, dj)
    close(x, xj, 1e-14)


def test_rescale_unscale_match_jax():
    xx = np.linspace(1, 3, 50)
    yy = np.cos(xx)
    for got, want in zip(pderiv.rescale(xx, yy), jderiv.rescale(xx, yy)):
        close(np.asarray(got), np.asarray(want), 1e-14)
    scl = jderiv.rescale(xx, yy)[2]
    for got, want in zip(pderiv.unscale(xx, yy, scl, dydx=yy),
                         jderiv.unscale(xx, yy, scl, dydx=yy)):
        close(got, want, 1e-14)


def test_test_fft_deriv_matches_jax():
    got, want = pex.test_fft_deriv(), jex.test_fft_deriv()
    assert got.keys() == want.keys()
    for k in want:
        for g, w in zip(got[k], want[k]):
            close(g, w)


# --------------------------------------------------------------------------- #
# laplace
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,n,nfft,block,rel", [
    (np.float64, 300, None, None, 1e-10), (np.float64, 300, 256, 3, 1e-10),
    (np.float64, 200, 300, 2, 1e-10), (np.float32, 300, None, 4, 1e-5)])
def test_laplace_1d_matches_jax(dtype, n, nfft, block, rel):
    x = rng_(n).standard_normal(n).astype(dtype)
    sig = np.linspace(-0.02, 0.02, 9)
    got = p_laplace_1d(x, real_sigma_interval=sig, nfft=nfft,
                       sigma_block=block)
    want = j_laplace_1d(x, real_sigma_interval=sig, nfft=nfft,
                        sigma_block=block)
    assert got.dtype == want.dtype
    close(got, want, rel)


def test_laplace_demo_and_stub_match_jax():
    for got, want in zip(p_test_laplace(), j_test_laplace()):
        close(got, want)
    assert pt.laplace() is None
    x = rng_(1).standard_normal(64)
    close(pt.laplace(x, real_sigma_interval=[0.0, 0.01]),
          ft.laplace(x, real_sigma_interval=[0.0, 0.01]))


# --------------------------------------------------------------------------- #
# ccf
# --------------------------------------------------------------------------- #

def _pair(n, seed):
    r = rng_(seed)
    t = np.arange(n) / 1e5
    x1 = np.sin(2 * np.pi * 1e3 * t) + r.normal(0, 1, n)
    x2 = np.sin(2 * np.pi * 1e3 * t + 0.8) + r.normal(0, 1, n)
    return x1, x2


@pytest.mark.parametrize("n", [257, 2048])
def test_ccf_matches_jax(n):
    x1, x2 = _pair(n, n)
    for got, want in zip(pt.ccf(x1, x2, 1e5), ft.ccf(x1, x2, 1e5)):
        close(got, want)


def test_ccf_sh_matches_jax():
    x1, x2 = _pair(2048, 1)
    for got, want in zip(pt.ccf_sh(x1, x2, 1e5, 16),
                         ft.ccf_sh(x1, x2, 1e5, 16)):
        close(got, want)


@pytest.mark.parametrize("na,nb,shift", [(200, 200, 7), (201, 201, -5),
                                         (300, 120, 11), (301, 120, 4),
                                         (120, 300, 3)])
def test_align_signals_matches_jax(na, nb, shift):
    r = rng_(na + nb)
    a = r.standard_normal(na)
    b = np.roll(r.standard_normal(nb), shift)
    assert pt.align_signals(a, b) == ft.align_signals(a, b)


def test_ccf_helpers_match_jax():
    r = rng_(4)
    a, b = r.standard_normal(64), r.standard_normal(40)
    for mode in ("valid", "same", "full"):
        close(pccf_mod.convolve_fft(a, b, mode), jccf_mod.convolve_fft(a, b,
                                                                      mode))
        close(pccf_mod.cross_correlation_fft(a, b, mode),
              jccf_mod.cross_correlation_fft(a, b, mode))
    assert pccf_mod.conv([1, 2, 3], [0, 1]) == jccf_mod.conv([1, 2, 3], [0, 1])
    assert pccf_mod.corr([1, 2, 3], [4, 5]) == jccf_mod.corr([1, 2, 3], [4, 5])
    close(pccf_mod.fftconv(a, a), jccf_mod.fftconv(a, a))
    close(pccf_mod.fftcorr(a, a[::-1]), jccf_mod.fftcorr(a, a[::-1]))
    for got, want in zip(pccf_mod.ccf_test(), jccf_mod.ccf_test()):
        close(got, want)
    for got, want in zip(pccf_mod.ccf_sh_test(), jccf_mod.ccf_sh_test()):
        close(got, want)


# --------------------------------------------------------------------------- #
# doppler
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,cplx,band", [(1000, False, None),
                                         (1024, True, None),
                                         (1024, True, (1e3, 2e4))])
def test_cog_matches_jax(n, cplx, band):
    r = rng_(n)
    x = r.standard_normal(n) + (1j * r.standard_normal(n) if cplx else 0)
    kw = {} if band is None else dict(fmin=band[0], fmax=band[1])
    close(pt.cog(x, 1e5, **kw), ft.cog(x, 1e5, **kw))


@pytest.mark.parametrize("nt,win", [(1 << 16, 128), (1 << 14, 256)])
def test_cogspec_matches_jax(nt, win):
    """(2^14, 256) leaves no window of the COG series: empty spectra, as
    in the JAX package."""
    fs = 1e6
    t = np.arange(nt) / fs
    x = np.exp(2j * np.pi * (5e4 + 2e4 * np.sin(2 * np.pi * 300 * t)) * t)
    x = x + 0.1 * rng_(2).standard_normal(t.size)
    got = pdop.cogspec(t, x, fs, win=win)
    want = jdop.cogspec(t, x, fs, win=win)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


def test_doppler_iq_chain_matches_jax():
    for got, want in zip(pdop.doppler_iq_chain(N=1 << 17),
                         jdop.doppler_iq_chain(N=1 << 17)):
        close(got, want)
    for am in (True, False):
        close(pdop.doppler_iq_chain(N=1 << 16, ampModulation=am)[1],
              jdop.doppler_iq_chain(N=1 << 16, ampModulation=am)[1])


def test_test_DopplerSignal_matches_jax():
    """Complex video signal through ``fftanal`` (two-sided Welch); float64
    on the CPU on both sides."""
    got = pdop.test_DopplerSignal(N=1 << 19, device="cpu")
    want = jdop.test_DopplerSignal(N=1 << 19)
    close(got.freq, want.freq, 1e-12)
    for k in ("Pxx", "Lxx"):
        close(np.asarray(getattr(got, k)), np.asarray(getattr(want, k)))
    ipk = int(np.argmax(np.abs(np.asarray(got.Lxx))))
    assert abs(got.freq[ipk] - 10e3) <= 2 * (got.freq[1] - got.freq[0])


# --------------------------------------------------------------------------- #
# pca
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("rows,cols,rel", [(150, 8, 1e-10),
                                           (9000, 8, 1e-5)])
def test_pca_matches_jax(rows, cols, rel):
    """At 9000 x 8 (>= 2^16 values) both project in float32 on their
    device."""
    r = rng_(rows)
    data = r.standard_normal((rows, cols)) @ r.standard_normal((cols, cols))
    U, E, V = pt.basic_pca(data.copy(), 3)
    Uj, Ej, Vj = ft.basic_pca(data.copy(), 3)
    close(E, Ej, 1e-10)
    close(np.abs(V), np.abs(Vj), 1e-8)
    close(np.abs(U), np.abs(Uj), rel)
    P, ev, evec = pt.PCA(data.copy(), 2)
    Pj, evj, evecj = ft.PCA(data.copy(), 2)
    close(ev, evj, 1e-10)
    close(np.abs(P), np.abs(Pj), rel)
    close(ppca.cov(data), jpca.cov(data), 1e-12)


def test_pca_demos_match_jax():
    data = jpca.test_data(rng_(0))
    close(ppca.test_data(rng_(0)), data, 0)
    close(np.abs(ppca.test(data.copy(), plotit=False)),
          np.abs(jpca.test(data.copy(), plotit=False)))
    for got, want in zip(ppca.test_PCA(data.copy(), plotit=False),
                         jpca.test_PCA(data.copy(), plotit=False)):
        close(np.abs(got), np.abs(want))


# --------------------------------------------------------------------------- #
# dft, crosscheck, the facade
# --------------------------------------------------------------------------- #

def test_dft_module_matches_jax():
    x = list(rng_(3).standard_normal(16))
    for name in ("compute_dft_complex", "ForwardDFT", "InverseDFT", "dft",
                 "idft", "fft", "ifft", "bitrev"):
        close(np.asarray(getattr(pdft, name)(x)),
              np.asarray(getattr(jdft, name)(x)), 1e-12)
    close(np.asarray(pdft.compute_dft_real_pair(x, x[::-1])),
          np.asarray(jdft.compute_dft_real_pair(x, x[::-1])), 1e-12)
    close(np.asarray(pdft.complex_dft(x, x, 16)),
          np.asarray(jdft.complex_dft(x, x, 16)), 1e-12)
    re1, im1, re2, im2 = list(x), [0.0] * 16, list(x), [0.0] * 16
    pdft.fft_basic(re1, im1, 16)
    jdft.fft_basic(re2, im2, 16)
    close(np.asarray(re1 + im1), np.asarray(re2 + im2), 1e-12)
    assert pdft.test(rng_(1), verbose=False) == jdft.test(rng_(1),
                                                          verbose=False)


@pytest.mark.parametrize("fn,kw", [
    ("psd", dict(nfft=256)), ("psd", dict(nfft=256, fmin=1e3, fmax=2e4,
                                          detrend="mean")),
    ("csd", dict(nfft=256)), ("csd", dict(nfft=128, detrend="linear")),
    ("coh", dict(nfft=256)), ("coh2", dict(nfft=256))])
def test_crosscheck_matches_jax(fn, kw):
    r = rng_(len(fn))
    x = r.standard_normal(4096)
    y = np.roll(x, 3) + 0.5 * r.standard_normal(4096)
    args = (x, 1e5) if fn == "psd" else (x, y, 1e5)
    got = getattr(pcc, fn)(*args, **kw)
    want = getattr(jcc, fn)(*args, **kw)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    for g, w in zip(got, want):
        close(g, w, 1e-12)


def test_fft_pmlab_matches_jax():
    r = rng_(8)
    x, y = r.standard_normal(512), r.standard_normal(512)
    for g, w in zip(pt.fft_pmlab(x, y, 1e-5), ft.fft_pmlab(x, y, 1e-5)):
        close(g, w, 1e-12)


def test_facade_and_exports_match_jax():
    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}
    assert public(ft.fft) - {"annotations"} <= public(pt.fft)
    for name in ("hilbert_mod", "hilbert", "hilbert_1d", "laplace_mod",
                 "laplace", "laplace_1d", "butter_lowpass_filter",
                 "butter_bandpass", "upsample", "downsample",
                 "downsample_efficient", "notch", "iirnotch", "iirpeak",
                 "fft_deriv", "fft", "ccf_mod", "ccf", "ccf_sh",
                 "align_signals", "doppler", "cog", "cogspec", "pca", "PCA",
                 "basic_pca", "dft_mod", "crosscheck", "coh", "coh2", "psd",
                 "csd", "fft_pmlab"):
        assert hasattr(pt, name), name
    assert set(jf.__all__) <= set(pf.__all__)
