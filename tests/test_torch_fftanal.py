"""The ``fftanal`` class, ``spectrogram``, ``integrate``, ``utils/interp``,
``filters.upsample`` and ``examples`` of pyfft_tpu_torch against the JAX
package on the CPU, and the STFT slice as a whole.

Tolerances: float64 paths ('xla' and the host NumPy code) agree with the
JAX package in x64 to rtol 1e-10, with a floor of 1e-10 of each array's
largest value (same arithmetic, different FFT libraries); host NumPy code
copied from the JAX package holds rtol 1e-12.  The kernel path
('pallas': float32 spectra on both sides, the JAX kernel in interpret
mode, the port's plain version) holds rtol 1e-4 with a floor of 1e-5 of
the scale on spectra and 1e-5 on ``pseg``, as tests/test_fftanal.py holds
the JAX kernel against its float64 core.
"""
import importlib

import numpy as np
import pytest
import torch

import pyfft_tpu as ft
import pyfft_tpu.examples as jex
import pyfft_tpu.filters as jfilt
import pyfft_tpu.integrate as jint
import pyfft_tpu.spectrogram as jsg

import pyfft_tpu_torch as pt
import pyfft_tpu_torch.examples as pex
import pyfft_tpu_torch.integrate as pint
import pyfft_tpu_torch.spectrogram as psg
from pyfft_tpu_torch.ops import stft as pstft
from pyfft_tpu_torch.ops import welch as pwelch
from pyfft_tpu_torch.config import default_device

# both packages' ``utils`` re-export the function ``interp``, which hides
# the submodule of the same name from attribute access
jip = importlib.import_module("pyfft_tpu.utils.interp")
pip = importlib.import_module("pyfft_tpu_torch.utils.interp")


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _close(a, b, rtol=1e-10, floor=1e-10, what=""):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if "phi" in what:
        # the phase of a real negative bin is +pi or -pi by the sign of a
        # zero imaginary part: compare phases modulo 2 pi
        a = b + np.angle(np.exp(1j * (a - b)))
    fin = np.isfinite(b)
    scale = np.max(np.abs(b[fin])) if fin.any() else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale,
                               equal_nan=True, err_msg=what)


def _sigs(N=2 ** 12, df=5.0, seed=0, cplx=False):
    """tests/test_fftanal.py's noisy 150 Hz pair (x leads y by pi/4)."""
    tvec = (1.0 / df) * np.arange(0.0, 1.0, 1.0 / N)
    rng = np.random.default_rng(seed)
    x = (0.005 * np.sin(2.0 * np.pi * (df * 30.0) * tvec) + 7.0
         + 0.02 * rng.standard_normal(N))
    y = (0.005 * np.sin(2.0 * np.pi * (df * 30.0) * tvec - np.pi / 4.0)
         + 2.5 + 0.02 * rng.standard_normal(N))
    if cplx:
        x = x + 1j * np.roll(x, 5)
        y = y + 1j * np.roll(y, 7)
    return tvec, x, y


_SPECTRA = ["freq", "tseg", "Xseg", "Yseg", "Xpow", "Ypow", "Xfft", "Yfft",
            "Pxx_seg", "Pyy_seg", "Pxy_seg", "Lxx_seg", "Lxy_seg",
            "phixy_seg", "Cxy2_seg", "Pxx", "Pyy", "Pxy", "varPxx",
            "varPxy", "phi_xy", "Cxy", "Cxy2", "varCxy", "varCxy2"]


def _both(t, x, y, **kw):
    args = dict(tbounds=[t[10], t[-10]], Navr=8, windowfunction="hamming",
                plotit=False, verbose=False, detrend=1)
    args.update(kw)
    return pt.fftanal(t, x, y, **args), ft.fftanal(t, x, y, **args)


def _compare(a, b, names, **tol):
    for f in names:
        _close(getattr(a, f), getattr(b, f), what=f, **tol)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("backend", [None, "xla", "mxu"])
def test_class_pwelch_lags_and_amplitudes_match_jax(cplx, backend):
    """pwelch, crosscorr, crosscorr_stft and convert2amplitudes; complex
    input is two-sided (fftshift) on both sides."""
    t, x, y = _sigs(cplx=cplx)
    a, b = _both(t, x, y, fft_backend=backend)
    for o in (a, b):
        o.pwelch()
        o.crosscorr()
        o.crosscorr_stft()
        o.convert2amplitudes()
    assert a.onesided == (not cplx) and a.Xseg.shape == (a.Navr, len(a.freq))
    _compare(a, b, _SPECTRA + ["Rxx", "Ryy", "Rxy", "corrcoef", "Ex", "Ey",
                               "Rxy_seg", "corrcoef_seg", "Ex_seg", "lags",
                               "Lxx", "Lyy", "Lxy", "varLxx", "varLxy"])
    for f in ("nwins", "noverlap", "Navr", "nfft", "Nnyquist", "S1", "S2",
              "NENBW", "ENBW", "Fs", "tper", "ibounds", "nsig"):
        assert getattr(a, f) == getattr(b, f), f


def test_class_cross_spectrum_is_x_conj_y():
    """The class path's phase convention is the reference's Pxy = X conj(Y)
    (fft_analysis.py:1960), the opposite sign to fft_pwelch's Y conj(X):
    x leads y by pi/4, so the class phase at the line is +pi/4."""
    t, x, y = _sigs()
    a, _ = _both(t, x, y)
    a.pwelch()
    np.testing.assert_array_equal(a.Pxy_seg, a.Xseg * np.conj(a.Yseg))
    ipk = int(np.argmax(np.abs(a.Pxy)))
    assert abs(a.freq[ipk] - 150.0) <= a.freq[1] - a.freq[0]
    assert abs(a.phi_xy[ipk] - np.pi / 4) < 0.3
    fp = pt.fft_pwelch(t, x, y, tbounds=[t[10], t[-10]], Navr=8,
                       windowfunction="hamming", plotit=False, device="cpu")
    assert abs(fp[5][ipk] + np.pi / 4) < 0.3


@pytest.mark.parametrize("cplx", [False, True])
def test_class_kernel_route_matches_jax_kernel_route(cplx):
    """tper resolves nwins to 512 (a power of two with a 128-lane hop), so
    both packages take their kernel route."""
    t, x, y = _sigs(N=2 ** 13, cplx=cplx)
    # float32 spectra of the 7.0 and 2.5 offsets leave ~1e-7 of the DC
    # level in every bin: remove most of it so that bins are compared,
    # not the cancellation of the offset
    off = 1 + 1j if cplx else 1.0
    x, y = x - 6.9 * off, y - 2.4 * off
    fs = (len(t) - 1) / (t[-1] - t[0])
    # device= is the port's own option (the JAX class ignores it)
    a, b = _both(t, x, y, tper=512.5 / fs, windowoverlap=0.5,
                 fft_backend="pallas", device="cpu")
    before = pstft.LAUNCHES
    a.pwelch()
    b.pwelch()
    assert pstft.LAUNCHES == before and a.nwins == 512
    _compare(a, b, ["freq", "tseg"], rtol=1e-9, floor=1e-12)
    _compare(a, b, ["Xseg", "Yseg", "Pxx", "Pyy", "Pxy"], rtol=1e-4,
             floor=1e-5)
    _compare(a, b, ["Xpow", "Ypow"], rtol=1e-5, floor=1e-9)


@pytest.mark.parametrize("useMLAB", [False, True])
def test_class_stft_matches_jax(useMLAB):
    """stft() is pwelch() without useMLAB; with it, scipy.signal.stft with
    boundary='zeros', padded=True, stored segment-major."""
    t, x, y = _sigs()
    a, b = _both(t, x, y, useMLAB=useMLAB)
    a.stft()
    b.stft()
    _compare(a, b, ["freq", "tseg", "Xseg", "Yseg", "Pxx", "Pyy", "Pxy",
                    "Cxy", "phi_xy", "varPxy"])
    if useMLAB:
        assert a.Xseg.shape[0] == len(a.tseg) > a.Navr


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_class_fftpwelch_lazy_segments_delegate(backend):
    """After fftpwelch() on the kernel-B route the segment fields stay lazy
    on the class until first touched, then fill and cache (JAX
    tests/test_fftanal.py:256-279); the function path's phase convention
    applies there (Y conj X)."""
    rng = np.random.default_rng(2)
    nt = 1 << 13
    t = np.arange(nt) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(nt)
    y = np.sin(2 * np.pi * 97.0 * t - 0.5) + 0.1 * rng.standard_normal(nt)
    kw = dict(tper=0.512, windowoverlap=0.5, plotit=False, verbose=False,
              fft_backend=backend)
    fa = pt.fftanal(t, x, y, **kw)
    fb = ft.fftanal(t, x, y, **kw)
    before = pwelch.LAUNCHES
    fa.fftpwelch()
    fb.fftpwelch()
    assert pwelch.LAUNCHES == before
    if backend == "pallas":
        assert "Pxx_seg" not in fa.__dict__
        tol = dict(rtol=5e-5, floor=5e-5)
    else:
        tol = {}
    _compare(fa, fb, ["freq", "Pxx", "Pyy", "Pxy", "Cxy", "phi_xy"], **tol)
    seg = np.asarray(fa.Pxx_seg)                 # delegate -> fill -> cache
    assert "Xfft_seg" in fa.__dict__
    _close(seg, fb.Pxx_seg, what="Pxx_seg")
    fa.crosscorr_stft()
    fb.crosscorr_stft()
    _compare(fa, fb, ["Rxy_seg", "corrcoef_seg", "Ex_seg"])
    with pytest.raises(AttributeError):
        fa.not_a_field


def test_class_integrate_spectra_and_tvecy_resampling():
    t, x, y = _sigs()
    a, b = _both(t, x, y, frange=[100.0, 200.0])
    for o in (a, b):
        o.pwelch()
        o.integrate_spectra()
    for f in ("Pxy", "Pxx", "Pyy", "Cxy", "ph"):
        _close(getattr(a.integrated, f), getattr(b.integrated, f), what=f)
    _close(a.integrated.info.fweighted, b.integrated.info.fweighted)
    # y sampled at half the rate on its own timebase: upsampled onto x's
    ty = t[::2]
    a, b = _both(t, x, y[::2], tvecy=ty, tbounds=[t[10], t[-20]])
    _close(a.sigy, b.sigy, what="upsampled sigy")
    a.pwelch()
    b.pwelch()
    _compare(a, b, ["Pxx", "Pyy", "Pxy", "Xseg"])


def test_class_statics_and_helpers_match_jax():
    t, x, y = _sigs()
    a, b = _both(t, x, y)
    a.pwelch()
    b.pwelch()
    sig = a.__trimsig__(x, a.ibounds)
    tv = a.__trimsig__(t, a.ibounds)
    kw = dict(tvec=tv, win=a.win, nwins=a.nwins, Navr=a.Navr,
              noverlap=a.noverlap, Nnyquist=a.Nnyquist, onesided=a.onesided,
              detrend_style=a.detrendstyle)
    got = pt.fftanal._fft_win(sig, **kw)
    ref = ft.fftanal._fft_win(sig, **kw)
    for u, v in zip(got, ref):
        _close(u, v)
    np.testing.assert_allclose(got[2], a.Xseg, rtol=1e-12, atol=1e-15)
    for kw in (dict(), dict(ENBW=a.ENBW), dict(ispan=10),
               dict(ifreq=3)):
        _close(pt.fftanal.intspectra(a.freq, np.abs(a.Pxy), **kw)[0],
               ft.fftanal.intspectra(b.freq, np.abs(b.Pxy), **kw)[0])
    for style in (1, 0, -1):
        a.detrendstyle = b.detrendstyle = style
        _close(a.detrend(sig), b.detrend(sig), rtol=1e-12, floor=1e-12)
    _close(a.fft(sig[:100], nfft=128), b.fft(sig[:100], nfft=128))
    _close(a.ifft(sig[:100]), b.ifft(sig[:100]))
    _close(a.fftshift(sig), b.fftshift(sig))
    _close(a.ifftshift(sig), b.ifftshift(sig))
    assert pt.fftanal.__Fs__(t) == ft.fftanal.__Fs__(t)
    assert pt.fftanal.__ibounds__(t, [0.01, 0.1]) == \
        ft.fftanal.__ibounds__(t, [0.01, 0.1])
    a.__preallocateFFT__()
    assert a.Pxy.dtype == np.complex128 and a.Pxy.size == 0
    # no sigy: auto-spectra only; no arguments: an empty instance
    n = pt.fftanal(t, x, plotit=False, verbose=False)
    n.pwelch()
    assert hasattr(n, "Pxx") and not hasattr(n, "Pyy")
    assert not hasattr(pt.fftanal(verbose=False), "tvec")


def test_class_plot_adapters_headless():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    t, x, y = _sigs()
    a, _ = _both(t, x, y)
    a.pwelch()
    a.crosscorr()
    assert a.plotCorrelations() is not None
    for n in (1, 2, 3):
        fig, axs = plt.subplots(n, 1, squeeze=False)
        assert a.plotCorrelations(axs=list(axs.ravel())) is not None
    a.plotall()
    a.__calcAmp__(t, x, y, [t[1], t[-2]])
    a.__calcPh1__(t, x, y, [t[1], t[-2]])
    pt.fftanal._plotSignal([t, t], [x, y + 1j * x])
    pt.fftanal._plotCoherence(a.freq, a.Cxy, Navr=a.Navr)
    pt.fftanal._plotsemilogAmp(a.freq[1:], a.Pxx[1:], a.Pyy[1:], a.Pxy[1:])
    plt.close("all")


# --------------------------------------------------------------------------- #
# spectrogram
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [dict(), dict(hanning=False),
                                dict(overlap=False), dict(windowAverage=4)])
def test_specgram_matches_jax(kw):
    tt, y = psg.test_case(case=3, npts=4000)
    a = psg.specgram(tt, y, 128, **kw)
    b = jsg.specgram(tt, y, 128, **kw)
    for u, v in zip(a, b):
        _close(u, v)


@pytest.mark.parametrize("case", [1, 2, 3])
def test_test_case_and_stft_wrapper_match_jax(case):
    tt, y = psg.test_case(case=case, npts=2000)
    tj, yj = jsg.test_case(case=case, npts=2000)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(y, yj)
    cls = psg.stft(tt, y, tper=0.1, returnclass=True)
    ref = jsg.stft(tt, y, tper=0.1, returnclass=True)
    _compare(cls, ref, ["freq", "tseg", "Xseg", "Pxx"])
    twin, freq, Xseg = psg.stft(tt, y, tper=0.1, returnclass=False)
    tw2, f2, X2 = jsg.stft(tt, y, tper=0.1, returnclass=False)
    for u, v in ((twin, tw2), (freq, f2), (Xseg, X2)):
        _close(u, v)
    assert Xseg.shape[0] == cls.Navr


@pytest.mark.parametrize("scale", ["log", "linear"])
def test_STFT_class_matches_jax(scale):
    tt, y = psg.test_case(case=1, npts=2000)
    a = psg.STFT(y, fs=2000, win_size=256, fft_size=256)
    b = jsg.STFT(y, fs=2000, win_size=256, fft_size=256)
    ra, rb = a.stft(scale=scale), b.stft(scale=scale, clip=None)
    assert ra.dtype == np.float32 and ra.shape == (a.total_segments, 256)
    fin = np.isfinite(rb)
    np.testing.assert_array_equal(np.isfinite(ra), fin)
    np.testing.assert_allclose(ra[fin], rb[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(rb[fin]).max())
    _close(a.stft(scale="linear", clip=(0.0, 1e-3)),
           b.stft(scale="linear", clip=(0.0, 1e-3)), rtol=1e-5, floor=1e-5)
    np.testing.assert_array_equal(a.freq_axis(), b.freq_axis())
    np.testing.assert_array_equal(a.time_axis(), b.time_axis())


def test_spectrogram_demos_match_jax():
    a = psg.test_stft(npts=2000)
    b = jsg.test_stft(npts=2000)
    _compare(a, b, ["Xseg", "Pxx"])
    for u, v in zip(psg.test_specgram(npts=2000),
                    jsg.test_specgram(npts=2000)):
        _close(u, v)


# --------------------------------------------------------------------------- #
# integrate, interp, upsample
# --------------------------------------------------------------------------- #

def _spectra(n=200, nch=1, seed=0):
    rng = np.random.default_rng(seed)
    freq = np.linspace(0, 500, n)
    shape = (n,) if nch == 1 else (n, nch)
    Pxx = 1.0 + rng.random(shape)
    Pyy = 1.0 + rng.random(shape)
    Pxy = (rng.random(shape) - 0.5) + 1j * (rng.random(shape) - 0.5)
    varPxx = 0.01 * rng.random(shape)
    varPyy = 0.01 * rng.random(shape)
    varPxy = 0.01 * (rng.random(shape) + 1j * rng.random(shape))
    return freq, Pxy, Pxx, Pyy, varPxy, varPxx, varPyy


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                               atol=1e-300, equal_nan=True)


@pytest.mark.parametrize("nch", [1, 3])
def test_integrate_toolbox_matches_jax(nch):
    freq, Pxy, Pxx, Pyy, vxy, vxx, vyy = _spectra(nch=nch)
    for ms in (True, False):
        _same(pint.varcoh(Pxy, vxy, Pxx, vxx, Pyy, vyy, meansquared=ms),
              jint.varcoh(Pxy, vxy, Pxx, vxx, Pyy, vyy, meansquared=ms))
        _same(pint.monticoh(Pxy, vxy, Pxx, vxx, Pyy, vyy, nmonti=50,
                            meansquared=ms, rng=np.random.default_rng(4)),
              jint.monticoh(Pxy, vxy, Pxx, vxx, Pyy, vyy, nmonti=50,
                            meansquared=ms, rng=np.random.default_rng(4)))
    for ar in (np.pi, 0.4):
        _same(pint.varphi(Pxy.real, Pxy.imag, vxy.real, vxy.imag, ar),
              jint.varphi(Pxy.real, Pxy.imag, vxy.real, vxy.imag, ar))
        _same(pint.montiphi(Pxy, vxy, nmonti=50, angle_range=ar,
                            rng=np.random.default_rng(5)),
              jint.montiphi(Pxy, vxy, nmonti=50, angle_range=ar,
                            rng=np.random.default_rng(5)))
    phi = np.angle(Pxy)
    _same(pint.mean_angle(phi, np.abs(vxy), dim=0, vsyst=np.abs(vxx)),
          jint.mean_angle(phi, np.abs(vxy), dim=0, vsyst=np.abs(vxx)))
    ph = np.unwrap(phi if nch == 1 else phi[:, 0]) + 7.0
    for kw in (dict(), dict(rtol=0.1), dict(atol=0.3, itol=2)):
        _same(pint.unwrap_tol(ph, **kw), jint.unwrap_tol(ph, **kw))
    for v in ((vxy, vxx, vyy), (None, None, None)):
        a = pint.integratespectra(freq, Pxy, Pxx, Pyy, [50.0, 300.0], *v)
        b = jint.integratespectra(freq, Pxy, Pxx, Pyy, [50.0, 300.0], *v)
        _same(a[:5], b[:5])
        for k in b[5].__dict__:
            _same(getattr(a[5], k), getattr(b[5], k))


def test_getNpeaks_matches_jax():
    nt, fs = 1 << 13, 1e4
    t = np.arange(nt) / fs
    rng = np.random.default_rng(8)
    x = (np.sin(2 * np.pi * 700 * t) + 0.5 * np.sin(2 * np.pi * 2100 * t)
         + 0.1 * rng.standard_normal(nt))
    y = np.roll(x, 3) + 0.1 * rng.standard_normal(nt)
    kw = dict(tbounds=[t[1], t[-2]], Navr=8, plotit=False, fmin=100.0)
    a = pint.getNpeaks(3, t, x, y, **kw)
    b = jint.getNpeaks(3, t, x, y, **kw)
    assert len(a) == len(b) == 3
    for pa, pb in zip(a, b):
        _same(pa[1], pb[1])
        np.testing.assert_allclose(pa[0], pb[0], rtol=1e-10)
        np.testing.assert_allclose(pa[2], pb[2], rtol=1e-10, atol=1e-12)
    assert abs(a[0][1] - 700.0) < 10.0
    assert any(abs(p[1] - 2100.0) < 10.0 for p in a)


def test_interp_helpers_match_jax():
    rng = np.random.default_rng(6)
    xi = np.sort(rng.random(50)) * 10
    yi = rng.standard_normal((50, 3))
    ei = 0.1 * rng.random((50, 3))
    xo = np.linspace(-1, 11, 77)
    _same(pip.interp(xi, yi, xo=xo), jip.interp(xi, yi, xo=xo))
    _same(pip.interp(xi, yi, ei=ei, xo=xo), jip.interp(xi, yi, ei=ei, xo=xo))
    _same(pip.interp(xi, yi[:, 0]), jip.interp(xi, yi[:, 0]))
    for dim in (0, 1):
        _same(pip.trapz_var(xi if dim == 0 else xi[:3], yi, None, ei,
                            dim=dim)[:2],
              jip.trapz_var(xi if dim == 0 else xi[:3], yi, None, ei,
                            dim=dim)[:2])
    _same(pip.trapz_var(xi, yi[:, 1])[:2], jip.trapz_var(xi, yi[:, 1])[:2])
    t = np.arange(100) / 10
    for ss in (None, 3):
        _same(pip.sliding_window_1d(t, yi[:, 0].repeat(2), 8, ss=ss),
              jip.sliding_window_1d(t, yi[:, 0].repeat(2), 8, ss=ss))
    _same(pip.sliding_window_1d(t, t, 8, ss=4, ind_only=True),
          jip.sliding_window_1d(t, t, 8, ss=4, ind_only=True))
    for a in (np.arange(5.0), np.ones((1, 4)), np.ones((4, 2)), [1.0, 2.0]):
        r = pip.reshapech(a)
        assert r.shape == np.asarray(jip.reshapech(a)).shape
    g = np.linspace(-1, 1, 9)
    _same(pip.rect(g), jip.rect(g))
    _same(pip.delta(g), jip.delta(g))


@pytest.mark.parametrize("fs_new", [2e3, 3.3e3])
def test_upsample_matches_jax(fs_new):
    u = np.sin(np.arange(300) / 7.0)
    a = pt.upsample(u, 1e3, fs_new)
    b = jfilt.upsample(u, 1e3, fs_new)
    assert isinstance(a, np.ndarray)
    _same(a, b)


# --------------------------------------------------------------------------- #
# examples, and the slice as a whole
# --------------------------------------------------------------------------- #

def _pwelch_tuples(u, v):
    """fft_pwelch 7-tuples; coherence and phase where the cross-power is
    above 1e-8 of its peak (the noise-free test signals have bins of
    numerical zero, whose coherence is a ratio of rounding errors)."""
    for p, q in zip(u[:4], v[:4]):
        _close(p, q)
    strong = np.abs(v[1]) > 1e-8 * np.abs(v[1]).max()
    _close(u[4][strong], v[4][strong], what="Cxy")
    _close(u[5][strong], v[5][strong], what="phi_xy")


def test_examples_match_jax():
    for u, v in zip(pex.test_fftpwelch(nargout=2),
                    jex.test_fftpwelch(nargout=2)):
        _pwelch_tuples(u, v)
    a = pex.test_fftanal(nargout=1, N=2 ** 14, seed=0)
    b = jex.test_fftanal(nargout=1, N=2 ** 14, seed=0)
    _compare(a, b, ["freq", "Pxx", "Pyy", "Pxy", "phi_xy"])
    for p, q in zip(pex.create_turb_spectra(), jex.create_turb_spectra()):
        _close(p, q)
    for u, v in zip(pex.test(), jex.test()):
        _pwelch_tuples(u, v)
    home, orac = pex.testFFTanal()
    assert abs(home[0][np.argmax(np.abs(home[2]))]
               - orac[0][np.argmax(np.abs(orac[2]))]) < 2 * home[0][1]
    # ported with deriv.py; held against the JAX example in
    # tests/test_torch_analysis.py
    assert set(jex.__all__) <= set(pex.__all__)


def test_config2_chirp_slice_as_a_whole():
    """Bench config 2 at a small size: a float32 chirp (f_inst from 1 to
    200 kHz-equivalent, here scaled to 2^14 samples) through
    ``pt.fftanal(...).pwelch()`` and ``pt.stft`` on the kernel route (the
    plain version here), against the JAX class on its kernel route and
    against the port's own float64 core; the per-segment peak tracks
    f_inst within 2 bins."""
    fs, nt, nwins = 1e6, 1 << 14, 256
    n = np.arange(nt)
    f_inst = 1e3 + 199e3 * n / nt
    chirp = np.sin(2 * np.pi * np.cumsum(f_inst) / fs).astype(np.float32)
    t = n / fs
    kw = dict(tper=(nwins + 0.5) / fs, windowoverlap=0.5, plotit=False,
              verbose=False)
    a = pt.fftanal(t, chirp, fft_backend="pallas", **kw)
    b = ft.fftanal(t, chirp, fft_backend="pallas", **kw)
    c = pt.fftanal(t, chirp, fft_backend="xla", **kw)
    for o in (a, b, c):
        o.pwelch()
    assert a.nwins == nwins and a.Navr == (nt - nwins // 2) // (nwins // 2)
    _compare(a, b, ["tseg", "freq"], rtol=1e-9, floor=1e-12)
    _compare(a, b, ["Xseg", "Pxx"], rtol=1e-4, floor=1e-5)
    _compare(a, b, ["Xpow"], rtol=1e-5, floor=1e-9)
    _compare(a, c, ["Xseg", "Xpow", "Pxx"], rtol=1e-4, floor=1e-5)
    pk = a.freq[np.argmax(np.abs(a.Xseg), axis=1)]
    want = 1e3 + 199e3 * a.tseg * fs / nt
    assert np.all(np.abs(pk - want) <= 2 * fs / nwins)
    s = pt.stft(t, chirp, tper=(nwins + 0.5) / fs, windowoverlap=0.5,
                fft_backend="pallas")
    np.testing.assert_array_equal(s.Xseg, a.Xseg)
    assert isinstance(torch.as_tensor(s.Xseg), torch.Tensor)
