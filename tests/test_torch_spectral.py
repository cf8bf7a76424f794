"""pyfft_tpu_torch.spectral against pyfft_tpu.spectral on the CPU.

'xla' runs in float64 on both sides (JAX in x64, tests/conftest.py; torch
on float64 tensors): the arithmetic is the same up to the FFT libraries'
rounding, so outputs agree to rtol 1e-10 (with an absolute floor of 1e-10
of each array's scale for bins near zero).  'pallas' runs float32 kernels
on both sides (the JAX kernel in interpret mode, the port's plain version):
rtol 5e-5, as tests/test_pallas_welch.py holds the JAX kernel against its
float64 path.
"""
import numpy as np
import pytest
import torch

import pyfft_tpu as ft
import pyfft_tpu.spectral as jsp
from pyfft_tpu import segmentation as jseg

import pyfft_tpu_torch as pt
import pyfft_tpu_torch.spectral as psp
from pyfft_tpu_torch import segmentation as pseg
from pyfft_tpu_torch.config import default_device

_INFO_SKIP = {"winparams"}


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _close(a, b, rtol, floor, what):
    a = np.asarray(a)
    b = np.asarray(b)
    if b.dtype.kind in "OUS" or b.ndim == 0 and b.dtype.kind not in "fc":
        assert a.tolist() == b.tolist(), what
        return
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if "phi" in what:
        # a phase of a real negative bin (DC) is +pi or -pi by the sign of
        # a zero imaginary part: compare phases modulo 2 pi
        a = b + np.angle(np.exp(1j * (a - b)))
    fin = np.isfinite(b)
    scale = np.max(np.abs(b[fin])) if fin.any() else 0.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale,
                               equal_nan=True, err_msg=what)


def _compare(rp, rj, rtol, floor=1e-10):
    names = ("freq", "Pxy", "Pxx", "Pyy", "Cxy", "phi_xy")
    for name, a, b in zip(names, rp[:6], rj[:6]):
        _close(a, b, rtol, floor, name)
    ip, ij = rp[6], rj[6]
    keys = set(ij.__dict__) - _INFO_SKIP - {"_lazy_segments"}
    if "_lazy_segments" in ij.__dict__:
        keys |= set(psp._SEGMENT_FIELDS)
    assert keys <= set(ip.__dict__) | set(psp._SEGMENT_FIELDS)
    for k in sorted(keys):
        _close(getattr(ip, k), getattr(ij, k), rtol, floor, f"info.{k}")


def _signals(N=2 ** 13, nch=2, cplx=False, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(N)
    y = np.stack([np.sin(2 * np.pi * 97.0 * t - 0.5 * (c + 1))
                  + 0.1 * rng.standard_normal(N) for c in range(nch)])
    if cplx:
        x = x + 1j * np.cos(2 * np.pi * 97.0 * t)
        y = y + 1j * rng.standard_normal(y.shape)
    return t, x, y


@pytest.mark.parametrize("case", [
    "real_mean_subspan", "real_none_fullspan_1ch", "real_linear_odd_nwins",
    "complex_twosided", "ntmodel", "minfreq", "useMLAB", "hamming_fullspan",
])
def test_fft_pwelch_xla_float64_matches_jax(case):
    t, x, y = _signals(cplx=case == "complex_twosided",
                       nch=1 if "1ch" in case else 2)
    kw = dict(tbounds=[t[1], t[-2]], Navr=8, plotit=False,
              fft_backend="xla", detrend_style=1)
    if case == "real_none_fullspan_1ch":
        kw.update(tbounds=None, detrend_style=0)
        y = y[0]
    elif case == "real_linear_odd_nwins":
        kw.update(detrend_style=-1, Navr=None, tper=0.5015)   # nwins 501
    elif case == "ntmodel":
        kw.update(Navr=None)
        x = x[:640]
    elif case == "minfreq":
        kw.update(Navr=None, minFreq=4.0)
    elif case == "useMLAB":
        kw.update(useMLAB=True)
    elif case == "hamming_fullspan":
        kw.update(tbounds=None, windowfunction="hamming")
    rj = ft.fft_pwelch(t, x, y, **kw)
    rp = pt.fft_pwelch(t, x, y, device="cpu", **kw)
    if case == "real_linear_odd_nwins":
        assert rp[6].nwins == 501
    if case == "complex_twosided":
        assert rp[0][0] < 0                   # two-sided, fftshifted
    _compare(rp, rj, rtol=1e-10)


def test_fft_pwelch_accepts_tensors_and_keeps_their_device():
    t, x, y = _signals()
    kw = dict(tbounds=[t[1], t[-2]], Navr=8, plotit=False, fft_backend="xla")
    rj = ft.fft_pwelch(t, x, y, **kw)
    rp = pt.fft_pwelch(torch.from_numpy(t), torch.from_numpy(x),
                       torch.from_numpy(y), **kw)
    _compare(rp, rj, rtol=1e-10)


@pytest.mark.parametrize("cplx", [False, True])
def test_fft_pwelch_pallas_matches_jax_pallas(cplx):
    """Real input takes the fused one-sided kernel, complex input the
    two-sided one, on both sides.  The per-segment fields fill lazily on
    both sides with the float64 'xla' core: rtol 1e-10."""
    t, x, y = _signals(N=2 ** 13, nch=2, cplx=cplx)
    tper = 0.5125 if cplx else 1.0245            # nwins 512 / 1024
    kw = dict(tbounds=[t[1], t[-2]], tper=tper, plotit=False,
              fft_backend="pallas")
    rj = ft.fft_pwelch(t, x, y, **kw)
    rp = pt.fft_pwelch(t, x, y, device="cpu", **kw)
    assert rp[6].nwins == rj[6].nwins == (512 if cplx else 1024)
    assert "_lazy_segments" in rp[6].__dict__    # the fused path ran
    for name, i in (("freq", 0), ("Pxy", 1), ("Pxx", 2), ("Pyy", 3)):
        np.testing.assert_allclose(np.asarray(rp[i]), np.asarray(rj[i]),
                                   rtol=5e-5, atol=1e-9, err_msg=name)
    # coherence is a ratio whose float32 error scales with sqrt(Pxx Pyy),
    # not with |Pxy|: absolute 3e-5 on |Cxy| <= 1, and the phase error
    # weighted by |Cxy| (a phase at a bin of no coherence is noise)
    Cp, Cj = np.asarray(rp[4]), np.asarray(rj[4])
    np.testing.assert_allclose(Cp, Cj, rtol=5e-5, atol=3e-5)
    dphi = np.angle(np.exp(1j * (np.asarray(rp[5]) - np.asarray(rj[5]))))
    assert np.max(np.abs(Cj) * np.abs(dphi)) <= 3e-5
    for k in psp._SEGMENT_FIELDS:
        _close(getattr(rp[6], k), getattr(rj[6], k), 1e-10, 1e-10, k)
    assert "_lazy_segments" not in rp[6].__dict__


def test_lazy_fill_runs_once_and_explains_missing_fields():
    t, x, y = _signals()
    r = pt.fft_pwelch(t, x, y, tbounds=[t[1], t[-2]], tper=1.0245,
                      plotit=False, fft_backend="pallas", device="cpu")
    info = r[6]
    assert "Pxx_seg" not in info.__dict__
    seg = info.Pxx_seg
    assert seg.shape == (info.Navr, info.Nnyquist)
    assert info.Pxx_seg is seg
    bare = psp.fftinfosc()
    bare._defer_segments(None)
    del bare.__dict__["_lazy_segments"]
    with pytest.raises(AttributeError, match="not available"):
        bare.Xfft_seg


def test_pallas_falls_back_to_xla_outside_kernel_domain():
    """nwins 6000 is outside kernel B's gate (not a power of two) and
    outside TPU kernel #7's (over 5452 samples), where the JAX package too
    takes 'mxu': the 'pallas' path takes the torch.fft core (per-segment
    arrays present) and equals 'xla'.  (nwins 1820, inside #7's gate, takes
    kernel E: tests/test_torch_welch_v1.py.)"""
    t, x, y = _signals()
    kw = dict(tbounds=[t[1], t[-2]], tper=6000.5 / 1e3, plotit=False,
              device="cpu")
    rp = pt.fft_pwelch(t, x, y, fft_backend="pallas", **kw)
    rx = pt.fft_pwelch(t, x, y, fft_backend="xla", **kw)
    assert rp[6].nwins == 6000
    assert psp.pallas_route(nwins=6000, noverlap=rp[6].noverlap,
                            navr=rp[6].Navr, nnyquist=rp[6].Nnyquist,
                            onesided=True, detrend_style=1, ntmodel=False,
                            is_cplx=False) is None
    assert "Pxx_seg" in rp[6].__dict__
    _compare(rp, rx, rtol=0, floor=0)


@pytest.mark.parametrize("onesided", [True, False])
def test_welch_cross_spectra_matches_jax(onesided):
    t, x, y = _signals(cplx=not onesided)
    plan = pseg.plan_segments(len(t), nwins=600, windowoverlap=0.5)
    jplan = jseg.plan_segments(len(t), nwins=600, windowoverlap=0.5)
    win = np.hanning(601)[:-1]
    kw = dict(onesided=onesided, detrend_style=1, fft_backend="xla")
    rj = jsp.welch_cross_spectra(x, y, win, jplan, 1e3, **kw)
    rp = psp.welch_cross_spectra(x, y, win, plan, 1e3, device="cpu", **kw)
    for k in rj:
        _close(rp[k], rj[k], 1e-10, 1e-10, k)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_welch_filtered_cross_spectra_matches_jax(backend):
    """'xla' filters first (overlap-save) in float64 on both sides;
    'pallas' runs the fused kernel (JAX interpret, port plain) in float32:
    rtol 2e-5 with atol 3e-5 of the scale, as for the kernels."""
    rng = np.random.default_rng(4)
    nt, nwins = 1 << 14, 512
    x = rng.standard_normal(nt) + 0.2
    y = rng.standard_normal((3, nt)) + 0.5 * x
    taps = ft.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    win = np.hanning(nwins + 1)[:-1]
    plan = pseg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
    jplan = jseg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
    rj = jsp.welch_filtered_cross_spectra(x, y, taps, win, jplan, 1e3,
                                          fft_backend=backend)
    rp = psp.welch_filtered_cross_spectra(torch.from_numpy(x),
                                          torch.from_numpy(y), taps, win,
                                          plan, 1e3, fft_backend=backend)
    if backend == "pallas":
        assert rp["Pxx_seg"] is None
        rtol, floor = 2e-5, 3e-5
    else:
        rtol, floor = 1e-10, 1e-10
    for k in ("freq", "Pxx", "Pyy", "Pxy"):
        _close(rp[k], rj[k], rtol, floor, k)


def test_cpu_default_of_filtered_chain_is_filter_first():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096)
    y = rng.standard_normal((2, 4096))
    plan = pseg.plan_segments(4096, nwins=256, windowoverlap=0.5)
    out = psp.welch_filtered_cross_spectra(x, y, np.ones(5) / 5,
                                           np.hanning(256), plan, 1e3,
                                           device="cpu")
    assert out["Pxx_seg"] is not None


def test_cxy_and_csd_oracle_match_jax():
    rng = np.random.default_rng(6)
    Pxx = rng.random(50) + 0.1
    Pyy = rng.random((50, 3)) + 0.1
    Pxy = rng.standard_normal((50, 3)) + 1j * rng.standard_normal((50, 3))
    for a, b in zip(psp.Cxy_Cxy2(Pxx, Pyy, Pxy), jsp.Cxy_Cxy2(Pxx, Pyy, Pxy)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(psp.Cxy_Cxy2(Pxx, Pyy, Pxy, ibg=[1, 2]),
                    jsp.Cxy_Cxy2(Pxx, Pyy, Pxy, ibg=[1, 2])):
        np.testing.assert_array_equal(a, b)
    x = rng.standard_normal(3000)
    y = rng.standard_normal(3000)
    for sides in ("onesided", "twosided"):
        for nfft in (256, 255):
            a = psp.csd_oracle(x, y, nfft, 1e3, noverlap=nfft // 2,
                               sides=sides)
            b = jsp.csd_oracle(x, y, nfft, 1e3, noverlap=nfft // 2,
                               sides=sides)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_onesided_scales_match_jax():
    for nfft in (16, 17, 1024, 1025):
        nny = jseg.get_nnyquist(nfft)
        np.testing.assert_array_equal(psp._onesided_power_scale(nfft, nny),
                                      jsp._onesided_power_scale(nfft, nny))
        np.testing.assert_array_equal(psp._onesided_amp_scale(nfft, nny),
                                      jsp._onesided_amp_scale(nfft, nny))


def test_backend_names_and_mesh():
    assert psp.resolve_fft_backend(None) == "xla"
    assert psp.resolve_fft_backend("auto") == "xla"
    for name in ("xla", "mxu", "pallas"):
        assert psp.resolve_fft_backend(name) == name
    # mesh='auto' runs the sharded pipeline on a one-rank gloo group (the
    # mesh tier, tests/test_torch_parallel.py): the single-device result
    import torch.distributed as dist
    t, x, y = _signals(N=512)
    kw = dict(tbounds=[t[1], t[-2]], Navr=4, plotit=False)
    try:
        # the lazy segment fill is collective too: compare inside the group
        _compare(pt.fft_pwelch(t, x, y, mesh="auto", **kw),
                 pt.fft_pwelch(t, x, y, **kw), rtol=1e-12, floor=1e-12)
    finally:
        dist.destroy_process_group()


def test_mxu_is_an_alias_of_xla():
    t, x, y = _signals()
    kw = dict(tbounds=[t[1], t[-2]], Navr=8, plotit=False, device="cpu")
    _compare(pt.fft_pwelch(t, x, y, fft_backend="mxu", **kw),
             pt.fft_pwelch(t, x, y, fft_backend="xla", **kw), rtol=0,
             floor=0)
