"""The port's slice as a whole against the JAX package, plus its host-side
modules (windows, segmentation, detrend, Struct, config) and the rule that
the port never imports JAX.

float64 comparisons hold rtol 1e-10 (same arithmetic, different FFT
libraries); float32 kernel paths hold rtol 5e-5 as in
tests/test_pallas_welch.py; host NumPy code copied from the JAX package is
held bit for bit.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pyfft_tpu as ft
import pyfft_tpu.config as jcfg
import pyfft_tpu.segmentation as jseg
import pyfft_tpu.utils.detrend as jdet
import pyfft_tpu.windows as jwin

import pyfft_tpu_torch as pt
import pyfft_tpu_torch.config as pcfg
import pyfft_tpu_torch.segmentation as pseg
import pyfft_tpu_torch.utils.detrend as pdet
import pyfft_tpu_torch.windows as pwin
from pyfft_tpu_torch.utils import Struct
from pyfft_tpu_torch.config import default_device

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, pyfft_tpu_torch, pyfft_tpu_torch.ops.welch, "
            "pyfft_tpu_torch.ops.fir, pyfft_tpu_torch.ops._build, "
            "pyfft_tpu_torch.ops.stft, pyfft_tpu_torch.ops.transform, "
            "pyfft_tpu_torch.fftanal, pyfft_tpu_torch.spectrogram, "
            "pyfft_tpu_torch.integrate, pyfft_tpu_torch.examples, "
            "pyfft_tpu_torch.plotting, pyfft_tpu_torch.entry\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pyfft_tpu' or "
            "m.startswith('pyfft_tpu.'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("name", sorted(jwin.window_registry()))
def test_windows_copy_is_bit_identical(name):
    kw = {"beta": 8.6} if name == "kaiser" else {}
    for n in (7, 64, 513):
        a = pwin.windows(name, nwins=n, verbose=False, **kw)
        b = jwin.windows(name, nwins=n, verbose=False, **kw)
        np.testing.assert_array_equal(a, b)
        a = pwin.windows(name, nwins=n, verbose=False, periodic=False, **kw)
        b = jwin.windows(name, nwins=n, verbose=False, periodic=False, **kw)
        np.testing.assert_array_equal(a, b)
    assert pwin.windows(name, verbose=False) == jwin.windows(name,
                                                            verbose=False)
    assert pwin.window_registry() == jwin.window_registry()
    # the callable-module shim
    assert pt.windows(name, verbose=False) == jwin.windows(name,
                                                          verbose=False)


@pytest.mark.parametrize("name", ["hann", "hamming", "blackman", "nuttall",
                                  ("kaiser", 5.0), ("tukey", 0.3), "triang",
                                  ("dpss", 2.5), ("chebwin", 80)])
def test_get_window_copy_is_bit_identical(name):
    for fftbins in (True, False):
        np.testing.assert_array_equal(pt.get_window(name, 65, fftbins),
                                      jwin.get_window(name, 65, fftbins))


def test_segmentation_arithmetic_matches_jax():
    for nsig in (100, 1000, 4097, 65536):
        for ov in (0.0, 0.5, 0.75, 2 / 3):
            for navr in (1, 3, 8, 40):
                if navr * (1 - ov) + ov > nsig:
                    continue
                a = pseg.plan_segments(nsig, navr=navr, windowoverlap=ov)
                b = jseg.plan_segments(nsig, navr=navr, windowoverlap=ov)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
                assert a.hop == b.hop and a.cola == b.cola
                np.testing.assert_array_equal(a.starts(), b.starts())
            for nwins in (16, 255, 1024, nsig, nsig + 5):
                a = pseg.plan_segments(nsig, nwins=nwins, windowoverlap=ov)
                b = jseg.plan_segments(nsig, nwins=nwins, windowoverlap=ov)
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
    win = np.hanning(301)[:-1]
    assert pseg.get_norms(win, 150, 1e3) == jseg.get_norms(win, 150, 1e3)
    with pytest.raises(ValueError, match="Navr"):
        pseg.get_nwins(10, 100, 0.5)


@pytest.mark.parametrize("nwins,hop,navr", [(64, 32, 10), (100, 37, 7),
                                            (16, 16, 30), (256, 1, 5)])
def test_frame_signal_matches_jax(nwins, hop, navr):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 600))
    a = pseg.frame_signal(torch.from_numpy(x), nwins, hop, navr)
    b = np.asarray(jseg.frame_signal(x, nwins, hop, navr))
    assert tuple(a.shape) == b.shape == (3, navr, nwins)
    np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="segments"):
        pseg.frame_signal(torch.from_numpy(x), 600, 1, 2)


@pytest.mark.parametrize("nwins", [1, 2, 17, 100, 101, 150])
def test_reflect_extend_matches_jax_and_numpy(nwins):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 2))
    a = pseg.reflect_extend(torch.from_numpy(x), nwins, axis=0).numpy()
    b = np.asarray(jseg.reflect_extend(x, nwins, axis=0))
    c = np.concatenate((x[nwins - 1:0:-1], x, x[-1:-nwins:-1]), axis=0)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("style", [None, 1, 0, -1])
@pytest.mark.parametrize("cplx", [False, True])
def test_detrend_matches_jax(style, cplx):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 333)) + np.linspace(0, 3, 333)
    if cplx:
        x = x + 1j * rng.standard_normal((4, 333))
    for axis in (0, 1, -1):
        a = pdet.detrend_func(style)(torch.from_numpy(x), axis=axis)
        b = np.asarray(jdet.detrend_func(style)(x, axis=axis))
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12)


def test_struct_behaves_like_the_jax_one():
    s = Struct({"a": 1})
    s.update(Struct({"b": 2}))
    assert "a" in s and s.b == 2
    assert Struct(s).dict_from_class() == {"a": 1, "b": 2}


def test_from_reference_rebuilds_config_and_plan():
    jc = jcfg.SpectralConfig(windowfunction="hamming", windowoverlap=0.5,
                             tper=0.25, detrend="linear",
                             fft_backend="pallas")
    pc = pcfg.from_reference(jc.to_dict())
    assert isinstance(pc, pcfg.SpectralConfig)
    assert pc.to_dict() == jc.to_dict()
    assert pc.detrend_style == jc.detrend_style == -1
    ra, rb = pc.resolve(10000, 1e3), jc.resolve(10000, 1e3)
    assert dataclasses.asdict(ra.plan) == dataclasses.asdict(rb.plan)
    np.testing.assert_array_equal(ra.win, rb.win)
    for f in ("overlap", "onesided", "S1", "S2", "NENBW", "ENBW", "Fs"):
        assert getattr(ra, f) == getattr(rb, f)
    np.testing.assert_array_equal(ra.freq, rb.freq)
    jp = jseg.plan_segments(5000, nwins=np.int64(512), windowoverlap=0.5)
    pp = pcfg.from_reference(dataclasses.asdict(jp))
    assert isinstance(pp, pseg.SegmentPlan)
    assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
    with pytest.raises(ValueError, match="detrend"):
        pcfg.from_reference({"detrend": "cubic"})


def _chain_signals(N=1 << 13, nch=3, cplx=False):
    rng = np.random.default_rng(9)
    t = np.arange(N) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.3 * rng.standard_normal(N)
    y = np.tile(x, (nch, 1)) + 0.1 * rng.standard_normal((nch, N))
    if cplx:
        x = x * np.exp(1j * 0.3) + 0.1j * rng.standard_normal(N)
        y = y + 1j * rng.standard_normal((nch, N))
    return t, x, y


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("detrend", [0, 1, -1])
def test_welch_psd_float64_matches_jax(cplx, detrend):
    """The config front door, built on both sides from one dict, in
    float64 ('xla'): rtol 1e-10 with a floor of 1e-10 of each scale."""
    t, x, y = _chain_signals(cplx=cplx)
    d = jcfg.SpectralConfig(Navr=6, detrend=detrend,
                            fft_backend="xla").to_dict()
    rj = jcfg.welch_psd(t, x, y, jcfg.SpectralConfig(**d),
                        tbounds=[t[2], t[-3]])
    rp = pcfg.welch_psd(t, x, y, pcfg.from_reference(d),
                        tbounds=[t[2], t[-3]], device="cpu")
    for a, b in zip(rp[:6], rj[:6]):
        a, b = np.asarray(a), np.asarray(b)
        if np.iscomplexobj(b) or b.dtype.kind == "f":
            ok = np.isfinite(b)
            scale = np.abs(b[ok]).max()
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * scale,
                                       equal_nan=True)


def test_headline_chain_as_a_whole_matches_jax():
    """FIR -> global-mean detrend -> Hann 50% segments -> DFT -> averaged
    powers -> coherence and phase, through the fused kernel path on both
    sides (JAX interpret, port plain; float32): spectra to rtol 2e-5 with
    atol 3e-5 of the scale, coherence near the line to 3e-5 absolute."""
    t, x, y = _chain_signals(N=1 << 14)
    taps = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    np.testing.assert_array_equal(
        taps, ft.filters.firwin(129, [0.05, 0.45], pass_zero=False))
    nwins = 1024
    win = pt.windows("hanning", nwins=nwins, verbose=False)
    plan = pseg.plan_segments(len(t), nwins=nwins, windowoverlap=0.5)
    jplan = jseg.plan_segments(len(t), nwins=nwins, windowoverlap=0.5)
    rj = ft.welch_filtered_cross_spectra(x, y, taps, win, jplan, 1e3,
                                         fft_backend="pallas")
    rp = pt.welch_filtered_cross_spectra(torch.from_numpy(x),
                                         torch.from_numpy(y), taps, win,
                                         plan, 1e3, fft_backend="pallas")
    scl = np.abs(rj["Pxx"]).max()
    for k in ("Pxx", "Pyy", "Pxy"):
        np.testing.assert_allclose(rp[k], rj[k], rtol=2e-5, atol=3e-5 * scl)
    Cp, _ = pt.Cxy_Cxy2(rp["Pxx"], rp["Pyy"], rp["Pxy"])
    Cj, _ = ft.Cxy_Cxy2(rj["Pxx"], rj["Pyy"], rj["Pxy"])
    # float32 spectra carry errors of ~1e-6 of the line's power in every
    # bin, so coherence is comparable where the power is within 1e-2 of it
    strong = np.abs(rj["Pxx"]) >= 1e-2 * scl
    assert strong.sum() >= 3
    np.testing.assert_allclose(Cp[strong], Cj[strong], atol=3e-5)
    ipk = np.argmax(np.abs(rp["Pyy"][:, 0]))
    assert abs(rp["freq"][ipk] - 97.0) <= 1e3 / nwins
    assert np.abs(Cp[ipk]).min() ** 2 > 0.9
