"""cwt, icwt and global_spectrum of pyfft_tpu_torch against the JAX
package's (x64), on the CPU: W, the reconstruction and the global
spectrum to 1e-10 of max (the two FFT libraries' rounding, as
tests/test_torch_heatpulse.py allows; one run under six xdist workers
measured 7.7e-11 at one case, 6e-16 alone), scales, freqs and coi to
1e-14; plus the physics checks of tests/test_wavelet_workunits.py on the
port alone."""
import numpy as np
import pytest
import torch

from pyfft_tpu import wavelet as jwv

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import wavelet as wv
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _chirp(fs=2000.0, n=8192):
    t = np.arange(n) / fs
    f_inst = 40.0 + 60.0 * t / t[-1]
    return np.sin(2 * np.pi * np.cumsum(f_inst) / fs), f_inst


@pytest.mark.parametrize("kw", [dict(), dict(dj=0.05), dict(s0=0.004, J=40),
                                dict(wavelet="omega8")])
@pytest.mark.parametrize("n", [4096, 3001])
def test_cwt_matches_jax(kw, n):
    x, _ = _chirp(n=n)
    x = x + 0.3
    if kw.get("wavelet") == "omega8":
        kj = dict(wavelet=jwv.Morlet(8.0))
        kp = dict(wavelet=wv.Morlet(8.0))
    else:
        kj = kp = kw
    Wj, sj, fj, cj = jwv.cwt(x, dt=1 / 2000.0, **kj)
    Wp, sp, fp, cp = wv.cwt(x, dt=1 / 2000.0, **kp)
    assert Wp.shape == Wj.shape and Wp.dtype == np.complex128
    assert _err(Wp, Wj) <= 1e-10
    for g, w in ((sp, sj), (fp, fj), (cp, cj)):
        np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)


def test_icwt_and_global_spectrum_match_jax():
    fs, n = 500.0, 2048
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * 20 * t) + 0.5 * np.sin(2 * np.pi * 60 * t)
    Wj, sj, _, _ = jwv.cwt(x, dt=1 / fs, dj=0.05)
    Wp, sp, _, _ = wv.cwt(x, dt=1 / fs, dj=0.05)
    assert _err(wv.icwt(Wp, sp, dt=1 / fs, dj=0.05),
                jwv.icwt(Wj, sj, dt=1 / fs, dj=0.05)) <= 1e-10
    assert _err(wv.global_spectrum(Wp), jwv.global_spectrum(Wj)) <= 1e-10
    # the port's icwt and global_spectrum take tensors too
    assert _err(wv.global_spectrum(torch.as_tensor(Wp)),
                wv.global_spectrum(Wp)) == 0


def test_cwt_ridge_frequency():
    fs, n, f0 = 1000.0, 4096, 50.0
    t = np.arange(n) / fs
    W, scales, freqs, coi = wv.cwt(np.sin(2 * np.pi * f0 * t), dt=1 / fs)
    fpk = freqs[int(np.argmax(wv.global_spectrum(W)))]
    assert abs(fpk - f0) / f0 < 0.1
    assert W.shape == (len(scales), n)
    assert coi.shape == (n,) and coi[0] == 0.0


def test_icwt_reconstruction():
    fs, n = 500.0, 2048
    t = np.arange(n) / fs
    x = np.sin(2 * np.pi * 20 * t) + 0.5 * np.sin(2 * np.pi * 60 * t)
    W, scales, _, _ = wv.cwt(x, dt=1 / fs, dj=0.05)
    xr = wv.icwt(W, scales, dt=1 / fs, dj=0.05)
    core = slice(n // 4, 3 * n // 4)
    err = np.sqrt(np.mean((xr[core] - x[core]) ** 2)) / np.std(x[core])
    assert err < 0.1


def test_cwt_tracks_chirp():
    x, f_inst = _chirp()
    W, scales, freqs, _ = wv.cwt(x, dt=1 / 2000.0)
    for frac in (0.25, 0.75):
        idx = int(frac * x.size)
        fr = freqs[int(np.argmax(np.abs(W[:, idx])))]
        assert abs(fr - f_inst[idx]) / f_inst[idx] < 0.15


def test_float32_tensor_and_exports():
    """A float32 tensor runs in complex64 (what the card runs), within
    1e-5 of the float64 path; ``pt.pycwt`` is the module."""
    x, _ = _chirp()
    x32 = x.astype(np.float32)
    W64, *_ = wv.cwt(x32.astype(np.float64), dt=1 / 2000.0)
    W32, *_ = wv.cwt(torch.as_tensor(x32), dt=1 / 2000.0)
    assert _err(W32, W64) <= 1e-5
    assert pt.pycwt is pt.wavelet is wv
    assert pt.pycwt.Morlet().flambda == jwv.Morlet().flambda
