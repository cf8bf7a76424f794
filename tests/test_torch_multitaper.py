"""multitaper_psd and multitaper_csd of pyfft_tpu_torch against the JAX
package's (x64), on the CPU: each weighting and the CSD to 1e-10 of max
(the two ``rfft`` libraries' rounding), plus the physics checks of
tests/test_multitaper.py on the port alone."""
import numpy as np
import pytest
import torch

from pyfft_tpu import multitaper as jmt

import pyfft_tpu_torch as pt
from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.multitaper import multitaper_psd, multitaper_csd

FS, N = 1.0e4, 8192
TOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def tone():
    rng = np.random.default_rng(11)
    t = np.arange(N) / FS
    x = np.sin(2 * np.pi * 1250.0 * t) + 0.05 * rng.standard_normal(N)
    y = 0.6 * np.sin(2 * np.pi * 1250.0 * t - 0.7) \
        + 0.05 * rng.standard_normal(N)
    return t, x, y


def _err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("weighting", ["unity", "eigen", "adaptive"])
@pytest.mark.parametrize("n", [N, N - 1])
def test_psd_matches_jax(tone, weighting, backend, n):
    _, x, _ = tone
    fj, Sj = jmt.multitaper_psd(x[:n], fs=FS, NW=4, weighting=weighting)
    fp, Sp = multitaper_psd(x[:n], fs=FS, NW=4, weighting=weighting,
                            fft_backend=backend)
    np.testing.assert_allclose(fp, fj, rtol=1e-14)
    assert Sp.shape == Sj.shape
    assert _err(Sp, Sj) <= TOL


@pytest.mark.parametrize("K", [None, 3])
def test_csd_matches_jax(tone, K):
    _, x, y = tone
    want = jmt.multitaper_csd(x, y, fs=FS, NW=3.5, K=K)
    got = multitaper_csd(x, y, fs=FS, NW=3.5, K=K)
    for g, w, name in zip(got, want, ("freq", "Pxy", "Pxx", "Pyy", "Cxy2",
                                      "phi")):
        assert g.shape == w.shape, name
        keep = np.abs(want[1]) > 1e-6 * np.abs(want[1]).max()
        if name == "phi":
            g, w = g[keep], w[keep]
        assert _err(g, w) <= TOL, name


@pytest.mark.parametrize("weighting", ["unity", "eigen", "adaptive"])
def test_parseval_and_peak(tone, weighting):
    _, x, _ = tone
    freq, S = multitaper_psd(x, fs=FS, NW=4, weighting=weighting)
    df = freq[1] - freq[0]
    assert abs(np.sum(S) * df - np.var(x)) < 0.05 * np.var(x)
    assert abs(freq[int(np.argmax(S))] - 1250.0) < 16 * df


def test_csd_phase_and_coherence(tone):
    _, x, y = tone
    freq, Pxy, Pxx, Pyy, Cxy2, phi = multitaper_csd(x, y, fs=FS, NW=4)
    ipk = int(np.argmax(np.abs(Pxy)))
    assert abs(freq[ipk] - 1250.0) < 20.0
    assert Cxy2[ipk] > 0.95
    assert abs(phi[ipk] + 0.7) < 0.05
    with pytest.raises(ValueError):
        multitaper_csd(x, y[:-1], fs=FS)


def test_float32_tensor_computes_in_float32(tone):
    """A float32 tensor keeps its dtype through the transforms (what the
    card runs) and lands within 1e-5 of the float64 path."""
    _, x, _ = tone
    x32 = x.astype(np.float32)
    _, S64 = multitaper_psd(x32.astype(np.float64), fs=FS)
    _, S32 = multitaper_psd(torch.as_tensor(x32), fs=FS)
    assert _err(S32, S64) <= 1e-5


def test_errors_and_exports(tone):
    _, x, _ = tone
    with pytest.raises(ValueError, match="weighting"):
        multitaper_psd(x, weighting="median")
    assert pt.multitaper_psd is multitaper_psd
    assert pt.multitaper_csd is multitaper_csd
    assert pt.multitaper.multitaper_psd is multitaper_psd
