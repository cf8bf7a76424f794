"""HeatPulseFFT of pyfft_tpu_torch against the JAX package's.

The synthetic set of tests/test_heatpulse.py (6 channels, 16 kHz, 4 s:
nwins 1964, not a power of two) through both packages, the port asked for
the CPU.  Tolerances:

- ``run()`` in float64 (JAX in x64, tests/conftest.py): rtol 1e-10 with
  atol 1e-10 * max|ref| (the FFT libraries' rounding);
- ``run(fft_backend='pallas')``: TPU kernel #7 in interpret mode against
  kernel E's plain version, both float32: rtol 1e-5 with atol 1e-5 *
  max|ref|;
- host NumPy code the port copies (settings, sorting, HDF5, the density
  fit): exact or 1e-12.
"""
import numpy as np
import pytest

import pyfft_tpu.heatpulse as jhp

import pyfft_tpu_torch as pt
import pyfft_tpu_torch.heatpulse as php
from pyfft_tpu_torch.ops import welch_v1
from test_heatpulse import RUNINFO
from pyfft_tpu_torch.config import default_device

FIELDS = ("Amp", "Phase", "Coh", "Txy", "varA", "varP", "Tnn", "fmods",
          "Txx", "Vxy", "varC", "RMSECHpower", "ModECHpower")


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def data():
    return jhp.synth_heatpulse_data(nch=6, fmod=33.0, fs=16.0e3, T=4.0)


def _run_both(data, backend=None, **settings):
    """The JAX package's HeatPulseFFT and the port's (on the CPU), run."""
    a = jhp.HeatPulseFFT(dict(RUNINFO, **settings), dict(data))
    a.PreCheck()
    a.run(fft_backend=backend)
    b = php.HeatPulseFFT(dict(RUNINFO, device="cpu", **settings), dict(data))
    b.PreCheck()
    b.run(fft_backend=backend)
    return a, b


def _close(got, want, tol, names):
    for name in names:
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=name)


@pytest.fixture(scope="module")
def xla_pair(data):
    return _run_both(data)


def test_synthetic_data_matches_jax():
    for kw in (dict(nch=6, fmod=33.0, fs=16.0e3, T=4.0),
               dict(nch=3, fmod=20.0, fs=5e3, T=1.0, tau_damp=0.05, seed=4)):
        a = jhp.synth_heatpulse_data(**kw)
        b = php.synth_heatpulse_data(**kw)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


def test_settings_match_jax(xla_pair):
    a, b = xla_pair
    assert b.nwins == a.nwins == 1939 and int(b.Navr) == int(a.Navr) == 56
    assert b.noverlap == a.noverlap and b.nsig == a.nsig
    np.testing.assert_array_equal(b._ifk, a._ifk)
    assert b._ifw == a._ifw


@pytest.mark.parametrize("name", FIELDS + ("Pxy", "Pyy", "Pxx"))
def test_run_matches_jax_x64(xla_pair, name):
    a, b = xla_pair
    _close(b, a, 1e-10, (name,))


def test_run_pallas_takes_kernel_e_and_matches_jax(data):
    """nwins = 1964 in fft_pwelch (Navr 56): kernel B's gate fails, the
    gate of TPU kernel #7 holds; the port runs kernel E's plain version."""
    a, b = _run_both(data, "pallas")
    from pyfft_tpu_torch import spectral as psp
    assert psp.pallas_route(nwins=1964, noverlap=982, navr=56,
                            nnyquist=982, onesided=True, detrend_style=1,
                            ntmodel=False, is_cplx=False) == "E"
    assert welch_v1.LAUNCHES == 0          # the plain version on the CPU
    _close(b, a, 1e-5, FIELDS)


def test_pallas_route_agrees_with_xla_route(data, xla_pair):
    """The port's two routes on the same data: float32 kernel path against
    the float64 torch.fft path, rtol 1e-5."""
    b = php.HeatPulseFFT(dict(RUNINFO, device="cpu"), dict(data))
    b.PreCheck()
    b.run(fft_backend="pallas")
    _close(b, xla_pair[1], 1e-5, ("Amp", "Phase", "Coh", "fmods"))


def test_physics_sanity(xla_pair):
    b = xla_pair[1]
    assert np.all(np.diff(b.Amp[:, 0]) < 0)
    np.testing.assert_allclose(np.diff(np.unwrap(b.Phase[:, 0])),
                               2 * np.pi * 33.0 * 2.0e-3, rtol=0.05)
    assert abs(b.fmods[0] - 33.0) < 2.0 and b.Coh[0, 0] > 0.95


def test_usesegs_matches_jax(data):
    a, b = _run_both(data, usesegs=True)
    assert b.Amp.shape == (6, 2, int(b.Navr))
    _close(b, a, 1e-10, ("Amp", "Phase", "Coh", "Txy", "varA", "Tnn",
                         "fmods", "Txx"))


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_per_channel_path_matches_batched(data, backend):
    """``_PWELCH_ch`` channel by channel against ``_PWELCH_all``, both in
    the port (float64: 1e-8 as in tests/test_heatpulse.py; the kernel
    route: 1e-5, one float32 call per channel against one batched call)."""
    def settle(drv):
        drv.PreCheck()
        drv._PWELCH_settings_()
        drv._PWELCH_preallocate()
        return drv
    a = settle(php.HeatPulseFFT(dict(RUNINFO, device="cpu"), dict(data)))
    a._PWELCH_all(fft_backend=backend)
    b = settle(php.HeatPulseFFT(dict(RUNINFO, device="cpu"), dict(data)))
    for ii in range(int(b.nch)):
        b._PWELCH_ch(ii, fft_backend=backend)
    tol = 1e-8 if backend is None else 1e-5
    _close(b, a, tol, ("Pxy", "Pyy", "Txy", "Amp", "Coh", "Phase", "Tnn",
                       "Txx", "Vxy", "varA", "varC", "varP"))


def test_per_channel_path_matches_jax(data):
    def settle(mod):
        drv = mod.HeatPulseFFT(dict(RUNINFO, **({} if mod is jhp else
                                               {"device": "cpu"})),
                               dict(data))
        drv.PreCheck()
        drv._PWELCH_settings_()
        drv._PWELCH_preallocate()
        for ii in range(int(drv.nch)):
            drv._PWELCH_ch(ii)
        return drv
    _close(settle(php), settle(jhp), 1e-10, ("Pxy", "Pyy", "Txy", "Amp",
                                             "Coh", "Tnn"))


def test_igch_and_filter_match_jax(data):
    a, b = _run_both(data, igch=np.asarray([2, 5]))
    np.testing.assert_array_equal(b.usech, a.usech)
    assert not b.usech[1] and not b.usech[4] and b.usech.sum() == 4
    ka, kb = a.__chfilter__(), b.__chfilter__()
    assert kb.nch == ka.nch == 4
    np.testing.assert_array_equal(kb.chnum, ka.chnum)
    _close(kb, ka, 1e-10, ("Amp", "Phase", "Coh", "ece_freq", "ece_roa"))


@pytest.mark.parametrize("sortby", ["RF", "roa", "abs roa"])
def test_sorting_matches_jax(xla_pair, sortby):
    a, b = xla_pair
    order = b._sortECEdat_(sortby=sortby)
    np.testing.assert_array_equal(order, a._sortECEdat_(sortby=sortby))
    amp = b.Amp.copy()
    rev = order[::-1]
    b.__sortECEdat__(rev)
    np.testing.assert_array_equal(b.Amp, amp[rev])
    b.__sortECEdat__(np.argsort(rev))
    np.testing.assert_array_equal(b.Amp, amp)
    with pytest.raises(ValueError):
        b._sortECEdat_(sortby="nope")


def test_hdf5_roundtrip_reads_back_in_jax(tmp_path, xla_pair):
    """The port writes, both packages read the same file back."""
    a, b = xla_pair
    f = str(tmp_path / "hp.hdf5")
    fftres = b._mkfftdict_()
    assert "device" not in fftres and "sig" not in fftres
    assert sorted(fftres) == sorted(a._mkfftdict_())
    php.save_hdf5(f, {"FFTResults": fftres})
    for mod in (php, jhp):
        back = mod.loadFFTdata(f)
        np.testing.assert_allclose(back["Amp"], b.Amp)
        np.testing.assert_allclose(back["Phase"], b.Phase)
        np.testing.assert_allclose(back["fmods"], b.fmods)
    php.save_hdf5(f, {"Inputs": {"fmod": 33.0, "winfun": "hanning"}})
    inputs = php.load_hdf5(f, "Inputs")
    assert inputs["fmod"] == 33.0 and inputs["winfun"] == "hanning"


def test_save_dat_and_load_hp_data(tmp_path, xla_pair):
    b = xla_pair[1]
    b.savedir = str(tmp_path)
    b.sfilename = "shot"
    path = b.save_dat(Inputs={"fmod": 33.0}, DataIn={"nch": 6},
                      FFTResults=b._mkfftdict_())
    # loadHPdata returns the groups of Results, Inputs, DataIn present
    inputs, datain = php.loadHPdata(path)
    assert inputs["fmod"] == 33.0 and datain["nch"] == 6
    loaded = php.load_hdf5(path)
    assert loaded["Inputs"]["fmod"] == 33.0 and loaded["DataIn"]["nch"] == 6
    np.testing.assert_allclose(loaded["FFTResults"]["Amp"], b.Amp)


def test_integrate_spectra_usesegs_shapes(data):
    runinfo = dict(RUNINFO, usesegs=True, device="cpu")
    drv = php.HeatPulseFFT(runinfo, dict(data))
    drv.PreCheck()
    drv._PWELCH_settings_()
    drv._PWELCH_preallocate()
    drv._PWELCH_all()
    navr = int(drv.Navr)
    fi = pt.fft_pwelch(np.asarray(drv.tt), np.asarray(drv.refsig),
                       np.asarray(drv.sig)[:, 0], np.asarray(drv.tbounds),
                       Navr=navr, windowoverlap=drv.overlap,
                       windowfunction=drv.winfun, plotit=False,
                       verbose=False, device="cpu")[-1]
    freq = np.asarray(fi.freq)
    frange = np.asarray([freq[drv._ifk[0] - drv._ifw],
                         freq[drv._ifk[0] + drv._ifw]])
    out = drv.integrate_spectra(fi, frange)
    assert len(out) == 10
    assert all(np.shape(o) == (navr, 1) for o in out)


def test_fit_neprofile_matches_jax():
    roa = np.linspace(0.1, 0.9, 15)
    q = dict(roa=roa, ne=5e19 * (1 - roa ** 2) + 5e17)
    rvec = np.linspace(0.2, 0.8, 20)
    for lg in (True, False):
        got = php.fit_neprofile(q, rvec, loggradient=lg)
        want = jhp.fit_neprofile(q, rvec, loggradient=lg)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def test_aliases_and_exports():
    assert php.__HeatPulse_base__ is php.HeatPulseBase
    assert php.__HeatPulse_FFTbase__ is php.HeatPulseFFT
    assert pt.HeatPulseFFT is php.HeatPulseFFT and pt.heatpulse is php
    assert sorted(php.__all__) == sorted(jhp.__all__)
