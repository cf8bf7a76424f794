"""Executable examples (the reference's de-facto demo/test surface;
counterpart of :mod:`pyfft_tpu.examples`).

The reference ships runnable ``test_*`` functions behind ``__main__``
guards; users call them as smoke tests and usage examples.  The port's
equivalents, same signals and parameterizations:

- :func:`test_fftpwelch`   <- reference ``fft_analysis.py:2895-2948``
  (square wave vs phase-shifted sine; both the ``Navr=8`` and the
  ``minFreq`` parameterizations)
- :func:`test_fftanal`     <- reference ``:2950-3048`` (2^19-sample noisy
  sine pair through the class API)
- :func:`create_turb_spectra` <- reference ``:3051-3099`` (Gaussian
  correlation function -> turbulence-like spectrum)
- :func:`test` / :func:`testFFTanal` <- reference ``:3101-3109`` /
  ``:2817-2881`` (homebrew vs mlab-oracle cross-validation overplot)
- :func:`test_fft_deriv`   <- reference ``:1591-1656`` (the five analytic
  spectral-derivative cases)

Plotting only happens under ``plotit=True`` (lazy matplotlib import);
every function returns its result arrays so CI can assert on them.
"""
from __future__ import annotations

import numpy as np

from .spectral import fft_pwelch
from .fftanal import fftanal

__all__ = ["test_fftpwelch", "test_fftanal", "create_turb_spectra",
           "testFFTanal", "test", "test_fft_deriv"]


def _square(phase):
    return np.sign(np.sin(phase) + 1e-300)


def _pwelch_testsigs(N=2 ** 14, df=5.0, nch=1):
    """The reference's square-wave + phase-shifted-sine pair (:2900-2928)."""
    tvec = (1.0 / df) * np.arange(0.0, 1.0, 1.0 / N)
    sigx = 0.1 * _square(2.0 * np.pi * (df * 30.0) * tvec) + 7.0
    sigy = np.zeros((len(tvec), nch))
    for ii in range(nch):
        sigy[:, ii] = (np.sin(2.0 * np.pi * ((ii + 1) * df * 30.0) * tvec
                              - np.pi / 4.0 - ii * np.pi / 16) / (ii + 1)
                       + ii)
    sigy = 0.007 * sigy + 2.5
    return tvec, sigx, sigy


def test_fftpwelch(useMLAB=False, plotit=False, nargout=0, tstsigs=None,
                   verbose=False):
    """Square-wave/sine Welch demo, both parameterizations (:2895-2948)."""
    if tstsigs is None:
        tvec, sigx, sigy = _pwelch_testsigs()
        df = 5.0
    else:
        tvec, sigx, sigy = (np.array(t, copy=True) for t in tstsigs)
        df = 1.0 / (tvec[-1] - tvec[0])

    out1 = fft_pwelch(tvec, sigx, sigy, [tvec[0], tvec[-1]], Navr=8,
                      windowfunction="hamming", detrend_style=1,
                      useMLAB=useMLAB, plotit=plotit, verbose=verbose)
    out2 = fft_pwelch(tvec, sigx, sigy, [tvec[0], tvec[-1]],
                      minFreq=15 * df, detrend_style=1,
                      useMLAB=useMLAB, plotit=plotit, verbose=verbose)
    if nargout > 0:
        return out1, out2


def test_fftanal(useMLAB=False, plotit=False, nargout=0, tstsigs=None,
                 N=2 ** 19, seed=None):
    """Class-API demo on the 2^19-sample noisy sine pair (:2950-3048)."""
    if tstsigs is None:
        df = 5.0
        rng = np.random.default_rng(seed)
        tvec = (1.0 / df) * np.arange(0.0, 1.0, 1.0 / N)
        sigx = (0.005 * np.sin(2.0 * np.pi * (df * 30.0) * tvec) + 7.0
                + 0.02 * rng.standard_normal(tvec.shape))
        sigy = (0.005 * np.sin(2.0 * np.pi * (df * 30.0) * tvec - np.pi / 4)
                + 0.02 * rng.standard_normal(tvec.shape) + 2.5)
    else:
        tvec, sigx, sigy = (np.array(t, copy=True) for t in tstsigs)

    ft = fftanal(tvec, sigx, sigy, tbounds=[tvec[0], tvec[-1]], Navr=8,
                 windowfunction="hamming", useMLAB=useMLAB, plotit=plotit,
                 verbose=False, detrend_style=1, onesided=True)
    ft.fftpwelch()
    if nargout > 0:
        return ft


def create_turb_spectra(addwhitenoise=False, plotit=False, rng=None):
    """Gaussian correlation function -> model turbulence spectrum (:3051).

    Returns ``(lags, Rxy, freq, Pxy)``.
    """
    val = 0.005
    sigma = 1.0 / 500e3
    mu = 0.0
    kfact = 5.0 / 3.0
    Fs = 1e6
    nfft = 2 ** 14
    lags = (np.arange(nfft) - nfft // 2).astype(float) / Fs

    Rxy = np.exp(-kfact * (lags - mu) ** 2.0 / (2 * sigma * sigma))
    Rxy = val * Rxy / np.nanmax(Rxy)

    fft_pwelch(lags, Rxy, Rxy, plotit=plotit, verbose=False)

    freq = np.fft.fftshift(np.fft.fftfreq(nfft, d=1.0 / Fs))
    Pxy = np.fft.fftshift(np.fft.fft(Rxy, n=nfft))
    if addwhitenoise:
        rng = rng or np.random.default_rng()
        Pxy = Pxy + 0.25 * np.nanmax(Pxy) * rng.uniform(-1.0, 1.0, Pxy.shape)

    if plotit:  # pragma: no cover - visual path
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(2, 1)
        ax1.plot(1e6 * lags, Rxy, "-")
        ax1.set_xlabel("lags [us]")
        ax1.set_ylabel("Rxy")
        ax2.plot(1e-3 * freq, np.abs(Pxy), "-")
        ax2.set_xlabel("freq [KHz]")
        ax2.set_ylabel("Pxy")
    return lags, Rxy, freq, Pxy


def testFFTanal(plotit=False, verbose=False):
    """Dual-implementation cross-validation (reference ``__testFFTanal__``,
    :2817-2881): the device pipeline vs the independent NumPy/mlab oracle
    on the same signals.  Returns ``(homebrew, oracle)`` result tuples."""
    tvec, sigx, sigy = _pwelch_testsigs()
    kw = dict(Navr=8, windowfunction="hamming", detrend_style=1,
              plotit=plotit, verbose=verbose)
    home = fft_pwelch(tvec, sigx, sigy, [tvec[0], tvec[-1]], useMLAB=False,
                      **kw)
    orac = fft_pwelch(tvec, sigx, sigy, [tvec[0], tvec[-1]], useMLAB=True,
                      **kw)
    return home, orac


def test(plotit=False):
    """Reference ``test()`` (:3101): run the cross-validation pair."""
    return testFFTanal(plotit=plotit)


def test_fft_deriv(modified=True, plotit=False):
    """The 5 analytic spectral-derivative cases (reference :1591-1656):
    box, Gaussian, line, aperiodic sine, periodic sine.  Returns a dict of
    ``case -> (x, y, dy_analytic, dy_fft)`` for assertion/inspection."""
    from .deriv import fft_deriv
    from .utils.interp import rect, delta

    out = {}
    N, L = int(2e3), 13.0
    dx = L / N
    for ii in range(5):
        xx = dx * np.arange(N)
        if ii == 0:
            yy = rect(2.0 * xx / L - 0.75)
            dy = (delta(2.0 * xx / L - 0.75 + 0.5)
                  - delta(2.0 * xx / L - 0.75 - 0.5))
            name = "box"
        elif ii == 1:
            yy = np.exp(-0.5 * (xx / L) ** 2 / 0.25 ** 2)
            dy = (-(xx / L) * (1.0 / L) / 0.25 ** 2) * yy
            name = "gaussian"
        elif ii == 2:
            yy = np.linspace(-1.2, 11.3, num=len(xx), endpoint=True)
            dy = ((yy[-1] - yy[0]) / (xx[-1] - xx[0])) * np.ones_like(yy)
            name = "line"
        elif ii == 3:
            yy = np.sin(xx)
            dy = np.cos(xx)
            name = "sine_aperiodic"
        else:
            xx = 6.0 * np.pi * xx / L
            yy = np.sin(xx)[:-1]
            dy = np.cos(xx)[:-1]
            xx = xx[:-1]
            name = "sine_periodic"
        dydt, xo = fft_deriv(yy, xx, modified=modified)
        out[name] = (xx, yy, dy, np.asarray(dydt))
        if plotit:  # pragma: no cover
            import matplotlib.pyplot as plt
            plt.figure(f"fft_deriv {name}")
            plt.plot(xx, yy, "-", label="function")
            plt.plot(xx, dy, "-", label="analytical der")
            plt.plot(np.asarray(xo), np.asarray(dydt), "*", label="fft der")
            plt.legend(loc="lower left")
    return out


if __name__ == "__main__":  # pragma: no cover - manual smoke entry
    print("test_fftpwelch ...")
    test_fftpwelch()
    print("test_fftanal ...")
    test_fftanal(N=2 ** 15, seed=0)
    print("create_turb_spectra ...")
    create_turb_spectra()
    print("testFFTanal (homebrew vs oracle) ...")
    testFFTanal()
    print("test_fft_deriv ...")
    test_fft_deriv()
    print("all examples ran")
