# Copied verbatim from pyfft_tpu/plotting.py (numpy + matplotlib; no JAX).
"""Matplotlib adapters (kept out of the compute path).

The reference interleaves ~600 LoC of plotting with its estimators
(``fft_analysis.py:652-788, 2209-2306, 2643-2810``).  Here all plotting is a
thin adapter over returned arrays: the jit-compiled kernels never touch
matplotlib, and these helpers accept plain arrays (device arrays are pulled
back with ``np.asarray``).
"""
from __future__ import annotations

import numpy as np

_AFONT = {"fontsize": 14}


def _plt():
    import matplotlib.pyplot as plt
    return plt


def plot_pwelch_summary(tvec, sigx, sigy, tbounds, freq, Pxx, Pyy, Pxy, Cxy2,
                        phi_xy, fftinfo, onesided=True, reflecting=False,
                        nwins=None, navr=None, **kwargs):
    """Two-figure summary: input signals; correlation/spectra/coherence/phase.

    Mirrors the reference's plot layout (``fft_analysis.py:652-788``).
    """
    plt = _plt()
    tvec = np.asarray(tvec)
    sigx = np.asarray(sigx)
    sigy = np.asarray(sigy)
    freq = np.asarray(freq)
    if reflecting and nwins is not None:
        sigx = sigx[(nwins - 1):-nwins + 1]
        sigy = sigy[(nwins - 1):-nwins + 1]
    tx = tvec[:len(sigx)]

    fig1 = plt.figure(kwargs["hfigSig"]) if "hfigSig" in kwargs else plt.figure()
    ax = kwargs.get("axSig", plt.subplot(1, 1, 1))
    if np.iscomplexobj(sigx):
        ax.plot(tx, sigx.real, "b-", tx, sigx.imag, "b--")
    else:
        ax.plot(tx, sigx, "b-")
    if np.iscomplexobj(sigy):
        ax.plot(tvec[:len(sigy)], np.real(sigy), "r-")
        ax.plot(tvec[:len(sigy)], np.imag(sigy), "r--")
    else:
        ax.plot(tvec[:len(sigy)], sigy, "r-")
    ax.set_title("Input Signals", **_AFONT)
    ax.set_xlabel("t[s]", **_AFONT)
    ax.set_ylabel("sig_x,sig_y[V]", **_AFONT)
    if tbounds is not None:
        ax.axvline(x=tbounds[0], color="k")
        ax.axvline(x=tbounds[1], color="k")

    fig2 = plt.figure(kwargs["hfigSpec"]) if "hfigSpec" in kwargs else plt.figure()
    axs = kwargs.get("axSpec", None)
    ax1 = axs[0] if axs is not None else plt.subplot(2, 2, 1)
    ax1.plot(1e3 * np.asarray(fftinfo.lags), np.asarray(fftinfo.corrcoef).real, "b-")
    ax1.set_ylabel(r"$\rho$", **_AFONT)
    ax1.set_xlabel("lags [ms]", **_AFONT)
    ax1.set_title("Cross-correlation")

    ax2 = axs[1] if axs is not None else plt.subplot(2, 2, 2)
    plot = ax2.loglog if onesided else ax2.semilogy
    plot(freq, np.abs(np.asarray(Pxx)), "b-")
    plot(freq, np.abs(np.asarray(Pyy)), "r-")
    plot(freq, np.abs(np.asarray(Pxy)), "k-")
    ax2.set_title("Power Spectra", **_AFONT)
    ax2.set_ylabel(r"P$_{ij}$ [dB/Hz]", **_AFONT)
    ax2.set_xlabel("f[Hz]", **_AFONT)

    ax3 = axs[2] if axs is not None else plt.subplot(2, 2, 3, sharex=ax2)
    ax3.plot(freq, np.abs(np.asarray(Cxy2)), "k-")
    if navr:
        ax3.axhline(y=1.0 / navr, color="k")
    ax3.set_title("Mean-Squared Coherence", **_AFONT)
    ax3.set_ylabel(r"$\gamma^2$", **_AFONT)
    ax3.set_xlabel("f[Hz]", **_AFONT)

    ax4 = axs[3] if axs is not None else plt.subplot(2, 2, 4, sharex=ax2)
    ax4.plot(freq, np.asarray(phi_xy), "k-")
    ax4.set_title("Cross-Phase", **_AFONT)
    ax4.set_ylabel(r"$\phi_{xy}$", **_AFONT)
    ax4.set_xlabel("f[Hz]", **_AFONT)

    plt.tight_layout()
    plt.draw()
    fftinfo.hfig1 = fig1
    fftinfo.hfig2 = fig2
    fftinfo.axSig = ax
    fftinfo.ax = [ax1, ax2, ax3, ax4]
    return fig1, fig2


def plot_spectrogram(tseg, freq, Pseg, logscale=False, ax=None, vbnds=None,
                     cmap=None, tbounds=None, titl=r"P$_{xy}$",
                     ylbl="freq [KHz]", xlbl="time [s]", fbounds=None):
    """Spectrogram heat-map (role of reference ``fftanal._plotspec``, :2643)."""
    plt = _plt()
    spec = np.abs(np.asarray(Pseg)).astype(float)
    tseg = np.asarray(tseg)
    freq = np.asarray(freq)
    if ax is None:
        plt.figure()
        ax = plt.gca()
    if vbnds is None:
        vbnds = [spec.min(), spec.max()]
    if cmap is None:
        cmap = "RdBu"
    if tbounds is None:
        tbounds = [tseg.min(), tseg.max()]
    if fbounds is None:
        fbounds = [freq.min(), freq.max()]
    ax.set_title(titl)
    ax.set_ylabel(ylbl)
    ax.set_xlabel(xlbl)
    if logscale:
        spec = 10.0 * np.log10(spec)
    tbin = tseg - 0.5 * (tseg[2] - tseg[1])
    fbin = 1e-3 * (freq - 0.5 * (freq[2] - freq[1]))
    m = ax.pcolormesh(tbin, fbin, spec.T, cmap=cmap, vmin=vbnds[0], vmax=vbnds[1])
    ax.set_xlim(tuple(tbounds))
    ax.set_ylim(tuple(np.asarray(fbounds) * 1e-3))
    plt.colorbar(m, ax=ax)
    plt.draw()
    return ax
