"""Spectral integration, uncertainty propagation, and peak extraction
(counterpart of :mod:`pyfft_tpu.integrate`).

Role of the reference's statistics toolbox (``fft_analysis.py``):

- :func:`integratespectra`  <- ``integratespectra``   (:835-937)
- :func:`varcoh`            <- ``varcoh``             (:1218-1262)
- :func:`monticoh`          <- ``monticoh``           (:1166-1215)
- :func:`varphi`            <- ``varphi``             (:1300-1329)
- :func:`montiphi`          <- ``montiphi``           (:1265-1297)
- :func:`mean_angle`        <- ``mean_angle``         (:1334-1376)
- :func:`unwrap_tol`        <- ``unwrap_tol``         (:1399-1409)
- :func:`getNpeaks`         <- ``getNpeaks``          (:940-1027)

All of this is O(nfreq) host-side math (float64 NumPy) operating on spectra
the device pipelines produce, as in the JAX package; the Monte-Carlo
estimators take an explicit NumPy generator.  Known reference defects completed sanely (documented inline):
missing-variance default used ``np.size_like`` (nonexistent) -> zeros;
``fweighted`` integrated over the channel axis -> frequency axis.
"""
from __future__ import annotations

import numpy as np

from .utils.structure import Struct
from .utils.interp import trapz_var, reshapech


__all__ = ["integratespectra", "varcoh", "monticoh", "varphi", "montiphi",
           "mean_angle", "unwrap_tol", "getNpeaks"]


def varcoh(Pxy, varPxy, Pxx, varPxx, Pyy, varPyy, meansquared=True):
    """Coherence with propagated variance (reference ``varcoh``, :1218).

    Requires ``varPxy`` formed by separating real and imaginary components
    (as :func:`integratespectra` produces).  ``meansquared=True`` returns the
    mean-squared coherence; otherwise the reference's complex-coherence
    branch is reproduced verbatim (including its ad-hoc variance
    transformation at :1253-1258).
    """
    Pxy = np.asarray(Pxy)
    ms = np.imag(Pxy)
    mc = np.real(Pxy)
    vs = np.imag(varPxy)
    vc = np.real(varPxy)

    with np.errstate(divide="ignore", invalid="ignore"):
        if meansquared:
            Coh = np.abs(Pxy * np.conj(Pxy)) / (np.abs(Pxx) * np.abs(Pyy))
            varCoh = Coh ** 2 * (vc * (2 * mc / (mc ** 2 + ms ** 2)) ** 2
                                 + vs * (2 * ms / (mc ** 2 + ms ** 2)) ** 2
                                 + varPxx * (1 / Pxx) ** 2
                                 + varPyy * (1 / Pyy) ** 2)
        else:
            Coh = Pxy / np.sqrt(np.abs(Pxx) * np.abs(Pyy))
            varCoh = Coh ** 2 * (vc * (2 * mc / (mc ** 2 + ms ** 2)) ** 2
                                 + vs * (2 * ms / (mc ** 2 + ms ** 2)) ** 2
                                 + varPxx * (1 / Pxx) ** 2
                                 + varPyy * (1 / Pyy) ** 2)
            varCoh = 0.25 * varCoh / Coh
            Coh = np.sqrt(Coh)
    return Coh, varCoh


def monticoh(Pxy, varPxy, Pxx, varPxx, Pyy, varPyy, nmonti=1000,
             meansquared=True, rng=None):
    """Monte-Carlo coherence uncertainty (reference ``monticoh``, :1166)."""
    if rng is None:
        rng = np.random.default_rng()
    nmonti = int(nmonti)

    sh = np.shape(Pxy)

    def col(v):
        v = np.atleast_2d(np.asarray(v))
        return v.T if v.shape[0] == 1 else v

    Pxy_s, Pxx_s, Pyy_s = col(Pxy), col(Pxx), col(Pyy)
    vxy, vxx, vyy = col(varPxy), col(varPxx), col(varPyy)

    g2 = np.zeros((nmonti,) + Pxy_s.shape, dtype=float)
    for ii in range(nmonti):
        P1 = Pxy_s + np.sqrt(vxy) * rng.standard_normal(Pxy_s.shape)
        P2 = Pxx_s + np.sqrt(np.abs(vxx)) * rng.standard_normal(Pxx_s.shape)
        P3 = Pyy_s + np.sqrt(np.abs(vyy)) * rng.standard_normal(Pyy_s.shape)
        g2[ii] = np.abs(P1 * np.conj(P1)) / (np.abs(P2) * np.abs(P3))
    varg2 = np.nanvar(g2, axis=0)
    g2m = np.nanmean(g2, axis=0)
    if meansquared:
        return g2m.reshape(sh), varg2.reshape(sh)
    return np.sqrt(g2m.reshape(sh)), np.sqrt(varg2.reshape(sh))


def varphi(Pxy_real, Pxy_imag, varPxy_real, varPxy_imag, angle_range=np.pi):
    """Cross-phase with propagated variance (reference ``varphi``, :1300)."""
    Pxy_real = np.asarray(Pxy_real)
    Pxy_imag = np.asarray(Pxy_imag)
    if angle_range > 0.5 * np.pi:
        ph = np.arctan2(Pxy_imag, Pxy_real)
    else:
        ph = np.arctan(Pxy_imag / Pxy_real)
    with np.errstate(divide="ignore", invalid="ignore"):
        _tangent = Pxy_imag / Pxy_real
        _vartang = (varPxy_imag + varPxy_real * _tangent ** 2) / (Pxy_real ** 2)
        varph = _vartang / (1 + _tangent ** 2) ** 2
    return ph, varph


def montiphi(Pxy, varPxy, nmonti=1000, angle_range=np.pi, rng=None):
    """Monte-Carlo phase uncertainty (reference ``montiphi``, :1265)."""
    if rng is None:
        rng = np.random.default_rng()
    nmonti = int(nmonti)
    sh = np.shape(Pxy)

    def col(v):
        v = np.atleast_2d(np.asarray(v))
        return v.T if v.shape[0] == 1 else v

    Pxy_s = col(Pxy)
    v_s = col(varPxy)
    ph = np.zeros((nmonti,) + Pxy_s.shape, dtype=float)
    for ii in range(nmonti):
        P = Pxy_s + np.sqrt(v_s) * rng.standard_normal(Pxy_s.shape)
        if angle_range > 0.5 * np.pi:
            ph[ii] = np.arctan2(np.imag(P), np.real(P))
        else:
            ph[ii] = np.arctan(np.imag(P) / np.real(P))
    return (np.nanmean(ph, axis=0).reshape(sh),
            np.nanvar(ph, axis=0).reshape(sh))


def mean_angle(phi, vphi=None, dim=0, angle_range=0.5 * np.pi, vsyst=None):
    """Average a phase angle in cartesian space with uncertainty propagation
    (reference ``mean_angle``, :1334)."""
    phi = np.asarray(phi)
    if vphi is None:
        vphi = np.zeros_like(phi)
    if vsyst is None:
        vsyst = np.zeros_like(phi)

    nphi = np.size(phi, dim)
    complex_phase = np.exp(1.0j * phi)
    complex_var = vphi * (np.abs(complex_phase)) ** 2
    complex_vsy = vsyst * (np.abs(complex_phase)) ** 2

    ca = np.real(complex_phase)
    sa = np.imag(complex_phase)

    mca = np.nanmean(ca, axis=dim)
    msa = np.nanmean(sa, axis=dim)
    vca = np.nanvar(ca, axis=dim) + np.nansum(complex_var, axis=dim) / nphi ** 2
    vsa = np.nanvar(sa, axis=dim) + np.nansum(complex_var, axis=dim) / nphi ** 2
    vca = vca + (np.nansum(np.sqrt(complex_vsy), axis=dim) / nphi) ** 2.0
    vsa = vsa + (np.nansum(np.sqrt(complex_vsy), axis=dim) / nphi) ** 2.0

    return varphi(Pxy_real=mca, Pxy_imag=msa, varPxy_real=vca,
                  varPxy_imag=vsa, angle_range=angle_range)


def unwrap_tol(data, scal=np.pi, atol=None, rtol=None, itol=None):
    """Tolerance-based phase unwrapping (reference ``unwrap_tol``, :1399)."""
    data = np.array(data, dtype=float)
    if atol is None and rtol is None:
        atol = 0.2
    if atol is None and rtol is not None:
        atol = rtol * scal
    if itol is None:
        itol = 1
    tt = np.arange(len(data))
    ti = tt[::itol]
    diffdata = np.diff(data[::itol]) / scal
    diffdata = np.sign(diffdata) * np.floor(np.abs(diffdata) + atol)
    data[1:] = data[1:] - np.interp(tt[1:], ti[1:],
                                    scal * np.cumsum(diffdata))
    return data


def integratespectra(freq, Pxy, Pxx, Pyy, frange, varPxy=None, varPxx=None,
                     varPyy=None):
    """Integrate spectra over ``frange`` with error propagation.

    Returns ``(Pxy_i, Pxx_i, Pyy_i, Cxy_i, ph_i, info)`` per the reference
    contract (``fft_analysis.py:835-937``): trapezoid integration with
    variance propagation (real and imaginary parts of the cross-power
    handled separately), coherence via :func:`varcoh` (``meansquared=0``),
    phase via :func:`varphi`, and the cross-power-weighted mean frequency.
    """
    freq = np.asarray(freq)
    # reference calls nonexistent np.size_like when variances are omitted
    # (:872-874); zero variances are the sane completion
    if varPyy is None:
        varPyy = np.zeros_like(np.asarray(Pyy))
    if varPxx is None:
        varPxx = np.zeros_like(np.asarray(Pxx))
    if varPxy is None:
        varPxy = np.zeros_like(np.asarray(Pxy))

    Pxy = np.asarray(reshapech(Pxy))
    varPxy = np.asarray(reshapech(varPxy))
    Pxx = np.asarray(reshapech(Pxx))
    varPxx = np.asarray(reshapech(varPxx))
    Pyy = np.asarray(reshapech(Pyy))
    varPyy = np.asarray(reshapech(varPyy))

    inds = np.where((freq >= frange[0]) * (freq <= frange[1]))[0]
    fi = freq[inds]

    Pxy_real, varPxy_real, _, _ = trapz_var(fi, np.real(Pxy[inds, :]), None,
                                            np.real(varPxy[inds, :]), dim=0)
    Pxy_imag, varPxy_imag, _, _ = trapz_var(fi, np.imag(Pxy[inds, :]), None,
                                            np.imag(varPxy[inds, :]), dim=0)
    Pxy_real = np.asarray(Pxy_real)
    Pxy_imag = np.asarray(Pxy_imag)
    varPxy_real = np.asarray(varPxy_real)
    varPxy_imag = np.asarray(varPxy_imag)

    Pxy_i = Pxy_real + 1j * Pxy_imag
    varPxy_i = varPxy_real + 1j * varPxy_imag

    Pxx_i, varPxx_i, _, _ = trapz_var(fi, Pxx[inds, :], None,
                                      varPxx[inds, :], dim=0)
    Pyy_i, varPyy_i, _, _ = trapz_var(fi, Pyy[inds, :], None,
                                      varPyy[inds, :], dim=0)
    Pxx_i = np.asarray(Pxx_i)
    Pyy_i = np.asarray(Pyy_i)
    varPxx_i = np.asarray(varPxx_i)
    varPyy_i = np.asarray(varPyy_i)

    meansquared = 0
    Cxy_i, varCxy_i = varcoh(Pxy_i, varPxy_i, Pxx_i, varPxx_i, Pyy_i,
                             varPyy_i, meansquared)

    angle_range = np.pi
    ph_i, varph_i = varphi(Pxy_real, Pxy_imag, varPxy_real, varPxy_imag,
                           angle_range)

    info = Struct()
    info.frange = np.asarray([frange[0], frange[1]])
    info.ifrange = inds
    info.Pxy_i = Pxy_i
    info.varPxy_i = varPxy_i
    info.Pxx_i = Pxx_i
    info.varPxx_i = varPxx_i
    info.Pyy_i = Pyy_i
    info.varPyy_i = varPyy_i
    info.angle_range = angle_range
    info.ph_i = ph_i
    info.varph_i = varph_i
    info.meansquared = meansquared
    info.Cxy_i = Cxy_i
    info.varCxy_i = varCxy_i

    # cross-power-weighted mean frequency (center of gravity); the reference
    # integrates along the channel axis by np.trapz default (:934-935) —
    # integrating along frequency (axis 0) is the sane completion
    absP = np.abs(Pxy[inds, :])
    fw = fi[:, None] * np.ones((1, Pxy.shape[1]))
    info.fweighted = (np.trapezoid(fw * absP, axis=0)
                      / np.trapezoid(absP, axis=0))
    return Pxy_i, Pxx_i, Pyy_i, Cxy_i, ph_i, info


def getNpeaks(Npeaks, tvec, sigx, sigy, **kwargs):
    """Extract the ``Npeaks`` strongest cross-power peaks.

    Runs :func:`pyfft_tpu_torch.spectral.fft_pwelch` and iteratively picks the
    maximum of the linear cross-amplitude spectrum, blanking an equivalent
    noise bandwidth around each pick (reference ``getNpeaks``, :940-1027).
    Returns a tuple of ``[amplitude, frequency, phase]`` triples.
    """
    from .spectral import fft_pwelch

    kwargs.setdefault("tbounds", None)
    kwargs.setdefault("Navr", None)
    kwargs.setdefault("windowoverlap", None)
    kwargs.setdefault("windowfunction", None)
    kwargs.setdefault("useMLAB", None)
    kwargs.setdefault("plotit", None)
    kwargs.setdefault("verbose", None)
    kwargs.setdefault("detrend_style", None)
    kwargs.setdefault("onesided", True)
    fmin = kwargs.pop("fmin", None)
    fmax = kwargs.pop("fmax", None)
    minsep = kwargs.pop("minsep", 6)
    freq, Pxy, Pxx, Pyy, Cxy, phi_xy, fftinfo = fft_pwelch(tvec, sigx, sigy,
                                                           **kwargs)
    freq = np.asarray(freq)
    Lxx = np.asarray(fftinfo.Lxx)
    Lyy = np.asarray(fftinfo.Lyy)
    Lxy = np.asarray(fftinfo.Lxy)
    phi_xy = np.asarray(phi_xy)

    nfreq = len(freq)
    ENBW = max(fftinfo.ENBW, minsep)
    iff = np.ones((nfreq,), dtype=bool)
    irem = int(2 * nfreq * ENBW / (freq[-1] - freq[0]))

    fmin = 0.0 if fmin is None else fmin
    fmax = freq[-1] if fmax is None else fmax
    iff[(freq <= fmin) * (freq >= fmax)] = False
    freq = freq[iff]
    nfreq = len(freq)
    Lxx = Lxx[iff]
    Lyy = Lyy[iff]
    Lxy = Lxy[iff]
    phi_xy = phi_xy[iff]
    iff = iff[iff]

    out = []
    for _ in range(int(Npeaks)):
        imax = int(np.argmax(Lxy))
        out.append([np.copy(Lyy[imax]), np.copy(freq[imax]),
                    np.copy(phi_xy[imax])])
        if (imax - irem // 2 >= 0) and (imax + irem // 2 < nfreq):
            iff[imax - irem // 2:imax + irem // 2] = False
        elif imax + irem // 2 < nfreq:
            iff[:imax + irem // 2] = False
        elif imax - irem // 2 >= 0:
            iff[-(imax + irem // 2):] = False
        freq = freq[iff]
        nfreq = len(freq)
        Lxx = Lxx[iff]
        Lyy = Lyy[iff]
        Lxy = Lxy[iff]
        phi_xy = phi_xy[iff]
        iff = iff[iff]
    return tuple(out)
