"""Heat-pulse propagation analysis (W7-X ECRH modulation transport).

Counterpart of :mod:`pyfft_tpu.heatpulse` (the reference's
``HeatPulse_Funcs.py``, component #13): the reference's per-channel loop
over ``fft_pwelch`` (``HeatPulse_Funcs.py:576-583``, ``_PWELCH_ch``
:532-574) is ONE batched :func:`pyfft_tpu_torch.fft_pwelch` call over all
ECE channels, and the per-harmonic spectral integration is vectorized
across channels (one :func:`pyfft_tpu_torch.integrate.integratespectra`
call per harmonic).

Device: the spectra are computed on ``device`` when the merged settings
carry one (``device="cpu"`` for the tests), else by ``fft_pwelch``'s rule
(the package default, else the card).  A segment is a whole number of
modulation periods, ``nwins = floor(intno2per * 2/fmod * Fs)``, which is
almost never a power of two, so ``run(fft_backend='pallas')`` takes kernel
E (:mod:`pyfft_tpu_torch.ops.welch_v1`) wherever the JAX package takes TPU
kernel #7, and kernel B for a radix-2 geometry (``spectral.pallas_route``).

Reference parity map (file:line):

- HDF5 persistence: ``save_hdf5``/``load_hdf5`` <- the private
  ``IO.saveHDF5/loadHDF5`` recursive writers (:33-70, :264-296)
- :func:`load_data` / :func:`loadFFTdata` / :func:`loadHPdata` (:33-70)
- :class:`HeatPulseBase` <- ``__HeatPulse_base__`` (:83-317): channel
  sorting by ECE frequency/radius (:97-138), channel masking (:140-169),
  result saving (:264-296), plotting adapters (:206-256)
- :class:`HeatPulseFFT` <- ``__HeatPulse_FFTbase__`` (:322-674):
  settings (:370-385), preallocation (:387-410), harmonic-bin selection
  with peak refinement (:412-442), per-harmonic spectral integration with
  uncertainty propagation (:461-530), the Welch stage (:532-583) and the
  post-processing chain — linear coherence (:587-588), White-2010 phase
  variance (:594), homebrew phase sign flip (:597-599), 2-pi re-wrap
  (:625-641), White-thesis amplitude variance (:650), RMS/duty-cycle/
  logarithmic conversions (:652-670).

The compute path needs no h5py/matplotlib; both are imported lazily and
only by the IO/plot helpers.  In a ``torch.profiler`` trace the batched
Welch call is the range ``heatpulse.fft_pwelch`` (with ``fft_pwelch``'s
own ranges inside it).
"""
from __future__ import annotations

import os

import numpy as np

from .utils.structure import Struct
from .utils.profiling import stage
from . import spectral as _spectral
from .integrate import integratespectra

__all__ = [
    "save_hdf5", "load_hdf5", "load_data", "loadFFTdata", "loadHPdata",
    "HeatPulseBase", "HeatPulseFFT", "synth_heatpulse_data",
    "fit_neprofile",
]


# ---------------------------------------------------------------------------
# HDF5 persistence (role of the reference's private IO.saveHDF5/loadHDF5)
# ---------------------------------------------------------------------------

def _require_h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover - h5py is in the image
        raise ImportError("h5py is required for heat-pulse HDF5 IO") from e
    return h5py


def _save_group(grp, d):
    """Recursively write a nested dict of arrays/scalars/strings to HDF5
    (role of ``__recursively_save_dict_contents_to_group__``,
    HeatPulse_Funcs.py:288-289)."""
    for key, val in d.items():
        key = str(key)
        if isinstance(val, Struct):
            val = val.dict_from_class()
        if isinstance(val, dict):
            sub = grp.require_group(key)
            _save_group(sub, val)
        elif val is None:
            continue
        else:
            arr = np.asarray(val)
            if arr.dtype.kind in "US":
                arr = arr.astype("S")
            if key in grp:
                del grp[key]
            grp.create_dataset(key, data=arr)


def _load_group(grp):
    import h5py
    out = {}
    for key, val in grp.items():
        if isinstance(val, h5py.Group):
            out[key] = _load_group(val)
        else:
            arr = val[()]
            if isinstance(arr, bytes):
                arr = arr.decode()
            elif isinstance(arr, np.ndarray) and arr.dtype.kind == "S":
                arr = arr.astype(str)
            out[key] = arr
    return out


def save_hdf5(filename, h5dict, mode="a"):
    """Append a nested dict to an HDF5 file (reference save_dat :281-296)."""
    h5py = _require_h5py()
    with h5py.File(filename, mode) as f:
        _save_group(f, h5dict)
    return filename


def load_hdf5(filename, group=None):
    """Load an HDF5 file (or one group) back into a nested dict."""
    h5py = _require_h5py()
    with h5py.File(filename, "r") as f:
        src = f[group] if group else f
        return _load_group(src)


def load_data(filename):
    """Reference ``load_data`` (:33-37): pull the known diagnostic groups."""
    all_data = load_hdf5(filename)
    flds = ["COIL", "QME", "QMJ", "QTB", "XPLOG", "QMEZ", "ECRH"]
    return tuple(all_data[f] for f in flds if f in all_data)


def loadFFTdata(filename):
    """Reference ``loadFFTdata`` (:39-62): the FFTResults group."""
    tmp = load_hdf5(filename, "FFTResults")
    keys = ["nch", "usech", "chnum", "ece_roa", "ece_freq", "ece_bw",
            "tau", "uth", "Amp", "varA", "Phase", "varP", "Coh", "varC",
            "Txy", "Vxy", "Tnn"]
    out = {k: tmp[k] for k in keys if k in tmp}
    out["fmods"] = np.atleast_1d(tmp["fmods"])
    return out


def loadHPdata(filename):
    """Reference ``loadHPdata`` (:65-70)."""
    HPdata = load_hdf5(filename)
    flds = ["Results", "Inputs", "DataIn"]
    return tuple(HPdata[f] for f in flds if f in HPdata)


# ---------------------------------------------------------------------------
# Base class: sorting / filtering / persistence / plots
# ---------------------------------------------------------------------------

class HeatPulseBase(Struct):
    """Channel bookkeeping + IO (reference ``__HeatPulse_base__`` :83-317)."""

    clrs = "bgrcmyk"

    def __init__(self, d=None):
        if d is not None:
            super().__init__(d)
        if getattr(self, "verbose", False):
            print("Initialized a heat pulse base class")

    # -- channel ordering (reference :97-138) --------------------------------

    def _sortECEdat_(self, sortby="RF"):
        """Sort order by ECE resonance frequency / |r/a| / r_eff."""
        nch = int(self.nch)
        if sortby.lower() == "rf":
            return np.argsort(np.reshape(self.ece_freq, (nch,), order="C"))
        if "abs" in sortby.lower():
            return np.argsort(
                np.abs(np.reshape(self.ece_roa, (nch,), order="C")))
        if sortby.lower() in ("roa", "r/a", "reff"):
            return np.argsort(np.reshape(self.ece_roa, (nch,), order="C"))
        raise ValueError(f"unknown sortby={sortby!r}")

    def __sortECEdat__(self, _isort):
        self.ece_freq = np.asarray(self.ece_freq)[_isort]
        self.ece_bw = np.asarray(self.ece_bw)[_isort]
        if getattr(self, "isroa", False):
            self.ece_roa = np.asarray(self.ece_roa)[_isort]
        for opt in ("tau", "uth"):
            if hasattr(self, opt):
                setattr(self, opt, np.asarray(getattr(self, opt))[_isort])
        for fld in ("Tnn", "Txy", "Vxy", "Amp", "varA", "Coh", "varC",
                    "Phase", "varP"):
            setattr(self, fld, np.asarray(getattr(self, fld))[_isort, :])
        self.usech = np.asarray(self.usech)[_isort]
        self.chnum = np.asarray(self.chnum)[_isort]

    def __chfilter__(self):
        """Masked copy of per-channel results (reference :140-169)."""
        info = Struct()
        use = np.asarray(self.usech, dtype=bool)
        info.ece_freq = np.asarray(self.ece_freq)[use]
        info.ece_bw = np.asarray(self.ece_bw)[use]
        if getattr(self, "isroa", False):
            info.ece_roa = np.asarray(self.ece_roa)[use]
        for opt in ("tau", "uth"):
            if hasattr(self, opt):
                setattr(info, opt, np.asarray(getattr(self, opt))[use])
        for fld in ("Tnn", "Txy", "Vxy", "Amp", "varA", "Coh", "varC",
                    "Phase", "varP"):
            setattr(info, fld, np.asarray(getattr(self, fld))[use, :])
        info.usech = use[use]
        info.chnum = np.asarray(self.chnum)[use]
        info.nch = len(info.ece_freq)
        return info

    # -- persistence (reference :195-201, :264-296) --------------------------

    def load_data(self, filename):
        Results, Inputs, DataIn = loadHPdata(filename)
        self.__dict__.update(Inputs)
        self.__dict__.update(DataIn)
        self.__dict__.update(Results)

    def save_dat(self, Inputs=None, DataIn=None, FFTResults=None,
                 HPResults=None):
        h5dict = {}
        for name, obj in (("Inputs", Inputs), ("DataIn", DataIn),
                          ("FFTResults", FFTResults),
                          ("HPResults", HPResults)):
            if obj is None:
                continue
            if not isinstance(obj, dict):
                obj = obj.dict_from_class()
            h5dict[name] = obj
        os.makedirs(self.savedir, exist_ok=True)
        sfilename = os.path.join(self.savedir, self.sfilename + ".hdf5")
        return save_hdf5(sfilename, h5dict, mode="a")

    # -- plotting adapters (reference :206-256); lazy matplotlib -------------

    def plottime(self):
        import matplotlib.pyplot as plt
        hfig = plt.figure()
        plt.plot(self.tt, self.Trad, "-")
        plt.title("ECE Signal")
        plt.xlabel("t[s]")
        plt.ylabel("T_rad [KeV]")
        plt.axvline(x=self.tbounds[0], color="k")
        plt.axvline(x=self.tbounds[1], color="k")
        return hfig

    def plotPxyf(self, ch):
        import matplotlib.pyplot as plt
        hfig = plt.figure()
        for P, c in ((self.Pxx, "b-"), (self.Pyy[:, ch], "r-"),
                     (self.Pxy[:, ch], "k-")):
            plt.plot(1e-3 * self.freq, 10 * np.log10(np.abs(P)), c)
        plt.title("Power Spectra")
        plt.ylabel("P_ij [dB/Hz]")
        plt.xlabel("f[kHz]")
        return hfig

    def plotphxyf(self, ch=0):
        import matplotlib.pyplot as plt
        hfig = plt.figure()
        plt.plot(1e-3 * self.freq, np.angle(self.Pxy[:, ch]), "k-")
        plt.title("Cross-Phase")
        plt.xlabel("f[kHz]")
        return hfig

    def plotCxyf(self, ch=0):
        import matplotlib.pyplot as plt
        hfig = plt.figure()
        plt.plot(1e-3 * self.freq, np.abs(self.Cxyf[:, ch]), "k-")
        plt.axhline(y=1.0 / np.sqrt(self.Navr), color="k")
        plt.title("Cross-Coherence")
        plt.xlabel("f[kHz]")
        return hfig

    def save_fig(self, hfig=None, hNAME=None):  # pragma: no cover
        """PNG-save a figure into ``savedir`` (reference ``save_fig``,
        HeatPulse_Funcs.py:298-316, without the private plt_utils dep)."""
        import matplotlib.pyplot as plt
        if hfig is None:
            hfig = plt.gcf()
        if hNAME is None:
            hNAME = str(hfig.number)
        sfilename = os.path.join(self.savedir, str(hNAME))
        try:
            os.makedirs(self.savedir, exist_ok=True)
            hfig.savefig(sfilename + ".png", dpi=100, transparent=True)
            if getattr(self, "closefig", False):
                plt.close(hfig)
        except Exception:
            print("failed to save the figure ... ")
        return sfilename


# ---------------------------------------------------------------------------
# FFT analysis
# ---------------------------------------------------------------------------

class HeatPulseFFT(HeatPulseBase):
    """Modulation-harmonic transport analysis over all ECE channels.

    Construct with two dicts (or Structs): ``runinfo`` — analysis settings
    (``fmod``, ``harms``, ``intno2per``, ``overlap``, ``winfun``, ``fwid``,
    ``tbounds``, ``DutyCycle``, ``usesegs``, ``igch``, ``plotit``,
    ``verbose`` …) — and ``HPdata`` — the measurements (``tt``, ``Fs``,
    ``refsig``, ``sig`` (nt, nch), ``nch``, ``ece_freq``, ``ece_bw``,
    optional ``ece_roa``/``tau``/``uth``).  Then ``run()``.

    ``device`` may be among the settings (``"cpu"``, ``"cuda"``); it
    reaches ``fft_pwelch``.

    Reference: ``__HeatPulse_FFTbase__`` (HeatPulse_Funcs.py:322-674).
    The channel loop is replaced by one batched device call.
    """

    def __init__(self, runinfo=None, HPdata=None, **kwargs):
        merged = {}
        for src in (runinfo, HPdata, kwargs):
            if src is None:
                continue
            if not isinstance(src, dict):
                src = src.dict_from_class()
            merged.update(src)
        merged.setdefault("usesegs", False)
        merged.setdefault("useMLAB", False)
        merged.setdefault("plotit", False)
        merged.setdefault("verbose", False)
        merged.setdefault("saveit", False)
        merged.setdefault("igch", None)
        merged.setdefault("DutyCycle", 1.0)
        merged.setdefault("winfun", "hanning")
        merged.setdefault("overlap", 0.5)
        merged.setdefault("intno2per", 1)
        merged.setdefault("harms", np.asarray([1]))
        super().__init__(merged)
        # accept reference-internal underscore names too
        if not hasattr(self, "sig") and hasattr(self, "_sig"):
            self.sig = self._sig
        if not hasattr(self, "refsig") and hasattr(self, "_refsig"):
            self.refsig = self._refsig

    # -- bookkeeping (reference :360-366) ------------------------------------

    def PreCheck(self):
        nch = int(self.nch)
        self.chnum = np.int64(np.linspace(1, nch, nch))
        self.usech = np.ones((nch,), dtype=bool)
        if self.igch is not None:
            self.usech[np.asarray(self.igch) - 1] = False

    # -- segmentation settings (reference :370-385) --------------------------

    def _PWELCH_settings_(self):
        tt = np.asarray(self.tt)
        tbounds = np.asarray(self.tbounds, dtype=float)
        self.ibounds = np.floor(1 + self.Fs * (tbounds - tt[0])).astype(int)
        self.nsig = len(tt[self.ibounds[0]:self.ibounds[1]])
        # integer number of modulation periods per segment
        self.nwins = int(np.floor(
            self.intno2per * (2.0 / self.fmod) * self.Fs))
        self.noverlap = int(np.ceil(self.overlap * self.nwins))
        self.Navr = np.int64(
            (self.nsig - self.noverlap) // (self.nwins - self.noverlap))

    def _PWELCH_preallocate(self):
        self.nharms = len(np.atleast_1d(self.harms))
        nch, nh = int(self.nch), self.nharms
        shape = (nch, nh, int(self.Navr)) if self.usesegs else (nch, nh)
        xshape = shape[1:]
        self.Txx = np.zeros(xshape, dtype=np.float64)
        self.Vxx = np.zeros_like(self.Txx)
        self.Amp = np.zeros(shape, dtype=np.float64)
        self.Txy = np.zeros(shape, dtype=np.complex128)
        self.Vxy = np.zeros_like(self.Txy)
        self.Tnn = np.zeros_like(self.Txy)
        self.varA = np.zeros_like(self.Amp)
        self.Coh = np.zeros_like(self.Amp)
        self.varC = np.zeros_like(self.Amp)
        self.Phase = np.zeros_like(self.Amp)
        self.varP = np.zeros_like(self.Amp)
        self._ifk = np.zeros(np.shape(np.atleast_1d(self.harms)),
                             dtype=np.int64)

    # -- harmonic bin selection (reference :412-442) -------------------------

    def _getharmindex_(self, fftinfo=None):
        freq = np.asarray(self.freq)
        self.nf = len(freq)
        _dT = self.nf / (freq[-1] - freq[0])
        self._ifw = int(1 + np.floor(_dT * (0.5 * self.fwid)))

        Pxx = None
        if fftinfo is not None:
            Pxx = np.abs(np.reshape(fftinfo.Pxx, (self.nf,), order="C"))

        for jj, kk in enumerate(np.atleast_1d(self.harms)):
            itemp = int(np.where(freq > kk * self.fmod)[0][0])
            if Pxx is None:
                self._ifk[jj] = itemp
            else:
                # refine to the spectral peak near the nominal harmonic bin
                _isl = np.arange(itemp - 2 * self._ifw,
                                 itemp + 2 * self._ifw, dtype=int)
                self._ifk[jj] = _isl[0] + int(np.argmax(Pxx[_isl]))
            if self.verbose:
                print("Using frequency %1.3f for harmonic %i: "
                      % (freq[self._ifk[jj]], kk))
        self.fmods = freq[self._ifk]

    # -- spectra capture (reference :444-458) --------------------------------

    def _HP_preallocate_(self, fftinfo):
        navr = int(self.Navr)
        if self.usesegs:
            # Pxx_seg arrives (navr, nf); store (nf, navr) per reference
            self.Pxx = np.real(np.reshape(
                fftinfo.Pxx_seg, (navr, self.nf), order="C")).T.copy()
            # single-segment spectra carry no ensemble variance (the
            # reference's usesegs branch reshapes the (nf,) varPxx into
            # (nf, Navr) — a latent crash, HeatPulse_Funcs.py:447)
            self.vPxx = np.zeros_like(self.Pxx)
            shape = (self.nf, int(self.nch), navr)
        else:
            self.Pxx = np.real(np.reshape(fftinfo.Pxx, (self.nf,),
                                          order="C")).copy()
            self.vPxx = np.real(np.reshape(fftinfo.varPxx, (self.nf,),
                                           order="C")).copy()
            shape = (self.nf, int(self.nch))
        self.Pxy = np.zeros(shape, dtype=np.complex128)
        self.vPxy = np.zeros_like(self.Pxy)
        self.Pnn = np.zeros_like(self.Pxy)
        self.Pyy = np.zeros_like(self.Pxy)
        self.vPyy = np.zeros_like(self.Pxy)

    # -- per-harmonic integration (reference :461-530), channel-vectorized ---

    def _integrate_harmonics(self, fftinfo):
        """All (channel, harmonic) integrals; one vectorized
        :func:`integratespectra` call per harmonic."""
        freq = np.asarray(self.freq)
        ENBW = fftinfo.ENBW
        for jj in range(self.nharms):
            i0, i1 = self._ifk[jj] - self._ifw, self._ifk[jj] + self._ifw
            frange = np.asarray([freq[i0], freq[i1]])
            _isl = np.arange(i0, i1, dtype=int)

            if self.usesegs:
                navr = int(self.Navr)
                for ii in range(int(self.nch)):
                    Pxy_s = fftinfo.Pxy_seg[ii].T     # (nf, navr)
                    Pyy_s = fftinfo.Pyy_seg[ii].T
                    Pxx_s = np.real(fftinfo.Pxx_seg).T
                    Txy, Txx, Amp, Coh, Phase, info = integratespectra(
                        freq, Pxy_s, Pxx_s, Pyy_s, frange)
                    self.Txy[ii, jj] = Txy
                    self.Amp[ii, jj] = np.real(Amp)
                    self.Coh[ii, jj] = np.real(Coh)
                    self.Phase[ii, jj] = np.real(Phase)
                    self.Vxy[ii, jj] = info.varPxy_i
                    self.varA[ii, jj] = np.real(info.varPyy_i)
                    self.varC[ii, jj] = np.real(info.varCxy_i)
                    self.varP[ii, jj] = np.real(info.varph_i)
                    self.Tnn[ii, jj] = 0.5 * ENBW * (
                        Pyy_s[_isl[0] - 1, :navr] + Pyy_s[_isl[-1] + 1, :navr])
                    if ii == 0:
                        self.Txx[jj] = np.real(Txx)
                        self.Vxx[jj] = np.real(info.varPxx_i)
            else:
                # (nf, nch) arrays -> every channel in one call
                Txy, Txx, Amp, Coh, Phase, info = integratespectra(
                    freq, self.Pxy, np.repeat(self.Pxx[:, None],
                                              int(self.nch), axis=1),
                    self.Pyy, frange, varPxy=self.vPxy, varPxx=np.repeat(
                        self.vPxx[:, None], int(self.nch), axis=1),
                    varPyy=self.vPyy)
                self.Txy[:, jj] = np.asarray(Txy).ravel()
                self.Vxy[:, jj] = np.asarray(info.varPxy_i).ravel()
                self.Amp[:, jj] = np.real(np.asarray(Amp).ravel())
                self.varA[:, jj] = np.real(
                    np.asarray(info.varPyy_i).ravel())
                self.Coh[:, jj] = np.real(np.asarray(Coh).ravel())
                self.varC[:, jj] = np.real(np.asarray(info.varCxy_i).ravel())
                self.Phase[:, jj] = np.real(np.asarray(Phase).ravel())
                self.varP[:, jj] = np.real(np.asarray(info.varph_i).ravel())
                # noise temperature: band-edge bins just outside the window
                Tnn = 0.5 * ENBW * (self.Pyy[_isl[0] - 1, :]
                                    + self.Pyy[_isl[-1] + 1, :])
                self.Tnn[:, jj] = Tnn
                self.Txx[jj] = np.real(np.asarray(Txx).ravel()[0])
                self.Vxx[jj] = np.real(np.asarray(info.varPxx_i).ravel()[0])

    # -- per-channel compatibility path (reference :461-574) -----------------

    def integrate_spectra(self, fftinfo, frange):
        """Integrate one channel's spectra over ``frange`` (reference
        ``integrate_spectra``, HeatPulse_Funcs.py:461-496).  Returns the
        10-tuple ``(Txy, Txx, Amp, Coh, Phase, Vxy, Vxx, varA, varC,
        varP)``; per-segment when ``usesegs``."""
        if self.usesegs:
            navr = int(self.Navr)
            # normalize to the reference's (navr, nf) segment layout: a
            # single-channel fftinfo may retain a leading unit channel axis
            Pxy_seg = np.reshape(np.asarray(fftinfo.Pxy_seg), (navr, -1))
            Pxx_seg = np.reshape(np.asarray(fftinfo.Pxx_seg), (navr, -1))
            Pyy_seg = np.reshape(np.asarray(fftinfo.Pyy_seg), (navr, -1))
            Pxy_i = np.zeros((navr, 1), dtype=np.complex128)
            varPxy_i = np.zeros_like(Pxy_i)
            Pxx_i = np.zeros((navr, 1), dtype=np.float64)
            varPxx_i = np.zeros_like(Pxx_i)
            Pyy_i = np.zeros_like(Pxx_i)
            varPyy_i = np.zeros_like(Pxx_i)
            Cxy_i = np.zeros_like(Pxx_i)
            varCxy_i = np.zeros_like(Pxx_i)
            ph_i = np.zeros_like(Pxx_i)
            varph_i = np.zeros_like(Pxx_i)
            for kk in range(navr):
                (pxy_k, pxx_k, pyy_k, cxy_k, ph_k,
                 info) = integratespectra(
                    fftinfo.freq, Pxy_seg[kk, :],
                    np.real(Pxx_seg[kk, :]),
                    np.real(Pyy_seg[kk, :]), frange)
                Pxy_i[kk] = pxy_k
                Pxx_i[kk] = np.real(pxx_k)
                Pyy_i[kk] = np.real(pyy_k)
                # integrated coherence is complex; the reference stores it
                # into a float64 slot, implicitly discarding the imaginary
                # part (HeatPulse_Funcs.py:470-476) — same semantics, but
                # with the cast explicit
                Cxy_i[kk] = np.real(cxy_k)
                ph_i[kk] = np.real(ph_k)
                varPxy_i[kk] = info.varPxy_i
                varPxx_i[kk] = np.real(info.varPxx_i)
                varPyy_i[kk] = np.real(info.varPyy_i)
                varCxy_i[kk] = np.real(info.varCxy_i)
                varph_i[kk] = np.real(info.varph_i)
        else:
            Pxy_i, Pxx_i, Pyy_i, Cxy_i, ph_i, info = integratespectra(
                fftinfo.freq, fftinfo.Pxy, fftinfo.Pxx, fftinfo.Pyy, frange,
                varPxy=fftinfo.varPxy, varPxx=fftinfo.varPxx,
                varPyy=fftinfo.varPyy)
            varPxy_i = info.varPxy_i
            varPxx_i = info.varPxx_i
            varPyy_i = info.varPyy_i
            varCxy_i = info.varCxy_i
            varph_i = info.varph_i
        return (Pxy_i, Pxx_i, Pyy_i, Cxy_i, ph_i,
                varPxy_i, varPxx_i, varPyy_i, varCxy_i, varph_i)

    def _integrate_spectra(self, ii, fftinfo):
        """Channel ``ii``'s per-harmonic integrals into the preallocated
        result arrays (reference ``_integrate_spectra``, :498-530)."""
        freq = np.asarray(self.freq)
        for jj in range(self.nharms):
            i0, i1 = self._ifk[jj] - self._ifw, self._ifk[jj] + self._ifw
            frange = np.asarray([freq[i0], freq[i1]])
            _isl = np.arange(i0, i1, dtype=int)
            (Txy, Txx, Amp, Coh, Phase,
             Vxy, Vxx, varA, varC, varP) = self.integrate_spectra(
                fftinfo, frange)
            if self.usesegs:
                navr = int(self.Navr)
                Pyy_seg = np.reshape(np.asarray(fftinfo.Pyy_seg),
                                     (navr, -1))
                Tnn = 0.5 * fftinfo.ENBW * np.real(
                    Pyy_seg[:navr, _isl[0] - 1]
                    + Pyy_seg[:navr, _isl[-1] + 1])
                self.Tnn[ii, jj] = Tnn
                self.Txy[ii, jj] = np.ravel(Txy)
                self.Vxy[ii, jj] = np.ravel(Vxy)
                self.Amp[ii, jj] = np.real(np.ravel(Amp))
                self.varA[ii, jj] = np.real(np.ravel(varA))
                self.Coh[ii, jj] = np.real(np.ravel(Coh))
                self.varC[ii, jj] = np.real(np.ravel(varC))
                self.Phase[ii, jj] = np.real(np.ravel(Phase))
                self.varP[ii, jj] = np.real(np.ravel(varP))
                if ii == 0:
                    self.Vxx[jj] = np.real(np.ravel(Vxx))
                    self.Txx[jj] = np.real(np.ravel(Txx))
            else:
                Tnn = 0.5 * fftinfo.ENBW * np.real(
                    fftinfo.Pyy[_isl[0] - 1] + fftinfo.Pyy[_isl[-1] + 1])
                self.Tnn[ii, jj] = complex(Tnn)
                self.Txy[ii, jj] = complex(np.ravel(Txy)[0])
                self.Vxy[ii, jj] = complex(np.ravel(Vxy)[0])
                self.Amp[ii, jj] = float(np.real(np.ravel(Amp)[0]))
                self.varA[ii, jj] = float(np.real(np.ravel(varA)[0]))
                self.Coh[ii, jj] = float(np.real(np.ravel(Coh)[0]))
                self.varC[ii, jj] = float(np.real(np.ravel(varC)[0]))
                self.Phase[ii, jj] = float(np.real(np.ravel(Phase)[0]))
                self.varP[ii, jj] = float(np.real(np.ravel(varP)[0]))
                if ii == 0:
                    self.Vxx[jj] = float(np.real(np.ravel(Vxx)[0]))
                    self.Txx[jj] = float(np.real(np.ravel(Txx)[0]))

    def _PWELCH_ch(self, ii, iref=0, plotAlias=None, fft_backend=None):
        """Single-channel Welch + integration (reference ``_PWELCH_ch``,
        :532-574).  The batched `_PWELCH_all` path is the production
        path; this per-channel form exists for API parity and for
        incremental/retriable channel work units."""
        if self.verbose:
            print("Working on channel %s" % (str(ii + 1).zfill(2),))
        sig = np.asarray(self.sig)
        [self.freq, _, _, _, _, _, fftinfo] = _spectral.fft_pwelch(
            np.asarray(self.tt), np.asarray(self.refsig), sig[:, ii],
            np.asarray(self.tbounds), Navr=int(self.Navr),
            windowoverlap=self.overlap, windowfunction=self.winfun,
            useMLAB=self.useMLAB, plotit=False, verbose=False,
            fft_backend=fft_backend, device=getattr(self, "device", None))
        if ii == 0:
            self._getharmindex_(fftinfo=fftinfo)
            self._HP_preallocate_(fftinfo)
        navr = int(self.Navr)
        if self.usesegs:
            self.Pxy[:, ii, :] = np.asarray(fftinfo.Pxy_seg).reshape(
                (navr, self.nf), order="C").T
            self.Pyy[:, ii, :] = np.asarray(fftinfo.Pyy_seg).reshape(
                (navr, self.nf), order="C").T
            self.vPxy[:, ii, :] = 0.0
            self.vPyy[:, ii, :] = 0.0
        else:
            self.Pxy[:, ii] = np.asarray(fftinfo.Pxy).reshape(
                (self.nf,), order="C")
            self.Pyy[:, ii] = np.asarray(fftinfo.Pyy).reshape(
                (self.nf,), order="C")
            self.vPxy[:, ii] = np.asarray(fftinfo.varPxy).reshape(
                (self.nf,), order="C")
            self.vPyy[:, ii] = np.asarray(fftinfo.varPyy).reshape(
                (self.nf,), order="C")
        self._integrate_spectra(ii, fftinfo)
        if self.plotit and not self.usesegs and plotAlias is not None:
            hfig, hSPEC = plotAlias(ii, fftinfo)  # pragma: no cover
            if self.saveit:
                self.closefig = ii != iref
                self.save_fig(hfig, hSPEC)
        return fftinfo

    # -- the batched Welch call (replaces the :576-583 channel loop) ---------

    def _PWELCH_all(self, fft_backend=None):
        """ONE batched `fft_pwelch` over all channels (the device batch
        axis)."""
        sig = np.asarray(self.sig)
        refsig = np.asarray(self.refsig)
        with stage("heatpulse.fft_pwelch"):
            [self.freq, Pxy, Pxx, Pyy, Cxy, phi, fftinfo] = \
                _spectral.fft_pwelch(
                    np.asarray(self.tt), refsig, sig,
                    np.asarray(self.tbounds), Navr=int(self.Navr),
                    windowoverlap=self.overlap, windowfunction=self.winfun,
                    useMLAB=self.useMLAB, plotit=False, verbose=False,
                    fft_backend=fft_backend,
                    device=getattr(self, "device", None))
        self._getharmindex_(fftinfo=fftinfo)
        self._HP_preallocate_(fftinfo)

        navr = int(self.Navr)
        if self.usesegs:
            for ii in range(int(self.nch)):
                self.Pxy[:, ii, :] = fftinfo.Pxy_seg[ii].T
                self.Pyy[:, ii, :] = fftinfo.Pyy_seg[ii].T
                # per-segment variances are not estimated (single sample)
                self.vPxy[:, ii, :] = 0.0
                self.vPyy[:, ii, :] = 0.0
        else:
            self.Pxy[:, :] = np.reshape(Pxy, (self.nf, int(self.nch)),
                                        order="C")
            self.Pyy[:, :] = np.reshape(Pyy, (self.nf, int(self.nch)),
                                        order="C")
            self.vPxy[:, :] = np.reshape(fftinfo.varPxy,
                                         (self.nf, int(self.nch)), order="C")
            self.vPyy[:, :] = np.reshape(fftinfo.varPyy,
                                         (self.nf, int(self.nch)), order="C")
        self._integrate_harmonics(fftinfo)
        return fftinfo

    def _PWELCH_chloop(self, iref=0, plotAlias=None, fft_backend=None):
        """Full analysis (reference :576-671): batched Welch + integration +
        the exact post-processing chain."""
        self._PWELCH_settings_()
        self._PWELCH_preallocate()
        self._PWELCH_all(fft_backend=fft_backend)

        # ---- mean-squared -> linear coherence (reference :587-588) ----
        self.Coh = np.sqrt(self.Coh)
        self.varC = ((1.0 - self.Coh ** 2.0)
                     / np.sqrt(2 * self.Navr)) ** 2.0

        # ---- phase variance, A.E. White PoP 17 056103 (2010) (:594) ----
        with np.errstate(divide="ignore", invalid="ignore"):
            self.varP = (np.sqrt(1.0 - self.Coh ** 2)
                         / np.sqrt(2.0 * self.Navr * self.Coh)) ** 2.0

        self.Phase = np.angle(self.Txy)
        if not self.useMLAB:
            # ECE lags the ECRH; homebrew cross-phase sign convention (:597)
            self.Phase *= -1

        # ---- re-wrap each harmonic's radial phase profile into
        #      (-2pi-0.3, 0.3] (reference :625-641) ----
        for jj in range(self.nharms):
            ph = self.Phase[:, jj].copy()
            while (ph > 0.3).any() or (ph < -2 * np.pi - 0.3).any():
                if (ph > 0.3).any():
                    ph[ph > 0.3] -= 2 * np.pi
                if (ph < -2 * np.pi - 0.3).any():
                    ph[ph < -2 * np.pi - 0.3] += 2 * np.pi
            self.Phase[:, jj] = ph

        # ---- amplitude variance, White-thesis estimate (:650) ----
        self.varA = self.Txx * self.Amp * (1.0 - self.Coh) / self.Navr

        # ---- RMS perturbation (:652-658) ----
        with np.errstate(divide="ignore", invalid="ignore"):
            self.varA = np.abs(0.25 * self.varA / self.Amp)
        self.Amp = np.sqrt(np.abs(self.Amp))
        self.Txx = np.sqrt(np.abs(self.Txx))
        self.Tnn = np.float64(np.sqrt(np.abs(self.Tnn)))
        self.RMSECHpower = self.Txx.copy()

        # ---- duty-cycle correction RMS -> amplitude (:660-665) ----
        self.varA = self.varA / self.DutyCycle
        self.Amp = self.Amp / np.sqrt(self.DutyCycle)
        self.Txx = self.Txx / np.sqrt(self.DutyCycle)
        self.Tnn = self.Tnn / np.sqrt(self.DutyCycle)
        self.ModECHpower = self.Txx.copy()

        # ---- logarithmic amplitude perturbation (:667-670) ----
        with np.errstate(divide="ignore", invalid="ignore"):
            self.varA = self.varA / self.Amp ** 2
            self.Amp = np.log(self.Amp)
            self.Tnn = np.log(self.Tnn)

    run = _PWELCH_chloop

    # -- result dict for HDF5 (reference ``_mkfftdict_`` :337-355) -----------

    def _mkfftdict_(self, RemExtraKeys=()):
        res = self.dict_from_class()
        keys2remove = ["saveit", "intno2per", "harms", "afont", "overlap",
                       "sfilename", "savedir", "winfun", "usesegs", "vmcfil",
                       "fmod", "xpname", "plotit", "igch", "verbose",
                       "DutyCycle", "tbounds", "fwid", "noverlap", "nsig",
                       "isroa", "nf", "_refsig", "refsig", "_sig", "sig",
                       "closefig", "nharms", "nwins", "useMLAB", "tt",
                       "ibounds", "device"]
        keys2remove.extend(RemExtraKeys)
        return {k: res[k] for k in set(res) - set(keys2remove)}


# ---------------------------------------------------------------------------
# Synthetic data (test/demo helper; no reference analogue — HeatPulse_Funcs
# has no runnable test because its data loaders are private)
# ---------------------------------------------------------------------------

def synth_heatpulse_data(nch=8, fmod=33.0, fs=16.0e3, T=4.0, duty=0.5,
                         tau_damp=0.15, tau_lag=2.0e-3, noise=0.02,
                         seed=0):
    """Synthetic ECRH-modulation dataset: a square-wave power reference and
    ``nch`` ECE channels whose modulation response is progressively damped
    (amplitude ~ exp(-k*tau_damp)) and delayed (phase lag ~ k*tau_lag) with
    radius — the diffusive heat-pulse signature HeatPulseFFT measures."""
    rng = np.random.default_rng(seed)
    nt = int(T * fs)
    tt = np.arange(nt) / fs
    ref = 0.5 * (1.0 + np.sign(np.sin(2 * np.pi * fmod * tt)
                               - np.cos(np.pi * duty)))
    sig = np.zeros((nt, nch))
    for k in range(nch):
        amp = np.exp(-k * tau_damp)
        lag = k * tau_lag
        # response built from the first harmonics of the square wave
        resp = np.zeros(nt)
        for h in (1, 2, 3):
            resp += (amp / h) * np.sin(
                2 * np.pi * h * fmod * (tt - lag))
        sig[:, k] = 1.0 + 0.3 * resp + noise * rng.standard_normal(nt)
    ece_freq = 140.0 + np.arange(nch)          # GHz, monotone with radius
    ece_roa = 0.1 + 0.08 * np.arange(nch)
    return dict(tt=tt, Fs=fs, refsig=ref, sig=sig, nch=nch,
                ece_freq=ece_freq, ece_bw=np.full(nch, 0.3),
                ece_roa=ece_roa, isroa=True)


def fit_neprofile(QTBdat, rvec, loggradient=True, plotit=False):
    """Thomson-scattering electron-density profile fit.

    Role of the reference ``fit_neprofile`` (HeatPulse_Funcs.py:72-76),
    which delegates to a *private, unshipped* ``FIT.fitting_dev``
    package and therefore cannot run standalone upstream.  This is a
    working equivalent: a variance-weighted polynomial fit of
    ``log(ne)`` against radius, evaluated on ``rvec``.

    Parameters: ``QTBdat`` is a dict with ``'roa'`` (radii), ``'ne'``
    (densities) and optional ``'varne'`` (variances); ``rvec`` is the
    evaluation grid.  Returns ``(logne, varlogne, dlnnedrho,
    vardlnnedrho)`` — the reference's return contract.
    """
    roa = np.asarray(QTBdat["roa"], dtype=float).ravel()
    ne = np.asarray(QTBdat["ne"], dtype=float).ravel()
    varne = np.asarray(QTBdat.get("varne", 0.1 * ne**2),
                       dtype=float).ravel()
    rvec = np.asarray(rvec, dtype=float).ravel()

    logne_dat = np.log(ne)
    varlog_dat = varne / np.maximum(ne, 1e-300) ** 2   # delta method
    w = 1.0 / np.sqrt(np.maximum(varlog_dat, 1e-12))
    # fit in u = r^2: transport profiles are even in r, so log(ne) is far
    # better approximated by a low-order polynomial in r^2 than in r
    deg = min(4, len(roa) - 1)
    u, uvec = roa**2, rvec**2
    coef, cov = np.polyfit(u, logne_dat, deg, w=w, cov="unscaled")

    V = np.vander(uvec, deg + 1)                       # basis on the grid
    logne = V @ coef
    varlogne = np.maximum(np.einsum("ij,jk,ik->i", V, cov, V), 0.0)

    dcoef = np.polyder(np.poly1d(coef)).coefficients
    Vd = np.vander(uvec, deg)                          # derivative basis
    D = np.zeros((deg, deg + 1))                       # d/du in coef space
    for i in range(deg):
        D[i, i] = deg - i
    drdu = 2.0 * rvec                                  # chain rule u = r^2
    dlnnedrho = drdu * (Vd @ dcoef)
    vardlnnedrho = np.maximum(
        drdu**2 * np.einsum("ij,jk,ik->i", Vd @ D, cov, Vd @ D), 0.0)
    if not loggradient:
        nevec = np.exp(logne)
        dlnnedrho = nevec * dlnnedrho                  # dn/dr = n dln/dr
        vardlnnedrho = nevec**2 * (vardlnnedrho + dlnnedrho**2
                                   * varlogne / np.maximum(nevec, 1e-300)**2)
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure()
        ax1 = plt.subplot(2, 1, 1)
        ax1.errorbar(roa, logne_dat, yerr=np.sqrt(varlog_dat), fmt="k.")
        ax1.plot(rvec, logne, "b-")
        ax1.set_ylabel("log(ne)")
        ax2 = plt.subplot(2, 1, 2, sharex=ax1)
        ax2.plot(rvec, dlnnedrho, "b-")
        ax2.set_ylabel("dln(ne)/drho" if loggradient else "dne/drho")
        ax2.set_xlabel("r/a")
        plt.draw()
    return logne, varlogne, dlnnedrho, vardlnnedrho


# Reference class names (HeatPulse_Funcs.py:83, :322) as importable aliases.
__HeatPulse_base__ = HeatPulseBase
__HeatPulse_FFTbase__ = HeatPulseFFT
