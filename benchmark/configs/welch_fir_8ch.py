"""``welch_fir_8ch``: the inputs, the plain reference, the control and the
comparison of the FIR + Welch cross-spectra chain (the sizes are in
``welch_fir_8ch.json`` beside this file).

The record: a reference x, a sine plus noise, and ``nch`` channels, x plus
their own noise, float32, made on the device from a ``torch.Generator``.
The reference filters every signal with the causal FIR in float64, removes
each filtered signal's mean, and sums the Hann-windowed segments' powers
and cross-powers in float64, then scales them one-sided as the upstream
``fft_pwelch`` does.  Nothing here imports the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import plain, work


def plan(cfg):
    """``(nwins, noverlap, hop, navr, nbins)`` of the configuration."""
    nwins = cfg["nwins"]
    noverlap = int(np.ceil(cfg["overlap"] * nwins))
    hop = nwins - noverlap
    navr = (cfg["nt"] - noverlap) // hop
    return nwins, noverlap, hop, navr, plain.nnyquist(nwins)


def taps(cfg) -> np.ndarray:
    """The band-pass FIR (SciPy's ``firwin``, Hamming window)."""
    from scipy.signal import firwin
    f = cfg["fir"]
    return firwin(f["ntaps"], f["band"], pass_zero=False)


def window(cfg) -> np.ndarray:
    """The periodic Hann window of ``nwins`` samples."""
    return np.hanning(cfg["nwins"] + 1)[:-1]


def make_record(cfg, gen: torch.Generator, device) -> dict:
    """One shot: ``x (nt,)`` and ``y (nch, nt)`` float32 on ``device``."""
    nt, nch = cfg["nt"], cfg["nch"]
    sig = cfg["signal"]
    t = torch.arange(nt, dtype=torch.float64, device=device) / cfg["fs"]
    x = torch.sin((2 * np.pi * sig["tone_hz"]) * t).to(torch.float32)
    del t
    x += sig["x_noise"] * torch.randn(nt, generator=gen, device=device)
    y = torch.randn((nch, nt), generator=gen, device=device)
    y *= sig["y_noise"]
    y += x
    return {"x": x, "y": y}


def samples(cfg) -> int:
    """Input samples of one call, every channel and the reference."""
    return cfg["nt"] * (1 + cfg["nch"])


def work_counts(cfg) -> dict:
    """``{'welch_core': (operations, bytes)}`` the call's work needs: the
    FIR of every signal (the fewer of the direct and overlap-save counts)
    and the Welch transforms, powers and sums; every float32 input byte
    read once and every float32 output written once."""
    nwins, _, _, navr, nbins = plan(cfg)
    nt, nch = cfg["nt"], cfg["nch"]
    flops = (work.fir_least_flops(nt, cfg["fir"]["ntaps"], 1 + nch)
             + work.welch_flops(navr, nwins, nch))
    nbytes = 4 * nt * (1 + nch) + 4 * nbins * (1 + 3 * nch)
    return {"welch_core": (flops, nbytes)}


def _spectra(cfg, record, device, dft):
    nwins, _, hop, navr, nbins = plan(cfg)
    win = window(cfg)
    h = taps(cfg)
    x = torch.as_tensor(record["x"], device=device)
    y = torch.as_tensor(record["y"], device=device)
    if dft == "fft64":
        sig = plain.fir64(torch.cat([x[None], y]).to(torch.float64), h)
        sig -= sig.mean(-1, keepdim=True)
    else:
        sig = plain.fir_tf32(torch.cat([x[None], y]).to(torch.float32), h)
        sig -= sig.double().mean(-1, keepdim=True).float()
    auto, cross = plain.welch_sums(sig, win, nwins=nwins, hop=hop,
                                   navr=navr, nbins=nbins, dft=dft)
    del sig
    s1, s2 = win.sum(), (win ** 2).sum()
    enbw = cfg["fs"] * s2 / s1 ** 2
    sc = plain.onesided_power_scale(nwins, nbins) / (s1 ** 2 * enbw * navr)
    auto = auto.cpu().numpy() * sc
    cross = cross.cpu().numpy() * sc
    return {"Pxx": auto[0], "Pyy": auto[1:].T.copy(), "Pxy": cross.T.copy()}


def reference(cfg, record, device) -> dict:
    """The spectra in float64: ``Pxx (nbins,)``, ``Pyy`` and ``Pxy
    (nbins, nch)``."""
    return _spectra(cfg, record, device, "fft64")


def control(cfg, record, device) -> dict:
    """The reference one precision down: the FIR and the DFT as products
    of TF32-rounded operands accumulated in float32, float32 between them,
    the sums in float64."""
    return _spectra(cfg, record, device, "tf32")


def compare(cfg, got, want) -> dict:
    """``spectra_err``: over Pxx and every channel's Pyy and Pxy, the worst
    max |got - want| / max |want| of one spectrum."""
    return {"spectra_err": max(plain.rel_err_by_column(got[k], want[k])
                               for k in ("Pxx", "Pyy", "Pxy"))}
