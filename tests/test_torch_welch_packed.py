"""Kernel H's module (pyfft_tpu_torch.ops.welch_packed) against the JAX
package, and the PYFFT_PACKED route.

On the CPU the port's entries run kernel H's plain version (kernel B's,
``welch_plain``); the JAX side runs its packed Pallas kernels in interpret
mode at precision 'highest'.  Geometries follow tests/test_pallas_welch.py
(the packed tests).  An emulation of the kernel's own arithmetic (two real
sequences per complex FFT, split by the partner bin ``(N - k) mod N``)
holds the packing against the plain version in float64.  The kernel itself
runs only on a CUDA card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from pyfft_tpu import spectral as jsp
from pyfft_tpu import segmentation as jseg
from pyfft_tpu.filters import firwin
from pyfft_tpu.ops import pallas_welch3 as jw3

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import segmentation as pseg
from pyfft_tpu_torch import spectral as psp
from pyfft_tpu_torch.ops import welch as pw
from pyfft_tpu_torch.ops import welch_packed as pwp
from pyfft_tpu_torch.ops.fir import fir_plain
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _taps(ntaps):
    if not ntaps:
        return None
    t = np.hanning(ntaps)
    return t / t.sum()


def _close(got, ref, tol):
    """max |got - ref| <= tol * max |ref|, per output."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("nwins,nov,nt,ntaps,det", [
    (512, 256, 1 << 15, 0, 1),
    (512, 256, 1 << 15, 33, 1),
    (1024, 512, 1 << 16, 0, 0),
    (512, 384, 40960, 0, 1),
    (256, 128, 9 * 128 * 30 + 128, 65, 1),
])
def test_auto_packed_matches_jax(nwins, nov, nt, ntaps, det):
    """welch_auto_packed, float32 on both sides: 2e-5 of max."""
    rng = np.random.default_rng(7)
    navr = (nt - nov) // (nwins - nov)
    x = rng.standard_normal(nt).astype(np.float32) + 0.2
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, noverlap=nov, taps=_taps(ntaps),
              detrend_style=det)
    J = jw3.welch_auto_packed(x, win, nwins // 2 + 1, 0.5,
                              precision="highest", interpret=True, **kw)
    P = pwp.welch_auto_packed(torch.from_numpy(x), win, nwins // 2 + 1, 0.5,
                              **kw)
    assert P.dtype == torch.float32 and P.shape == (nwins // 2 + 1,)
    _close(P.numpy(), J, 2e-5)


@pytest.mark.parametrize("nwins,nov,nt,ntaps,det", [
    (512, 256, 1 << 15, 0, 1),
    (512, 256, 1 << 15, 33, 1),
    (1024, 512, 1 << 16, 0, 0),
    (256, 128, 9 * 128 * 30 + 128, 65, 1),
])
def test_pair_packed_matches_jax(nwins, nov, nt, ntaps, det):
    """welch_pair_packed, float32 on both sides: 2e-5 of max per output."""
    rng = np.random.default_rng(3)
    navr = (nt - nov) // (nwins - nov)
    x = rng.standard_normal(nt).astype(np.float32)
    y = (0.5 * np.roll(x, 5) + rng.standard_normal(nt)).astype(np.float32)
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, noverlap=nov, taps=_taps(ntaps),
              detrend_style=det)
    J = jw3.welch_pair_packed(x, y, win, nwins // 2 + 1, 1.0 / navr,
                              precision="highest", interpret=True, **kw)
    P = pwp.welch_pair_packed(x, y, win, nwins // 2 + 1, 1.0 / navr, **kw)
    assert [tuple(p.shape) for p in P] == [(nwins // 2 + 1,)] + \
        [(1, nwins // 2 + 1)] * 3
    for p, j in zip(P, J):
        _close(p.numpy(), j, 2e-5)


def _emulate(x, y, win, nfreq, norm, *, navr, nwins, hop, taps, detrend):
    """Kernel H's arithmetic in float64: two real sequences per complex FFT
    (segments 2p and 2p+1 of x, or segment s of x and of y), bin j from Z_j
    and its partner Z_{(N-j) mod N} for j <= N/2, written in kernel B's
    (column, 3, bin) layout, then the mirror images past N/2
    (``welch._mirror``).  Returns the rows of ``Pxx`` [, ``Pyy``, ``Pxy_re``,
    ``Pxy_im``]."""
    sig = torch.stack([x] + ([] if y is None else [y]))
    if taps is not None:
        sig = fir_plain(sig, taps)
    if detrend:
        sig = sig - sig.mean(-1, keepdim=True)
    w = torch.as_tensor(win)
    fr = sig.unfold(-1, nwins, hop)[:, :navr] * w
    if y is None:
        a, b = fr[0, 0::2], fr[0, 1::2]
        b = torch.cat([b, torch.zeros(len(a) - len(b), nwins,
                                      dtype=b.dtype)])
        Z = torch.fft.fft(torch.complex(a, b))
    else:
        Z = torch.fft.fft(torch.complex(fr[0], fr[1]))
    j = torch.arange(nwins // 2 + 1)
    z, zp = Z[:, j], Z[:, (nwins - j) % nwins]
    if y is None:
        P = 0.5 * (z.abs() ** 2 + zp.abs() ** 2)
        cols = [[P, 0 * P, 0 * P]]
    else:
        X = (z + zp.conj()) / 2
        Y = (z - zp.conj()) / 2j
        C = Y * X.conj()
        cols = [[X.abs() ** 2, 0 * C.real, 0 * C.real],
                [Y.abs() ** 2, C.real, C.imag]]
    out = torch.stack([torch.stack([r.sum(0) for r in c]) for c in cols])
    out = pw._mirror(out[..., :min(nfreq, nwins // 2 + 1)] * norm, nwins,
                     nfreq)
    return torch.stack([out[0, 0]] + ([] if y is None else list(out[1])))


@pytest.mark.parametrize("pair,nwins,hop,nt,ntaps,amp,nfreq", [
    (False, 128, 64, 128 * 40, 0, 1.0, 65),       # navr 79 (odd)
    (False, 128, 128, 128 * 40, 33, 1.0, 128),    # navr 40 (even), all bins
    (False, 16384, 8192, 1 << 16, 0, 1.0, 8193),  # navr 7
    (False, 16384, 8192, (1 << 16) + 8192, 129, 1.0, 9000),  # navr 8
    (True, 128, 100, 9000, 0, 0.1, 65),           # |y| = |x| / 10
    (True, 16384, 8192, 1 << 16, 65, 0.1, 16384),
    (True, 128, 64, 128 * 40, 0, 1.0, 100),
])
def test_packing_arithmetic_matches_plain(pair, nwins, hop, nt, ntaps, amp,
                                          nfreq):
    """The packed arithmetic against the plain version, both float64:
    1e-12 of max per output (one FFT rounding apart).  The 1:10 amplitude
    pair holds too: in float64 the split loses nothing; in float32 on the
    card its Y error scales with |X| (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(nwins + nt)
    x = torch.as_tensor(rng.standard_normal(nt) + 0.4)
    y = torch.as_tensor(amp * (rng.standard_normal(nt) - 0.1))
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    taps = np.asarray(firwin(ntaps, 0.3)) if ntaps else None
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps)
    got = _emulate(x, y if pair else None, win, nfreq, 0.25, detrend=1,
                   **kw)
    ref = pw.welch_plain(x, y[None] if pair else x.new_empty((0, nt)), win,
                         nfreq, 0.25, detrend_style=1, **kw)
    assert got.shape == (4 if pair else 1, nfreq)
    refs = [ref[0]] + ([r[0] for r in ref[1:]] if pair else [])
    for g, r in zip(got, refs):
        _close(g.numpy(), r.numpy(), 1e-12)


def test_entries_match_plain_past_the_nyquist_bin():
    """nfreq up to nwins: the entries return the plain version's bins."""
    rng = np.random.default_rng(2)
    nt, nwins, nov = 1 << 14, 256, 128
    navr = (nt - nov) // (nwins - nov)
    x = torch.as_tensor(rng.standard_normal(nt), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal(nt), dtype=torch.float32)
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, noverlap=nov)
    got = pwp.welch_pair_packed(x, y, win, nwins, 1.0, **kw)
    ref = pw.welch_fir_pallas3(x, y[None], win, nwins, 1.0, **kw)
    for g, r in zip(got, ref):
        _close(g.numpy(), r.numpy(), 1e-6)
    # what the kernel's wrapper does past bin N/2: the mirror images
    full = torch.stack([torch.stack([ref[0], 0 * ref[0], 0 * ref[0]]),
                        torch.stack([ref[1][0], ref[2][0], ref[3][0]])])
    _close(pw._mirror(full[..., :nwins // 2 + 1], nwins, nwins).numpy(),
           full.numpy(), 1e-6)


def test_gates_match_jax():
    """The copies of _v3_geometry, packed_parts_geometry and
    packed_pair_geometry equal the JAX package's over a grid."""
    n = 0
    for nwins in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                  384):
        for frac in (0.0, 0.25, 0.5, 0.75, 0.875, 0.9375, 0.3):
            nov = int(nwins * frac)
            for nch in (0, 1, 7, 15, 16):
                assert pwp._v3_geometry(nwins, nov, nch) == \
                    jw3._v3_geometry(nwins, nov, nch)
            for navr in (1, 2, 3, 16, 17, 100, 8191):
                for parts in (2, 8, 16, 32):
                    assert pwp.packed_parts_geometry(navr, nwins, nov, parts) \
                        == jw3.packed_parts_geometry(navr, nwins, nov, parts)
                    assert pwp.packed_pair_geometry(navr, nwins, nov, parts) \
                        == jw3.packed_pair_geometry(navr, nwins, nov, parts)
                    n += pwp.packed_pair_geometry(navr, nwins, nov,
                                                  parts) is not None
    assert n > 50


def test_entries_raise_as_jax_does():
    x = np.zeros(4096, np.float32)
    win = np.hanning(512)
    with pytest.raises(ValueError, match="packing not applicable"):
        pwp.welch_auto_packed(x, win, 257, 1.0, navr=1, nwins=512,
                              noverlap=256)
    with pytest.raises(ValueError, match="pair packing not applicable"):
        pwp.welch_pair_packed(x, x, np.hanning(500), 251, 1.0, navr=8,
                              nwins=500, noverlap=250)
    with pytest.raises(ValueError, match="detrend mean/none"):
        pwp.welch_auto_packed(x, win, 257, 1.0, navr=14, nwins=512,
                              noverlap=256, detrend_style=-1)
    # the kernel wrapper never runs CPU tensors: it raises
    with pytest.raises(ValueError, match="CUDA"):
        pw.welch_cuda(torch.zeros(4096), torch.zeros((0, 4096)), win, 257,
                      1.0, navr=14, nwins=512, hop=256, packed=True)


def test_pyfft_packed_route_matches_jax(monkeypatch):
    """welch_cross_spectra('pallas') on one real channel with
    PYFFT_PACKED=1: route 'H' on both sides (the port's kernel core runs
    ``ops.welch._run`` packed, kernel H), float32 kernels: 5e-5 relative
    with a floor of 1e-9 (as tests/test_torch_spectral.py holds the pallas
    route)."""
    rng = np.random.default_rng(9)
    nt, fs = 1 << 15, 1e6
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 97e3 * t) + 0.3 * rng.standard_normal(nt)
    y = np.roll(x, 3) + 0.1 * rng.standard_normal(nt)
    plan_j = jseg.plan_segments(nt, nwins=1024, windowoverlap=0.5)
    plan_p = pseg.plan_segments(nt, nwins=1024, windowoverlap=0.5)
    win = np.hanning(1025)[:-1]
    calls = []
    real = pw._run

    def spy(*a, **k):
        if k.get("packed"):
            calls.append(k["navr"])
        return real(*a, **k)

    monkeypatch.setattr(pw, "_run", spy)
    monkeypatch.setenv("PYFFT_PACKED", "1")
    assert psp.pallas_route(nwins=1024, noverlap=512, navr=plan_p.navr,
                            nnyquist=513, onesided=True, detrend_style=1,
                            ntmodel=False, is_cplx=False, nch=1) == "H"
    J = jsp.welch_cross_spectra(x, y, win, plan_j, fs, fft_backend="pallas")
    P = pt.welch_cross_spectra(x, y, win, plan_p, fs, fft_backend="pallas")
    assert calls == [plan_p.navr]
    for k in ("freq", "Pxx", "Pyy", "Pxy"):
        np.testing.assert_allclose(np.asarray(P[k]), np.asarray(J[k]),
                                   rtol=5e-5, atol=1e-9, err_msg=k)
    # two channels, or the variable unset: route B as before
    assert psp.pallas_route(nwins=1024, noverlap=512, navr=plan_p.navr,
                            nnyquist=513, onesided=True, detrend_style=1,
                            ntmodel=False, is_cplx=False, nch=2) == "B"
    monkeypatch.delenv("PYFFT_PACKED")
    pt.welch_cross_spectra(x, y, win, plan_p, fs, fft_backend="pallas")
    assert len(calls) == 1


def test_packed_flop_model():
    """utils.profiling.welch_packed_flops: half the complex FFTs of one
    transform per segment (auto, odd navr rounds up), one per pair, and
    the card's bound at config 1 set by its 67 MB of input."""
    from pyfft_tpu_torch.utils import profiling as pprof
    fft = 5.0 * 4096 * 12
    assert pprof.welch_packed_flops(8191, 4096) == \
        8191 * 4096 + 4096 * fft + 4096 * 2049 * 6
    assert pprof.welch_packed_flops(8191, 4096, pair=True) == \
        2 * 8191 * 4096 + 8191 * fft + 8191 * 2049 * 16
    ms, by = pprof.bound_ms(pprof.welch_packed_flops(8191, 4096),
                            4.0 * ((1 << 24) + 2049),
                            kind="NVIDIA H100 80GB HBM3, 700.00 W")
    assert by == "bytes" and abs(ms - 0.02003) < 1e-4
