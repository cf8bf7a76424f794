"""Row 8 of the kernel table: the geometries where the JAX package runs its
v2 factored kernel (``pallas_welch.py::_factored_kernel``), on the port's
kernel B.

``welch_fir_pallas_fused`` takes TPU kernel #1 where its gate holds, else
the v2 kernel where ``_v2_geometry`` holds (e.g. nwins 2048 every 128
samples).  The port runs kernel B at every such geometry, with the
documented global-mean detrend.  On the CPU its plain version is held
against the float64 loop oracle of tests/test_pallas_welch.py, and against
JAX's v2 kernel (interpret mode, precision 'highest') without detrend.
Two faults of the JAX v2 kernel are pinned here, so that no parity test
makes them a contract (ROADMAP Queue 3): at detrend 1 it removes each
segment's own mean, and with taps it fails where a block has fewer rows
than a segment.
"""
import numpy as np
import pytest
import torch

from pyfft_tpu.filters import firwin
from pyfft_tpu.ops import pallas_welch as jpw
from pyfft_tpu.ops.pallas_welch3 import pallas_welch3_applicable

from pyfft_tpu_torch.ops import welch as pw
from pyfft_tpu_torch.config import default_device
from test_pallas_welch import _welch_oracle

NT = 3 << 14


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _inputs(nch, nwins, noverlap, ntaps, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(NT) + 0.4).astype(np.float32)
    y = (rng.standard_normal((nch, NT)) - 0.3).astype(np.float32)
    taps = (np.asarray(firwin(ntaps, [0.05, 0.45], pass_zero=False))
            if ntaps else None)
    hop = nwins - noverlap
    navr = (NT - nwins) // hop + 1
    # a v2-only geometry: TPU kernel #1's gate fails, the v2 gate holds
    assert not pallas_welch3_applicable(nwins, noverlap, navr, nch)
    assert jpw._v2_geometry(nwins, noverlap, navr, nch, taps) is not None
    return x, y, taps, np.hanning(nwins + 1)[:-1], hop, navr


def _per_segment_oracle(x, y, win, navr, nwins, hop, taps):
    """The JAX v2 kernel's detrend: each segment's own mean removed."""
    sig = np.concatenate([x[None], y]).astype(np.float64)
    if taps is not None:
        sig = np.stack([np.convolve(s, taps, "full")[:len(x)] for s in sig])
    Z = []
    for s in range(navr):
        seg = sig[:, s * hop:s * hop + nwins]
        Z.append(np.fft.fft((seg - seg.mean(-1, keepdims=True)) * win))
    Z = np.stack(Z, axis=1)                          # (C, navr, nwins)
    X, Y = Z[0], Z[1:]
    return ((np.abs(X) ** 2).sum(0), (np.abs(Y) ** 2).sum(1),
            (Y * X.conj()).sum(1))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("nch,nwins,noverlap,ntaps,detrend", [
    (2, 2048, 1920, 0, 1),
    (2, 2048, 1920, 129, 1),
    (1, 4096, 3584, 63, 1),
    (2, 4096, 3584, 0, 0),
])
def test_port_matches_global_mean_oracle(nch, nwins, noverlap, ntaps,
                                         detrend):
    """Kernel B's plain version in float32 against the float64 oracle with
    the global mean of the filtered span: 2e-5 of max per output."""
    x, y, taps, win, hop, navr = _inputs(nch, nwins, noverlap, ntaps, nwins)
    nf = nwins // 2 + 1
    P = pw.welch_fir_pallas_fused(torch.from_numpy(x), torch.from_numpy(y),
                                  win, nf, 1.0 / navr, navr=navr,
                                  nwins=nwins, noverlap=noverlap, taps=taps,
                                  detrend_style=detrend)
    Pxx, Pyy, Pxy = _welch_oracle(x.astype(np.float64), y.astype(np.float64),
                                  win, navr, nwins, hop, taps, detrend)
    assert _rel(P[0], Pxx[:nf] / navr) <= 2e-5
    assert _rel(P[1], Pyy[:, :nf] / navr) <= 2e-5
    assert _rel(P[2] + 1j * P[3], Pxy[:, :nf] / navr) <= 2e-5


@pytest.mark.parametrize("ntaps", [0, 129])
def test_port_matches_jax_v2_without_detrend(ntaps):
    """Where the JAX v2 kernel runs and detrends nothing, the two packages
    agree: 2e-5 of max per output, float32 on both sides."""
    x, y, taps, win, hop, navr = _inputs(2, 2048, 1920, ntaps, ntaps)
    kw = dict(navr=navr, nwins=2048, noverlap=1920, taps=taps,
              detrend_style=0)
    J = jpw.welch_fir_pallas_fused(x, y, win, 1025, 1.0, precision="highest",
                                   interpret=True, **kw)
    P = pw.welch_fir_pallas_fused(torch.from_numpy(x), torch.from_numpy(y),
                                  win, 1025, 1.0, **kw)
    for p, j in zip(P, J):
        assert _rel(p.numpy(), j) <= 2e-5


def test_jax_v2_removes_each_segments_mean():
    """The JAX v2 kernel's fault at detrend 1, pinned: it matches the
    per-segment-mean oracle and misses the documented global-mean one by
    far more than float32 rounding; the port keeps the global mean."""
    x, y, taps, win, hop, navr = _inputs(2, 2048, 1920, 0, 5)
    J = jpw.welch_fir_pallas_fused(x, y, win, 1025, 1.0, navr=navr,
                                   nwins=2048, noverlap=1920,
                                   detrend_style=1, precision="highest",
                                   interpret=True)
    seg = _per_segment_oracle(x, y, win, navr, 2048, hop, None)
    glob = _welch_oracle(x.astype(np.float64), y.astype(np.float64), win,
                         navr, 2048, hop, None, 1)
    assert _rel(J[0], seg[0][:1025]) <= 2e-5
    assert _rel(J[0], glob[0][:1025]) > 0.1
    P = pw.welch_fir_pallas_fused(torch.from_numpy(x), torch.from_numpy(y),
                                  win, 1025, 1.0, navr=navr, nwins=2048,
                                  noverlap=1920, detrend_style=1)
    assert _rel(P[0], glob[0][:1025]) <= 2e-5


def test_jax_v2_fails_where_blocks_are_shorter_than_segments():
    """The JAX v2 kernel's fault with taps, pinned: at nwins 4096 every 512
    samples a block has 16 rows and a segment 32, and the kernel's halo
    concatenation fails; the port computes the geometry (above)."""
    x, y, taps, win, hop, navr = _inputs(1, 4096, 3584, 63, 4)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jpw.welch_fir_pallas_fused(x, y, win, 2049, 1.0, navr=navr,
                                   nwins=4096, noverlap=3584, taps=taps,
                                   detrend_style=0, precision="highest",
                                   interpret=True)


def test_v2_gate_matches_jax_and_lies_in_kernel_b_domain():
    """Every geometry the JAX package's _v2_geometry admits over a grid is
    inside kernel B's domain (the port needs no copy of the gate)."""
    n = 0
    for nwins in (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 384):
        for hop in (64, 128, 256, 384, 512, 1024, 2048, 8192):
            if hop > nwins:
                continue
            for nch in (0, 1, 8, 40, 200):
                for taps in (None, np.ones(129), np.ones(1024)):
                    g = jpw._v2_geometry(nwins, nwins - hop, 100, nch, taps)
                    if g is not None:
                        n += 1
                        assert pw.pallas_welch2_applicable(
                            nwins, nwins - hop, 100, nch, taps)
    assert n > 100
