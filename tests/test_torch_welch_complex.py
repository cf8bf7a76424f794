"""The plan of kernel B's complex path (``csrc/welch.cu``), emulated on the
CPU.

The kernel runs only on a card (tests/test_torch_cuda.py), so its
arithmetic is held here as a float64 emulation of its plan:

- items (segment group, channel) with the wrapper's group split
  (``welch._pair_groups``), empty groups included; a unit is two
  transforms, A = x_s and B = y_{c,s} (``nch >= 1``: 2 nch transforms a
  segment, only channel 1's items keep |X|^2), or A = x_{2p} and B =
  x_{2p+1} (``nch = 0``, B zero for the last segment of an odd count);
- thread t's point r is sample ``start + t + r*T`` (T = N/16); without
  taps the one tap is a product, with taps the staged span (zeros before
  the signal) goes through ``fir_pair``'s products in ``fir_point``'s
  order; then the mean and the window;
- the register-radix transform of ``csrc/fft_reg.cuh`` (``_transform`` of
  tests/test_torch_stft.py), A and B side by side up to N = 8192, one
  after the other at 16384;
- the bins of a thread (``k = i + b*2T`` side by side, ``t + b*T`` at
  16384) and their float64 sums: |A|^2, |B|^2, Re and Im of B conj A per
  bin in unit order within a group, the groups added in order
  (``sum_partials``).

It is held to ``welch_plain`` in float64 at 1e-12 of each output's max (one
transform's rounding apart), and, on float32 inputs, to the JAX two-sided
kernel in interpret mode at the bound tests/test_torch_welch.py uses
(rtol 2e-5, atol 3e-5 of max).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfft_tpu.filters import firwin
from pyfft_tpu.ops.pallas_welch3 import pallas_welch3_cplx_applicable
from pyfft_tpu.ops.pallas_welch3 import welch_pallas3_twosided as jax_twosided

from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.ops import welch as pw
from test_torch_stft import _PT, _pad, _transform

_SRC = (Path(pw.__file__).resolve().parent.parent / "csrc"
        / "welch.cu").read_text()
_SIDE_MAX_LOGN = int(re.search(r"kSideMaxLogN = (\d+);", _SRC).group(1))
_SMEM_MAX = 232448          # bytes of shared memory a block can use


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _bins(logn):
    """The bins each thread of a block sums, ``(threads, bins)``."""
    N = 1 << logn
    T = N // _PT
    bt = 2 * T if logn <= _SIDE_MAX_LOGN else T
    return np.arange(bt)[:, None] + np.arange(N // bt) * bt


def _smem_bytes(logn, K):
    """``smem_bytes`` of csrc/welch.cu: the FFT buffers (pad(N) float2 a
    transform) or, with taps, the staged spans (N + K - 1 floats, rounded
    to 16 bytes, for the real and the imaginary part of each sequence) if
    larger; the |X|^2 sums side by side (N float64); then the taps."""
    N = 1 << logn
    side = logn <= _SIDE_MAX_LOGN
    seq = (N + K + 2) & ~3
    region = (2 if side else 1) * (2 * seq if K > 1 and seq > _pad(N)
                                   else 2 * _pad(N))
    return 4 * (region + (2 * N if side else 0) + (K if K > 1 else 0))


def _emulate(x, y, win, nfreq, norm, *, navr, nwins, hop, taps, detrend,
             ngroups):
    """csrc/welch.cu's arithmetic in float64 (module docstring).  Returns
    ``(Pxx, Pyy, Pxy_re, Pxy_im)`` as ``welch_plain`` does."""
    x = np.asarray(x, np.complex128)
    y = np.asarray(y, np.complex128).reshape(-1, x.size)
    sig = np.vstack([x[None], y])
    nch = y.shape[0]
    pair = nch > 0
    N = nwins
    logn = N.bit_length() - 1
    T = N // _PT
    taps = np.ones(1) if taps is None else np.asarray(taps, np.float64)
    K = taps.size
    if detrend:
        s = torch.from_numpy(sig)
        means = (pw._moment_means(s.real, taps).numpy()
                 + 1j * pw._moment_means(s.imag, taps).numpy())
    else:
        means = np.zeros(sig.shape[0], np.complex128)
    n = np.arange(T)[:, None] + np.arange(_PT) * T     # thread t's point r
    w = np.asarray(win, np.float64)[n]
    nunits = navr if pair else (navr + 1) // 2
    per_group = -(-nunits // ngroups)
    part = np.zeros((ngroups, nch + 1, 3, N))

    def points(s, starts):
        """Thread t's points of signal s's segments at ``starts``:
        ``(len(starts), T, 16)``."""
        starts = np.asarray(starts)
        if K == 1:
            f = taps[0] * sig[s][starts[:, None] + np.arange(N)]
        else:                    # the staged spans, fir_pair's order
            idx = starts[:, None] + np.arange(-(K - 1), N)
            raw = np.where(idx >= 0, sig[s][np.clip(idx, 0, None)], 0)
            f = np.zeros((len(starts), N), np.complex128)
            for k in range(K):
                f = f + taps[k] * raw[:, K - 1 - k:K - 1 - k + N]
        return (f[:, n] - means[s]) * w

    k = np.arange(N)
    for g in range(ngroups):
        for c in (range(1, nch + 1) if pair else [0]):
            units = range(g * per_group, min(nunits, (g + 1) * per_group))
            if not len(units):
                continue                     # an empty group writes zeros
            sa = np.array([(u if pair else 2 * u) * hop for u in units])
            has_b = np.array([pair or 2 * u + 1 < navr for u in units])
            va = points(0, sa)
            vb = points(c, sa if pair else np.where(has_b, sa + hop, sa))
            vb[~has_b] = 0.0
            A = _transform(torch.from_numpy(va), logn)[:, _pad(k)].numpy()
            Bk = _transform(torch.from_numpy(vb), logn)[:, _pad(k)].numpy()
            aa = A.real ** 2 + A.imag ** 2
            bb = Bk.real ** 2 + Bk.imag ** 2
            sums = np.zeros((4, N))
            for i in range(len(units)):      # unit order, per bin
                if pair:
                    sums[0] += aa[i]
                    sums[1] += bb[i]
                    sums[2] += Bk[i].real * A[i].real + Bk[i].imag * A[i].imag
                    sums[3] += Bk[i].imag * A[i].real - Bk[i].real * A[i].imag
                else:
                    sums[0] += aa[i] + bb[i]
            if pair:
                part[g, c] = sums[1:]
            if not pair or c == 1:
                part[g, 0, 0] = sums[0]
    out = np.zeros(part.shape[1:])
    for g in range(ngroups):                 # sum_partials' order
        out += part[g]
    out = torch.as_tensor(out[..., :nfreq] * norm)
    return out[0, 0], out[1:, 0], out[1:, 1], out[1:, 2]


def _inputs(nch, nt, nwins, ntaps, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)
         + 0.3 - 0.2j).astype(dtype)
    y = (rng.standard_normal((nch, nt)) + 1j * rng.standard_normal((nch, nt))
         - 0.2).astype(dtype)
    taps = (np.asarray(firwin(ntaps, [0.05, 0.45], pass_zero=False))
            if ntaps > 1 else (None if ntaps == 0 else np.array([0.7])))
    return x, y, taps, np.hanning(nwins + 1)[:-1]


# (logn, nch, hop, ntaps, navr, detrend, nfreq, resident): every log2 N
# 4..14; nch 0, 1, 3 and 20; odd navr; hop 1 and hop = N; 0 (no taps), 1
# (one tap 0.7), 5, 129 and 1024 taps
_CASES = [
    (4, 1, 1, 5, 41, 1, 16, 6),          # hop 1, navr 41, 6 groups
    (5, 0, 32, 0, 9, 1, 32, 3),          # nch 0, hop N, navr 9: lone
    (6, 20, 32, 129, 7, 0, 64, 45),      # nch 20, K > N, 2 groups
    (7, 3, 1, 1024, 5, 1, 128, 7),       # hop 1, K 1024
    (8, 0, 96, 33, 11, 0, 256, 4),       # nch 0, navr 11: a lone unit
    (9, 20, 1, 1, 9, 1, 300, 40),        # nch 20, hop 1, one tap, nfreq < N
    (9, 1, 512, 0, 3, 0, 512, 5),        # hop N, a unit a group
    (10, 3, 512, 129, 7, 1, 1024, 9),
    (11, 1, 1024, 129, 5, 1, 2048, 4),   # config 0's geometry
    (12, 3, 2048, 0, 5, 1, 4096, 6),     # config 5's IQ geometry
    (12, 1, 4096, 1024, 3, 0, 4096, 1),  # hop N, K 1024, one group
    (13, 0, 4096, 5, 3, 1, 8192, 2),     # side by side at its largest
    (14, 1, 16384, 1024, 3, 1, 16384, 2),   # A then B, K 1024
    (14, 0, 8192, 0, 3, 0, 16384, 2),       # A then B, nch 0, lone
    (14, 3, 8192, 1, 3, 1, 10000, 5),       # A then B, nfreq < N
]


@pytest.mark.parametrize("logn,nch,hop,ntaps,navr,detrend,nfreq,resident",
                         _CASES)
def test_welch_complex_plan_matches_plain(logn, nch, hop, ntaps, navr,
                                          detrend, nfreq, resident):
    """The emulated plan against ``welch_plain`` in float64: 1e-12 of each
    output's max."""
    nwins = 1 << logn
    nt = (navr - 1) * hop + nwins + 3
    x, y, taps, win = _inputs(nch, nt, nwins, ntaps, nt + nwins)
    ngroups = pw._pair_groups(navr, nch, resident)
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps)
    got = _emulate(x, y, win, nfreq, 0.5, detrend=detrend, ngroups=ngroups,
                   **kw)
    ref = pw.welch_plain(torch.from_numpy(x), torch.from_numpy(y), win, nfreq,
                         0.5, detrend_style=detrend, **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if r.numel():
            assert (g - r).abs().max() <= 1e-12 * r.abs().max()


@pytest.mark.parametrize("nchz,ntaps,detrend", [(1, 0, 1), (3, 97, 0)])
def test_welch_complex_plan_matches_jax_kernel(nchz, ntaps, detrend):
    """The plan on complex64 inputs against the JAX two-sided kernel
    (interpret mode, precision 'highest'): rtol 2e-5, atol 3e-5 of max."""
    nt, nwins, nov = 1 << 13, 512, 256
    x, y, taps, win = _inputs(nchz, nt, nwins, ntaps, 3 * nchz + ntaps,
                              np.complex64)
    navr = (nt - nov) // (nwins - nov)
    assert pallas_welch3_cplx_applicable(nwins, nov, navr, nchz, detrend)
    J = jax_twosided(x, y, win, 1.0 / navr, navr=navr, nwins=nwins,
                     noverlap=nov, taps=taps, detrend_style=detrend,
                     precision="highest", interpret=True)
    got = _emulate(x, y, win, nwins, 1.0 / navr, navr=navr, nwins=nwins,
                   hop=nwins - nov, taps=taps, detrend=detrend,
                   ngroups=pw._pair_groups(navr, nchz, 13))
    scl = np.max(np.abs(np.asarray(J[0])))
    for g, j in zip(got, J):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=3e-5 * scl)


@pytest.mark.parametrize("logn", range(4, 15))
def test_welch_complex_bins_cover_the_spectrum_once(logn):
    """Every bin is summed by exactly one thread of a block: 8 a thread side
    by side (2 N/16 threads), 16 at N = 16384 (N/16 threads), each thread's
    bins one block apart, so neighbouring threads read neighbouring
    slots of the buffers."""
    N = 1 << logn
    bins = _bins(logn)
    assert np.array_equal(np.sort(bins.ravel()), np.arange(N))
    assert bins.shape[1] == (8 if logn <= _SIDE_MAX_LOGN else 16)
    assert bins.shape[0] <= 1024
    assert np.all(np.diff(bins[:, 0]) == 1)


@pytest.mark.parametrize("logn", range(4, 15))
def test_welch_complex_shared_memory_fits(logn):
    """The block's shared memory fits the 227 KB a block can use at every
    N and up to 1024 taps; two buffers and the |X|^2 sums fit up to N =
    8192, not at 16384; the module's stated largest figure holds (217 KB,
    N = 8192 with 1024 taps)."""
    N = 1 << logn
    side = logn <= _SIDE_MAX_LOGN
    sizes = [_smem_bytes(logn, K) for K in (1, 5, 129, 1024)]
    assert max(sizes) <= _SMEM_MAX
    assert sizes[0] == (2 * 8 * _pad(N) + 8 * N if side else 8 * _pad(N))
    assert (2 * 8 * _pad(N) + 8 * N <= _SMEM_MAX) == side
    largest = max(_smem_bytes(e, 1024) for e in range(4, 15))
    assert largest == _smem_bytes(13, 1024)
    assert round(largest / 1000) == 217


def test_welch_complex_entry_runs_plain_on_the_cpu():
    """On CPU tensors the two-sided entry runs the plain version, in
    complex64, and counts no launch of either kernel B path."""
    x, y, _, win = _inputs(2, 4096, 256, 0, 1, np.complex64)
    before = (pw.LAUNCHES, pw.COMPLEX_LAUNCHES, pw.PACKED_LAUNCHES)
    got = pw.welch_pallas3_twosided(x, y, win, 0.1, navr=31, nwins=256,
                                    noverlap=128)
    assert (pw.LAUNCHES, pw.COMPLEX_LAUNCHES, pw.PACKED_LAUNCHES) == before
    ref = pw.welch_plain(torch.from_numpy(x), torch.from_numpy(y), win, 256,
                         0.1, navr=31, nwins=256, hop=128)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r)
