"""Kernel E's module (pyfft_tpu_torch.ops.welch_v1) and the 'pallas' route
of fft_pwelch against the JAX package.

On the CPU the port's entries run kernel E's plain version; the JAX side
runs TPU kernel #7 in interpret mode at precision 'highest'.  Tolerances:

- float32 on both sides: rtol 2e-5 with atol 3e-5 * max|Pxx| (the bound of
  tests/test_pallas_welch.py for the JAX kernel against float64);
- the plain version in float64 against the JAX 'xla' core in x64: rtol
  1e-10 with atol 1e-10 * max (the FFT libraries' rounding);
- the host tables and the prologue of kernel E in float64: 1e-12.

The kernel itself runs only on a CUDA card (tests/test_torch_cuda.py);
here its arithmetic is emulated with torch.fft on its own host tables.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyfft_tpu as ft
from pyfft_tpu import spectral as jsp
from pyfft_tpu.ops import pallas_welch as jpw

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import spectral as psp
from pyfft_tpu_torch.ops import welch_v1 as pv
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _inputs(nch, nt, nwins, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    t = np.arange(nt)
    x = (rng.standard_normal(nt) + 0.25 + 3e-4 * t).astype(dtype)
    y = (rng.standard_normal((nch, nt)) - 0.5 - 2e-4 * t).astype(dtype)
    win = np.hanning(nwins + 1)[:-1]
    return x, y, win


# odd and even non-radix-2 nwins, every detrend, nch 1/3, navr (13, 56,
# 37, 9) not a multiple of the TPU kernel's 8-segment tile; one radix-2
# nwins with linear detrend (kernel B's gate fails there)
GEOMETRIES = [
    (3, 3000, 300, 200, -1),
    (1, 4001, 301, 150, 1),
    (3, 57000, 1964, 982, 1),       # the heat-pulse test set's nwins
    (1, 9000, 777, 222, 0),
    (3, 5000, 1000, 450, -1),
    (2, 9000, 1024, 1000, -1),
]


@pytest.mark.parametrize("nch,nt,nwins,hop,detrend", GEOMETRIES)
def test_plain_matches_jax_kernel7(nch, nt, nwins, hop, detrend):
    x, y, win, = _inputs(nch, nt, nwins, nwins + nch)
    navr = (nt - nwins) // hop + 1
    nf = nwins // 2 + 1
    assert pv.pallas_welch_applicable(nwins, nf, navr)
    kw = dict(navr=navr, nwins=nwins, noverlap=nwins - hop,
              detrend_style=detrend)
    J = jpw.welch_pallas_fused(x, y, win, nf, 1.0, precision="highest",
                               interpret=True, **kw)
    P = pv.welch_pallas_fused(torch.from_numpy(x), torch.from_numpy(y), win,
                              nf, 1.0, **kw)
    assert all(p.dtype == torch.float32 for p in P)
    assert P[0].shape == (nf,) and P[1].shape == (nch, nf)
    scl = np.max(np.abs(np.asarray(J[0])))
    for p, j in zip(P, J):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=3e-5 * scl)


def test_plain_without_channels_matches_jax_pxx():
    """nch = 0 (auto-spectrum only): the JAX kernel needs a channel, so its
    Pxx from a run with one channel is the reference."""
    x, y, win = _inputs(1, 3000, 300, 5)
    kw = dict(navr=13, nwins=300, noverlap=100, detrend_style=-1)
    J = jpw.welch_pallas_fused(x, y, win, 151, 1.0, precision="highest",
                               interpret=True, **kw)
    P = pv.welch_pallas_fused(torch.from_numpy(x), torch.zeros(0, 3000), win,
                              151, 1.0, **kw)
    assert P[1].shape == (0, 151)
    np.testing.assert_allclose(P[0].numpy(), np.asarray(J[0]), rtol=2e-5,
                               atol=3e-5 * np.abs(np.asarray(J[0])).max())


@pytest.mark.parametrize("nch,B,nwins,nf", [(3, 37, 256, 128),
                                            (2, 21, 1964, 982),
                                            (0, 9, 301, 151)])
def test_power_entry_matches_jax(nch, B, nwins, nf):
    """The pre-framed entry: segment sums of un-windowed frames."""
    rng = np.random.default_rng(B)
    xfr = rng.standard_normal((B, nwins)).astype(np.float32)
    yfr = rng.standard_normal((max(nch, 1), B, nwins)).astype(np.float32)
    win = np.hanning(nwins + 1)[:-1]
    J = jpw.welch_power_pallas(xfr, yfr, win, nf, interpret=True,
                               precision="highest")
    P = pv.welch_power_pallas(torch.from_numpy(xfr),
                              torch.from_numpy(yfr[:nch]), win, nf)
    scl = np.max(np.abs(np.asarray(J[0])))
    np.testing.assert_allclose(P[0].numpy(), np.asarray(J[0]), rtol=2e-5,
                               atol=3e-5 * scl)
    for p, j in zip(P[1:], J[1:]):
        assert p.shape == (nch, nf)
        np.testing.assert_allclose(p.numpy(), np.asarray(j)[:nch],
                                   rtol=2e-5, atol=3e-5 * scl)


@pytest.mark.parametrize("nch,nt,nwins,hop,detrend", GEOMETRIES)
def test_plain_float64_matches_jax_xla_core(nch, nt, nwins, hop, detrend):
    """float64 through the plain version against the JAX 'xla' core in
    x64: the averaged one-sided spectra."""
    x, y, win = _inputs(nch, nt, nwins, nt, np.float64)
    navr = (nt - nwins) // hop + 1
    nf = (nwins + 1) // 2 if nwins % 2 else nwins // 2
    s1sq_enbw = 3.7
    J = jsp._welch_core_xla(jnp.asarray(x), jnp.asarray(y), jnp.asarray(win),
                            s1sq_enbw, navr=navr, nwins=nwins,
                            noverlap=nwins - hop, nfft=nwins, nnyquist=nf,
                            onesided=True, detrend_style=detrend,
                            ntmodel=False)
    Pxx, Pyy, Pr, Pi = pv.welch_dft_plain(
        torch.from_numpy(x), torch.from_numpy(y), win, nf,
        1.0 / (s1sq_enbw * navr), navr=navr, nwins=nwins, hop=hop,
        detrend_style=detrend)
    assert Pxx.dtype == torch.float64
    sc = psp._onesided_power_scale(nwins, nf)
    got = {"Pxx": Pxx.numpy() * sc, "Pyy": (Pyy.numpy() * sc).T,
           "Pxy": ((Pr.numpy() + 1j * Pi.numpy()) * sc).T}
    for k, v in got.items():
        ref = np.asarray(J[k])
        np.testing.assert_allclose(v, ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(), err_msg=k)


@pytest.mark.parametrize("nwins", [1, 2, 3, 5, 12, 100, 1964, 4871, 5452,
                                   8191])
def test_bluestein_tables_give_the_dft(nwins):
    """Kernel E's arithmetic on its host tables, in float64 NumPy: the
    chirp, the filter's FFT and ``post`` give the DFT of any length."""
    v = np.random.default_rng(nwins).standard_normal(nwins)
    M = pv.bluestein_size(nwins)
    assert M & (M - 1) == 0 and (M == nwins or M >= 2 * nwins - 1)
    ref = np.fft.fft(v)
    if M == nwins:
        return
    _, filt, post = pv.bluestein_tables(nwins)
    a = np.zeros(M, complex)
    a[:nwins] = v * pv._chirp(nwins)
    X = post * np.conj(np.fft.fft(np.conj(np.fft.fft(a) * filt)))[:nwins]
    np.testing.assert_allclose(X, ref, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("nwins,M", [(1, 16), (2, 16), (3, 16), (5, 16),
                                     (12, 32), (16, 16), (100, 256),
                                     (1964, 4096), (2047, 4096),
                                     (4871, 8192), (5452, 8192),
                                     (8191, 16384)])
def test_reduced_bluestein_tables_give_the_kept_bins(nwins, M):
    """Kernel E's plan: M from the nfreq = nwins // 2 + 1 kept bins (8192,
    not 16384, at the heat-pulse nwins 4871), and on the reduced tables
    (filter taps for -(nwins - 1) < m < nfreq only) Bluestein's algorithm
    gives those bins of the DFT in float64 to 1e-12 of max."""
    K = nwins // 2 + 1
    assert pv.bluestein_size(nwins, K) == M
    v = np.random.default_rng(nwins).standard_normal(nwins)
    ref = np.fft.fft(v)[:K]
    if nwins == M:          # a power of two >= 16: no Bluestein
        assert pv._device_tables(nwins, K, "cpu")[1] is None
        return
    M2, filt, post = pv.bluestein_tables(nwins, K)
    assert M2 == M and filt.shape == (M,) and post.shape == (K,)
    a = np.zeros(M, complex)
    a[:nwins] = v * pv._chirp(nwins)
    X = post * np.conj(np.fft.fft(np.conj(np.fft.fft(a) * filt)))[:K]
    np.testing.assert_allclose(X, ref, atol=1e-12 * np.abs(ref).max())


def test_transform_size_within_8192_over_the_jax_gate():
    """Over every nwins that passes the gate of TPU kernel #7 (up to 5452),
    with the most bins kernel E's domain allows, M <= 8192: the shared
    memory of two blocks an SM."""
    worst = 0
    for nwins in range(1, 5500):
        nf = nwins // 2 + 1
        if pv.pallas_welch_applicable(nwins, nf, 1):
            M = pv.bluestein_size(nwins, nf)
            assert M & (M - 1) == 0
            assert M == nwins or M >= max(16, nwins + nf - 1)
            worst = max(worst, M)
    assert worst == 8192


@pytest.mark.parametrize("nch,navr,nfreq,cap", [
    (32, 155, 2436, pv.SCRATCH_CAP),     # the heat-pulse call: one chunk
    (3, 13, 151, 8 * 151 * 4 * 5),       # 5 segments of 4 signals a chunk
    (3, 13, 151, 8 * 151 * 4 * 13 - 1),  # one segment short of one chunk
    (5, 7, 10, 8 * 10 * 3),              # channel groups of 2, 1 segment
    (5, 7, 10, 8 * 10 * 7),              # groups of 5 - 1 = 4 and 1
    (0, 9, 33, 8 * 33 * 2),              # no channels, 2 segments a chunk
    (2, 4, 16, 1),                       # below two spectra: the minimum
])
def test_chunks_cover_every_segment_once(nch, navr, nfreq, cap):
    """Kernel E's chunks: every (channel, segment) once, x's spectra of
    every segment once per channel group, the scratch within the cap (or
    two spectra where the cap is smaller), chunks of a group in segment
    order."""
    chunks = pv._chunks(nch, navr, nfreq, cap)
    seen = np.zeros((max(nch, 1), navr), int)
    groups = {}
    for c0, nc, s0, ns in chunks:
        assert 8 * nfreq * (1 + nc) * ns <= max(cap, 16 * nfreq)
        assert ns >= 1 and (nc >= 1) == (nch > 0)
        assert groups.setdefault((c0, nc), s0) == s0
        groups[(c0, nc)] = s0 + ns
        seen[c0:c0 + max(nc, 1), s0:s0 + ns] += 1
    assert (seen == 1).all()
    assert all(end == navr for end in groups.values())
    if cap == pv.SCRATCH_CAP:
        assert chunks == [(0, nch, 0, navr)]


@pytest.mark.parametrize("ncols,ns,nfreq", [
    (33, 155, 2436),    # the heat-pulse call: one group, 2541 blocks
    (5, 4096, 1024),    # chip_smoke.py case c: 7 groups
    (9, 65534, 2),      # case e: one bin tile, 118 groups
    (4, 13, 151),       # fewer segments than a group's least
    (1, 1, 1),
])
def test_sum_groups_cover_the_segments_and_fill_the_card(ncols, ns, nfreq):
    """Kernel E's sums pass: groups of at least 16 segments (or all of
    them) partition the segments, and the blocks number at least 8 an SM
    on 132 SMs where the segments allow it, and not twice that."""
    spg = pv._sum_split(ncols, ns, nfreq, 132)
    groups = -(-ns // spg)
    assert spg >= 16 and (groups - 1) * spg < ns <= groups * spg
    blocks = -(-nfreq // 32) * ncols * groups
    assert blocks >= min(8 * 132, -(-nfreq // 32) * ncols * -(-ns // 16))
    assert groups == 1 or blocks < 2 * 8 * 132


def _emulate_kernel_e(x, y, win, nfreq, norm, navr, nwins, hop, detrend,
                      cap=None):
    """Kernel E's plan in torch on the CPU, from its own operands: the
    float64 prologue, ``pre`` (window times chirp), detrend on load, the
    transforms at ``M = bluestein_size(nwins, nfreq)`` on the reduced
    float32 ``filt``/``post`` tables with the filter product in natural
    order, the kept bins of each chunk of :func:`pv._chunks` in a complex64
    scratch, and float64 sums over each chunk's segments in order, added
    to the earlier chunks' sums, in the order of the sums and combine
    passes (:func:`pv._sum_split`'s groups of segments on 132 SMs)."""
    sig = torch.cat([x[None], y])
    nch, nt = y.shape
    M, filt, post, _ = pv._device_tables(nwins, nfreq, "cpu")
    assert M == pv.bluestein_size(nwins, nfreq)
    mean, slope = pv._trend(sig, detrend)
    t = torch.arange(nt, dtype=torch.float64) - (nt - 1) / 2.0
    d = (sig - (mean[:, None] + slope[:, None] * t).to(torch.float32))
    pre = pv._pre_table(np.asarray(win, np.float64).tobytes(), "cpu")
    frames = d.unfold(-1, nwins, hop)[:, :navr] * pre

    # every item's kept bins (an item's transforms do not depend on the
    # chunk it is in)
    A = torch.fft.fft(frames, n=M, dim=-1)
    if filt is None:
        kept = A[..., :nfreq]
    else:
        kept = post * torch.fft.fft((A * filt).conj(), dim=-1)[
            ..., :nfreq].conj()
    assert kept.dtype == torch.complex64
    acc = torch.zeros((nch + 1, 3, nfreq), dtype=torch.float64)
    for c0, nc, s0, ns in pv._chunks(nch, navr, nfreq, cap):
        rows = [0] + list(range(c0 + 1, c0 + nc + 1))
        spec = kept[rows, s0:s0 + ns].to(torch.complex128)
        # dft_sums: each group's 8 lanes, every 8th segment in order, the
        # lanes added in order; dft_combine: the groups in order, then acc
        spg = pv._sum_split(len(rows) - (c0 > 0), ns, nfreq, 132)
        chunk = torch.zeros((1 + nc, 3, nfreq), dtype=torch.float64)
        for g0 in range(0, ns, spg):
            group = torch.zeros_like(chunk)
            for lane in range(8):
                a = torch.zeros_like(chunk)
                for s in range(g0 + lane, min(ns, g0 + spg), 8):
                    X, Y = spec[0, s], spec[1:, s]
                    a[0, 0] += X.abs() ** 2
                    a[1:, 0] += Y.abs() ** 2
                    a[1:, 1] += (Y * X.conj()).real
                    a[1:, 2] += (Y * X.conj()).imag
                group += a
            chunk += group
        cols = rows if c0 == 0 else rows[1:]
        acc[cols] = (chunk if c0 == 0 else chunk[1:]) + acc[cols]
    out = acc * norm
    return out[0, 0], out[1:, 0], out[1:, 1], out[1:, 2]


@pytest.mark.parametrize("nch,nt,nwins,hop,detrend", GEOMETRIES)
def test_kernel_emulation_matches_plain(nch, nt, nwins, hop, detrend):
    """The emulated kernel against the plain version, float32: max |diff|
    <= 2e-5 * max |ref| per output (chip_smoke.py's bound for the kernel)."""
    x, y, win = _inputs(nch, nt, nwins, 7)
    navr = (nt - nwins) // hop + 1
    nf = nwins // 2 + 1
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = _emulate_kernel_e(xt, yt, win, nf, 0.5, navr, nwins, hop, detrend)
    ref = pv.welch_dft_plain(xt, yt, win, nf, 0.5, navr=navr, nwins=nwins,
                             hop=hop, detrend_style=detrend)
    for g, r in zip(got, ref):
        err = (g.double() - r.double()).abs().max() / r.abs().max()
        assert err <= 2e-5


@pytest.mark.parametrize("nch,nt,nwins,hop,detrend", GEOMETRIES)
def test_chunked_kernel_emulation_matches_unchunked(nch, nt, nwins, hop,
                                                    detrend):
    """The emulated kernel with a scratch cap of six spectra (one to three
    segments a chunk, or channel groups of one or two where six do not
    hold every signal's) against one chunk: the same float64 sums to 1e-12
    of max (the order of the additions differs), and within 2e-5 of the
    plain version."""
    x, y, win = _inputs(nch, nt, nwins, 11)
    navr = (nt - nwins) // hop + 1
    nf = nwins // 2 + 1
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    args = (xt, yt, win, nf, 0.5, navr, nwins, hop, detrend)
    cap = 8 * nf * 2 * 3
    assert len(pv._chunks(nch, navr, nf, cap)) >= navr // 3
    got = _emulate_kernel_e(*args, cap=cap)
    one = _emulate_kernel_e(*args)
    ref = pv.welch_dft_plain(xt, yt, win, nf, 0.5, navr=navr, nwins=nwins,
                             hop=hop, detrend_style=detrend)
    for g, o, r in zip(got, one, ref):
        assert (g - o).abs().max() <= 1e-12 * o.abs().max()
        assert (g - r.double()).abs().max() <= 2e-5 * r.abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_trend_prologue_matches_least_squares(dtype, tol):
    """Kernel E's float64 prologue (block sums of x and of (t - tbar) x)
    against a float64 least-squares line; float32 rows round each block
    sum to float32."""
    rng = np.random.default_rng(3)
    nt = 3 * 4096 + 1234
    t = np.arange(nt)
    rows = (1.0 + 0.3 * rng.standard_normal((4, nt))
            + np.array([0.0, 1e-4, -3e-5, 2e-6])[:, None] * t)
    mean, slope = pv._trend(torch.as_tensor(rows, dtype=dtype), -1)
    tc = t - (nt - 1) / 2
    ref_slope = (rows * tc).sum(1) / (tc * tc).sum()
    np.testing.assert_allclose(mean.numpy(), rows.mean(1), rtol=tol)
    np.testing.assert_allclose(slope.numpy(), ref_slope,
                               atol=tol * np.abs(ref_slope).max())
    m1, s1 = pv._trend(torch.as_tensor(rows, dtype=dtype), 1)
    np.testing.assert_allclose(m1.numpy(), rows.mean(1), rtol=tol)
    assert not s1.any()


def test_kernel_domain_contains_the_jax_gate():
    """Every geometry that passes the gate of TPU kernel #7 lies in kernel
    E's domain; the gate ends at nwins = 5452 (minimal tiles in VMEM)."""
    last = 0
    for nwins in range(1, 6001):
        nf = (nwins + 1) // 2 if nwins % 2 else nwins // 2
        for navr in (1, 13, 200):
            if pv.pallas_welch_applicable(nwins, nf, navr):
                last = max(last, nwins)
                assert pv.kernel_applicable(nwins, nf, 1, navr, -1)
                assert jpw.pallas_welch_applicable(nwins, nf, navr)
    assert last == 5452
    assert not pv.kernel_applicable(pv.MAX_NWINS + 1, 10, 1, 1)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1000)
    with pytest.raises(ValueError):
        pv.welch_dft_cuda(x, x[None], np.ones(100), 51, 1.0, navr=5,
                          nwins=100, hop=100)
    with pytest.raises(ValueError):
        pv.welch_pallas_fused(x, x[None], np.ones(100), 51, 1.0, navr=5,
                              nwins=100, noverlap=0, detrend_style=2)


def _jax_takes_pallas(nwins, noverlap, navr, nnyquist, detrend):
    """pyfft_tpu/spectral.py:456-464 for one-sided real input."""
    return (jpw.pallas_welch2_applicable(nwins, noverlap, navr,
                                         detrend_style=detrend)
            or jpw.pallas_welch_applicable(nwins, nnyquist, navr))


@pytest.mark.parametrize("detrend", [-1, 0, 1])
def test_dispatch_takes_a_kernel_wherever_jax_takes_pallas(detrend):
    """Over a grid of geometries the port's 'pallas' route takes kernel B
    or E wherever the JAX package takes a Pallas kernel (so torch.fft only
    where the JAX package takes 'mxu'), and kernel E exactly where the
    gate of TPU kernel #7 holds and kernel B's does not."""
    taken = {"B": 0, "E": 0, None: 0}
    for nwins in (16, 100, 127, 128, 512, 1000, 1820, 1964, 2048, 4096,
                  4871, 5452, 5453, 6000, 8192, 16384, 20000):
        for frac in (0.0, 0.25, 0.5, 0.75):
            noverlap = int(np.ceil(frac * nwins))
            nny = (nwins + 1) // 2 if nwins % 2 else nwins // 2
            for navr in (1, 9, 155):
                route = psp.pallas_route(
                    nwins=nwins, noverlap=noverlap, navr=navr, nnyquist=nny,
                    onesided=True, detrend_style=detrend, ntmodel=False,
                    is_cplx=False)
                taken[route] += 1
                # kernel B's domain is wider than the TPU's v3 gate, so the
                # port may take a kernel where JAX does not, never less
                if _jax_takes_pallas(nwins, noverlap, navr, nny, detrend):
                    assert route is not None, (nwins, noverlap, navr)
                if route == "E":
                    assert jpw.pallas_welch_applicable(nwins, nny, navr)
                if route == "E":
                    assert pv.kernel_applicable(nwins, nny,
                                                nwins - noverlap, navr,
                                                detrend)
    assert taken["E"] > 0 and taken[None] > 0
    assert (taken["B"] > 0) == (detrend != -1)
    # the per-segment model, one-sided complex and two-sided real input
    # take no kernel, as in the JAX package
    for kw in (dict(ntmodel=True, is_cplx=False, onesided=True),
               dict(ntmodel=False, is_cplx=True, onesided=True),
               dict(ntmodel=False, is_cplx=False, onesided=False)):
        assert psp.pallas_route(nwins=1964, noverlap=982, navr=9,
                                nnyquist=982, detrend_style=detrend,
                                **kw) is None


def test_fft_pwelch_pallas_matches_jax_pallas():
    """The call of tests/test_pallas_welch.py:29-43 (N = 8192, Navr = 8:
    nwins = 1820, outside kernel B's gate): both sides through their
    Pallas/kernel route, float32, the same bound as that test."""
    rng = np.random.default_rng(1)
    N = 2 ** 13
    t = np.arange(N) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(N)
    y = np.sin(2 * np.pi * 97.0 * t - 0.5) + 0.1 * rng.standard_normal(N)
    args = dict(tbounds=[t[1], t[-2]], Navr=8, windowfunction="hanning",
                detrend_style=1, plotit=False, verbose=False)
    J = ft.fft_pwelch(t, x, y, fft_backend="pallas", **args)
    P = pt.fft_pwelch(t, x, y, fft_backend="pallas", device="cpu", **args)
    info = P[-1]
    assert info.nwins == 1820 and "_lazy_segments" in info.__dict__
    assert psp.pallas_route(nwins=info.nwins, noverlap=info.noverlap,
                            navr=info.Navr, nnyquist=info.Nnyquist,
                            onesided=True, detrend_style=1, ntmodel=False,
                            is_cplx=False) == "E"
    np.testing.assert_allclose(P[0], np.asarray(J[0]), atol=1e-9)
    for k in (1, 2, 3):      # Pxy, Pxx, Pyy
        ref = np.asarray(J[k])
        np.testing.assert_allclose(P[k], ref, rtol=5e-5,
                                   atol=1e-9 + 2e-5 * np.abs(ref).max())
    # the lazily filled per-segment arrays come from the xla core
    assert info.Pxx_seg.shape == (info.Navr, info.Nnyquist)


def test_fft_pwelch_pallas_linear_detrend_takes_kernel_e():
    """detrend_style = -1 at a radix-2 nwins: kernel B's gate fails, kernel
    E's plain version runs, and it agrees with the 'xla' core."""
    rng = np.random.default_rng(2)
    t = np.arange(1 << 13) / 1e3
    x = rng.standard_normal(t.size) + 0.5 * t
    y = np.stack([x + 0.1 * rng.standard_normal(t.size), -0.2 * t])
    args = dict(tbounds=[t[1], t[-2]], tper=1024.5 / 1e3, detrend_style=-1,
                plotit=False, device="cpu")
    P = pt.fft_pwelch(t, x, y, fft_backend="pallas", **args)
    X = pt.fft_pwelch(t, x, y, fft_backend="xla", **args)
    assert P[-1].nwins == 1024
    assert "_lazy_segments" in P[-1].__dict__
    for k in (1, 2, 3):
        np.testing.assert_allclose(P[k], X[k], rtol=5e-5,
                                   atol=2e-5 * np.abs(X[k]).max())
