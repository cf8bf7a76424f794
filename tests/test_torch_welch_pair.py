"""The plan of kernel B's real path and kernel H (``csrc/welch_pair.cu``),
emulated on the CPU.

The kernel runs only on a card (tests/test_torch_cuda.py), so its
arithmetic is held here as a float64 emulation of its plan:

- items (segment group, channel) with the wrapper's group split
  (``welch._pair_groups``), empty groups included;
- per channel one complex FFT of ``x_s + i y_{c,s}`` (``nch >= 1``), or of
  segments ``2p`` and ``2p + 1`` of x (``nch = 0``, the last segment of an
  odd count alone);
- the shared ring of filtered, mean-removed samples indexed by time mod
  ``2N`` a sequence (``4N`` for ``nch = 0``), filled in the kernel's
  order: a unit filters only the samples its predecessors did not, from
  staged raw samples, and at small hop at least 4 outputs a thread ahead,
  as far as the ring and the group reach; the ring starts as NaN, so a
  read of a slot not yet filled shows; at ``N = 16384`` each unit filters
  its whole span instead;
- where the wrapper filters x ahead (``welch._prefilters_x``: two or more
  channels, two or more taps), x's ring slots, and x's span at ``N =
  16384``, come from one filtered row of x (kernel A's), and only y's
  are filtered per unit;
- each sequence scaled by its own power of two (``scale_exponent``), the
  register-radix transform of ``csrc/fft_reg.cuh`` (``_transform`` of
  tests/test_torch_stft.py), the split ``X = (Z_k + conj Z_{N-k}) / 2``,
  ``Y = (Z_k - conj Z_{N-k}) / 2i``, the terms scaled back, bins
  ``0..N/2`` summed per group and over groups, then ``welch._mirror``.

It is held to ``welch_plain`` in float64 at 1e-12 of each output's max
(one transform's rounding apart), and, on float32 inputs, to the JAX
kernels in interpret mode at the bound tests/test_torch_welch.py uses
(rtol 2e-5, atol 3e-5 of max).  The scaling is held in float32 (a
complex64 FFT) to 2e-5 of each output's own max with one sequence 10 to
10^6 times quieter than the other, against an unscaled control that
misses it.
"""
import numpy as np
import pytest
import torch

from pyfft_tpu.filters import firwin
from pyfft_tpu.ops import pallas_welch3 as jw3
from pyfft_tpu.ops.pallas_welch import welch_fir_pallas_fused as jax_fused

from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.ops import welch as pw
from test_torch_stft import _PT, _pad, _pow2, _scale_exponent, _transform

_RING_MAX_LOGN = 13     # csrc/welch_pair.cu's kRingMaxLogN


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _emulate(x, y, win, nfreq, norm, *, navr, nwins, hop, taps, detrend,
             ngroups):
    """csrc/welch_pair.cu's arithmetic in float64 (module docstring).
    Returns ``(Pxx, Pyy, Pxy_re, Pxy_im)`` as ``welch_plain`` does."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64).reshape(-1, x.size)
    sig = np.vstack([x[None], y])
    nch = y.shape[0]
    pair = nch > 0
    N = nwins
    logn = N.bit_length() - 1
    T = N // _PT
    taps = np.ones(1) if taps is None else np.asarray(taps, np.float64)
    K = taps.size
    means = (pw._moment_means(torch.from_numpy(sig), taps).numpy()
             if detrend else np.zeros(sig.shape[0]))
    # x filtered ahead: one row, zero-padded before the signal
    xrow = (np.convolve(np.concatenate([np.zeros(K - 1), x]), taps, "valid")
            - means[0] if pw._prefilters_x(nch, K, False, False) else None)
    n = np.arange(T)[:, None] + np.arange(_PT) * T     # thread t's point r
    w = np.asarray(win, np.float64)[n]
    nunits = navr if pair else (navr + 1) // 2
    per_group = -(-nunits // ngroups)
    nbins = min(nfreq, N // 2 + 1)
    k = torch.arange(N // 2 + 1)
    part = np.zeros((ngroups, nch + 1, 3, N // 2 + 1))

    def filt(s, frm, count):
        """``count`` outputs from time ``frm``: the staged raw samples
        (zeros before the signal), then ``fir_point`` each."""
        idx = np.arange(frm - (K - 1), frm + count)
        raw = np.where(idx >= 0, sig[s][np.clip(idx, 0, None)], 0.0)
        return np.convolve(raw, taps, "valid") - means[s]

    def filt_x(frm, count):
        """x's ``count`` outputs from time ``frm``: from the row filtered
        ahead, else as ``filt``."""
        return (filt(0, frm, count) if xrow is None
                else xrow[frm:frm + count])

    for g in range(ngroups):
        for c in (range(1, nch + 1) if pair else [0]):
            length = 2 * N if pair else 4 * N     # ring samples a sequence
            ring = np.full(2 * length if pair else length, np.nan)
            A, B, lone = [], [], []
            u0, u1 = g * per_group, min(nunits, (g + 1) * per_group)
            ul = u1 - 1
            group_hi = ((ul if pair else 2 * ul) * hop + N
                        + (hop if not pair and 2 * ul + 1 < navr else 0))
            filtered = None
            for u in range(u0, u1):
                sa = (u if pair else 2 * u) * hop
                sb = sa if pair else sa + hop
                has_b = pair or 2 * u + 1 < navr
                if logn <= _RING_MAX_LOGN:
                    hi = (sb if has_b else sa) + N
                    if filtered is None:
                        filtered = sa
                    if filtered < hi:      # filter ahead: >= 4 a thread
                        to = min(max(hi, filtered + 4 * T), sa + length,
                                 group_hi)
                        slots = np.arange(filtered, to) % length
                        ring[slots] = filt_x(filtered, to - filtered)
                        if pair:
                            ring[length + slots] = filt(c, filtered,
                                                        to - filtered)
                        filtered = to
                    a = ring[(sa + n) % length]
                    b = (ring[(length if pair else 0) + (sb + n) % length]
                         if has_b else 0 * a)
                else:
                    a = filt_x(sa, N)[n]
                    b = filt(c, sb, N)[n] if has_b else 0 * a
                A.append(a * w)
                B.append(b * w)
                lone.append(not has_b)
            if not A:
                continue                       # an empty group writes zeros
            a, b = torch.as_tensor(np.stack(A)), torch.as_tensor(np.stack(B))
            ka, kb = _pow2(_scale_exponent(a)), _pow2(_scale_exponent(b))
            buf = _transform(a / ka + 1j * (b / kb), logn)
            zk, zm = buf[:, _pad(k)], buf[:, _pad((N - k) % N)]
            X = (zk + zm.conj()) / 2 * ka[:, 0]
            Y = (zk - zm.conj()) / 2j * kb[:, 0]
            xx, yy = X.abs() ** 2, Y.abs() ** 2
            if pair:
                C = Y * X.conj()
                part[g, c] = torch.stack([yy, C.real, C.imag]).sum(1).numpy()
                if c == 1:
                    part[g, 0, 0] = xx.sum(0).numpy()
            else:
                yy[torch.as_tensor(lone)] = 0.0
                part[g, 0, 0] = (xx + yy).sum(0).numpy()
    out = np.zeros(part.shape[1:])
    for g in range(ngroups):                   # sum_partials' order
        out += part[g]
    out = pw._mirror(torch.as_tensor(out[..., :nbins] * norm), N, nfreq)
    return out[0, 0], out[1:, 0], out[1:, 1], out[1:, 2]


def _inputs(nch, nt, nwins, ntaps, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(nt) + 0.3).astype(dtype)
    y = (rng.standard_normal((nch, nt)) - 0.2).astype(dtype)
    taps = (np.asarray(firwin(ntaps, [0.05, 0.45], pass_zero=False))
            if ntaps > 1 else (None if ntaps == 0 else np.array([0.7])))
    return x, y, taps, np.hanning(nwins + 1)[:-1]


@pytest.mark.parametrize("nch,nt,nwins,hop,ntaps,detrend,nfreq,resident", [
    (8, 64 * 16 + 7, 64, 32, 129, 1, 33, 20),    # nch 8, K > N, navr 31
    (8, 512 + 128 * 14, 512, 128, 1, 1, 257, 16),  # nch 8 at hop 128, 2 groups
    (1, 16 + 40, 16, 1, 5, 1, 16, 6),            # hop 1, all bins (mirror)
    (1, 32 + 50, 32, 1, 129, 0, 17, 7),          # hop 1, K 129
    (0, 128 * 9, 128, 128, 0, 1, 65, 2),         # nch 0, hop N, navr 9: lone
    (0, 256 * 6 + 5, 256, 128, 129, 1, 200, 6),  # nch 0, navr 11, 6 groups
    (0, 16 * 4, 16, 16, 33, 0, 9, 3),            # navr 4, 2 units, 3 groups
    (1, 128 * 4 + 64, 128, 64, 129, 1, 128, 5),  # navr 8: a group is empty
    (3, 2048 + 128 * 19, 2048, 128, 129, 1, 1025, 9),  # the v2 geometry
    (2, 16384 * 2, 16384, 8192, 33, 1, 8193, 4),  # no ring, 3 segments
    (0, 16384 * 2, 16384, 8192, 1, 1, 8193, 1),   # no ring, a lone segment
    # x filtered ahead (nch >= 2, K >= 2): hop N/2, the v2 hop 128, no ring
    (2, 256 * 7 + 9, 256, 128, 5, 1, 129, 5),
    (2, 512 * 6, 512, 256, 129, 1, 257, 7),
    (8, 256 * 7 + 9, 256, 128, 5, 0, 129, 20),
    (8, 512 * 6, 512, 256, 129, 1, 257, 30),
    (2, 2048 + 128 * 13, 2048, 128, 5, 1, 1025, 6),
    (2, 2048 + 128 * 11, 2048, 128, 129, 1, 1025, 4),
    (8, 2048 + 128 * 9, 2048, 128, 5, 1, 1025, 24),
    (8, 2048 + 128 * 10, 2048, 128, 129, 0, 1025, 40),
    (2, 16384 * 2, 16384, 8192, 5, 1, 8193, 4),
    (2, 16384 * 2, 16384, 8192, 129, 1, 8193, 2),
    (8, 16384 * 2, 16384, 8192, 5, 1, 8193, 24),
    (8, 16384 * 2, 16384, 8192, 129, 0, 8193, 9),
])
def test_welch_pair_plan_matches_plain(nch, nt, nwins, hop, ntaps, detrend,
                                       nfreq, resident):
    """The emulated plan against ``welch_plain`` in float64: 1e-12 of each
    output's max."""
    x, y, taps, win = _inputs(nch, nt, nwins, ntaps, nt + nwins)
    navr = (nt - nwins) // hop + 1
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


@pytest.mark.parametrize("nch,nt,nwins,nov,ntaps,detrend", [
    (3, 1 << 14, 1024, 512, 129, 1),
    (2, 1 << 14, 512, 384, 0, 0),
])
def test_welch_pair_plan_matches_jax_kernel(nch, nt, nwins, nov, ntaps,
                                            detrend):
    """The plan on float32 inputs against the JAX fused kernel (interpret
    mode, precision 'highest'): rtol 2e-5, atol 3e-5 of max."""
    x, y, taps, win = _inputs(nch, nt, nwins, ntaps, nch * nt % 7919,
                              np.float32)
    navr = (nt - nov) // (nwins - nov)
    nf = nwins // 2 + 1
    J = jax_fused(x, y, win, nf, 1.0, navr=navr, nwins=nwins, noverlap=nov,
                  taps=taps, detrend_style=detrend, precision="highest",
                  interpret=True)
    P = _emulate(x, y, win, nf, 1.0, navr=navr, nwins=nwins,
                 hop=nwins - nov, taps=taps, detrend=detrend, ngroups=5)
    scl = np.max(np.abs(np.asarray(J[0])))
    for p, j in zip(P, J):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=2e-5,
                                   atol=3e-5 * scl)


@pytest.mark.parametrize("nwins,nov,nt,ntaps,detrend", [
    (512, 256, 1 << 15, 33, 1),
    (256, 128, 9 * 128 * 30 + 128, 0, 0),
])
def test_welch_pair_auto_plan_matches_jax_packed_kernel(nwins, nov, nt, ntaps,
                                                        detrend):
    """``nch = 0`` (two segments of x per transform) on float32 inputs
    against the JAX packed kernel ``welch_auto_packed`` (interpret mode):
    2e-5 of max."""
    x, _, taps, win = _inputs(0, nt, nwins, ntaps, 7, np.float32)
    navr = (nt - nov) // (nwins - nov)
    nf = nwins // 2 + 1
    J = jw3.welch_auto_packed(x, win, nf, 0.5, navr=navr, nwins=nwins,
                              noverlap=nov, taps=taps, detrend_style=detrend,
                              precision="highest", interpret=True)
    P = _emulate(x, np.zeros((0, nt)), win, nf, 0.5, navr=navr, nwins=nwins,
                 hop=nwins - nov, taps=taps, detrend=detrend, ngroups=7)[0]
    J = np.asarray(J)
    assert np.abs(P.numpy() - J).max() <= 2e-5 * np.abs(J).max()


@pytest.mark.parametrize("quiet", ["channel", "reference"])
@pytest.mark.parametrize("ratio", [10, 1e3, 1e6])
def test_pair_scaling_keeps_a_quiet_sequence_accurate(ratio, quiet):
    """x and y of one channel share a complex64 FFT, one of them ``ratio``
    times quieter; each sequence is scaled by its own power of two before
    it and its terms back after it (split and sums in float64, as on the
    card): every output of a 16-segment sum holds 2e-5 of its own max.
    The control, the same pair unscaled, carries the loud sequence's error
    into the quiet one's outputs and misses 2e-5 from 1:1000 on."""
    N, S = 1024, 16
    rng = np.random.default_rng(int(ratio) + len(quiet))
    win = np.hanning(N + 1)[:-1]
    a = rng.standard_normal((S, N)) * win
    b = rng.standard_normal((S, N)) * win
    if quiet == "channel":
        b /= ratio
    else:
        a /= ratio
    k = torch.arange(N // 2 + 1)

    def sums(X, Y):
        C = Y * X.conj()
        return [(X.abs() ** 2).sum(0), (Y.abs() ** 2).sum(0),
                C.real.sum(0), C.imag.sum(0)]

    A, Bq = torch.as_tensor(a), torch.as_tensor(b)
    ref = sums(torch.fft.fft(A)[:, k], torch.fft.fft(Bq)[:, k])

    def pair(scaled):
        a32, b32 = A.float(), Bq.float()
        ka, kb = ((_pow2(_scale_exponent(v.reshape(S, -1, _PT)))[..., 0]
                   if scaled else torch.ones(S, 1, dtype=torch.float64))
                  for v in (A, Bq))
        z = torch.fft.fft(torch.complex(a32 / ka.float(), b32 / kb.float()))
        z = z.to(torch.complex128)
        zk, zm = z[:, k], z[:, (N - k) % N]
        return sums((zk + zm.conj()) / 2 * ka, (zk - zm.conj()) / 2j * kb)

    def worst(got):
        return max(((g - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(got, ref))

    assert worst(pair(True)) <= 2e-5
    if ratio >= 1e3:
        assert worst(pair(False)) > 2e-5


@pytest.mark.parametrize("nch,K,cplx,packed,engaged", [
    (2, 2, False, False, True),
    (8, 129, False, False, True),
    (20, 1024, False, False, True),
    (0, 129, False, False, False),     # x is the only signal
    (1, 129, False, False, False),     # x already filtered once an item
    (8, 1, False, False, False),       # no filter
    (8, 129, True, False, False),      # complex signals: csrc/welch.cu
    (1, 129, False, True, False),      # kernel H
    (0, 33, False, True, False),
])
def test_welch_cuda_filters_x_ahead_only_behind_its_gate(nch, K, cplx, packed,
                                                         engaged):
    """Kernel B's wrapper filters x once ahead (kernel A) for real signals
    with two or more channels and two or more taps, never for kernel H or
    complex signals; the emulated plan takes x's slots from that row
    exactly there."""
    assert pw._prefilters_x(nch, K, cplx, packed) is engaged


def test_moment_means_cache_the_taps():
    """The means prologue takes a single tap as a scalar and caches longer
    taps per content and device; the window cache returns one tensor per
    content."""
    rng = np.random.default_rng(4)
    rows = torch.as_tensor(rng.standard_normal((3, 5000)))
    one = pw._moment_means(rows, np.array([0.7]))
    assert torch.allclose(one, 0.7 * rows.mean(-1), rtol=1e-13, atol=0)
    taps = rng.standard_normal(9)
    pw._device_copy.cache_clear()
    pw._moment_means(rows, taps)
    pw._moment_means(rows, taps.copy())
    info = pw._device_copy.cache_info()
    assert info.misses == 1 and info.hits == 1
    w = np.hanning(64).astype(np.float32).tobytes()
    assert pw._window(w, "cpu") is pw._window(bytes(w), "cpu")
