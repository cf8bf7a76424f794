"""The plan of kernels A and I (``csrc/fir.cu`` on ``fir.cuh::fir4``),
emulated on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py), so their index
arithmetic is held here as a float64 emulation of their plan, with the
constants read from the sources:

- a block per (tile of ``kTile`` outputs, channel); its stage holds the
  tile's samples and the ``K - 1`` before it (zeros before the signal and
  at or past ``nt``), then zeros up to a multiple of 4 at least 7 past the
  span; the taps reversed, zero-padded to a multiple of 4;
- thread ``t`` makes outputs ``4t .. 4t + 3`` of the tile from 16-byte
  loads (index arrays here, so a read past either array raises): the top
  group of taps holds ``emax + 1 = K - 4 * ((K - 1) >> 2)`` of them, every
  lower group 4, and output ``j`` sums ``rt[d] * s[j + d]`` for ``d`` from
  ``K - 1`` down to 0, ``fir_point``'s order;
- kernel A stores a group with one 16-byte store where the row allows and
  one float at a time at a row's end when ``nt % 4 != 0`` or the tile is
  cut short; kernel I stores it at its lanes of the interleaved layout,
  less ``sub``, zeros at or past ``nt``.

Outputs start as NaN and every store is counted, so an output written
twice or never shows.  The emulation is held to ``fir_plain`` and
``fir_transpose_plain`` in float64 at 1e-12 of the max.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.ops import fir as pfir

_CSRC = Path(pfir.__file__).resolve().parent.parent / "csrc"


def _constant(name, source):
    text = (_CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


TILE = _constant("kTile", "fir.cu")
THREADS = _constant("kThreads", "fir.cu")
POINTS = _constant("kPoints", "fir.cu")
LANES = _constant("kLanes", "fir.cu")
MAX_TAPS = _constant("kFirMaxTaps", "fir.cuh")
KS = (1, 2, 3, 4, 5, 127, 128, 129, 1024)


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _stage_len(K):
    """fir.cu's stage_floats."""
    return (TILE + K - 1 + 7 + 3) & ~3


def _stage(sig, n0, K):
    """fir.cu's stage_tile for one signal: (samples, reversed taps)."""
    span = TILE + K - 1
    j = np.arange(_stage_len(K))
    t = n0 - (K - 1) + j
    ok = (j < span) & (t >= 0) & (t < sig.size)
    return np.where(ok, sig[np.clip(t, 0, sig.size - 1)], 0.0)


def _reversed_taps(taps):
    K = taps.size
    d = np.arange((K + 3) & ~3)
    return np.where(d < K, taps[np.clip(K - 1 - d, 0, K - 1)], 0.0)


def _load4(arr, base):
    """16-byte loads at element offsets ``base`` (multiples of 4)."""
    base = np.asarray(base)
    assert np.all(base % 4 == 0)
    return arr[base[..., None] + np.arange(4)]


def _fir4(s, rt, K, j0, log=None):
    """fir.cuh::fir4<false> for the groups at ``j0`` in float64.  ``log``
    gathers ``(group, d, the staged positions read for the 4 outputs)`` in
    the order of the products."""
    o = np.zeros((j0.size, 4))
    g = (K - 1) >> 2
    ha = _load4(s, j0 + 4 * (g + 1))
    emax = K - 1 - 4 * g                       # the top group: d <= K - 1
    while g >= 0:
        la = _load4(s, j0 + 4 * g)
        t = _load4(rt, [4 * g])[0]
        w = np.concatenate([la, ha], axis=1)   # window8
        for e in range(emax, -1, -1):          # fma4<e>
            o += t[e] * w[:, e:e + 4]
            if log is not None:
                log.append((g, 4 * g + e, j0[:, None] + e + 4 * g
                            + np.arange(4)))
        ha, emax, g = la, 3, g - 1
    return o


def _groups(n0, nend):
    """The threads of the tile at ``n0`` whose first output is before
    ``nend``: (j0, t0)."""
    j0 = POINTS * np.arange(THREADS)
    live = n0 + j0 < nend
    return j0[live], n0 + j0[live]


def _emulate_fir(x, taps):
    """Kernel A on ``x (nch, nt)``: (y, stores per output)."""
    nch, nt = x.shape
    K = taps.size
    rt = _reversed_taps(taps)
    vec = nt % POINTS == 0          # y itself is 16-byte aligned
    y = np.full(nch * nt, np.nan)
    writes = np.zeros(nch * nt, int)
    for row in range(nch):
        for n0 in range(0, nt, TILE):
            s = _stage(x[row], n0, K)
            j0, t0 = _groups(n0, nt)
            for t, o in zip(t0, _fir4(s, rt, K, j0)):
                at = row * nt + t
                if vec and t + POINTS <= nt:
                    assert at % 4 == 0          # one 16-byte store
                    y[at:at + 4] = o
                    writes[at:at + 4] += 1
                else:
                    for i in range(POINTS):
                        if t + i < nt:
                            y[at + i] = o[i]
                            writes[at + i] += 1
    return y.reshape(nch, nt), writes


def _emulate_fir_t(x, y, taps, nrows_out, sub):
    """Kernel I: (out (nrows_out, C*128), stores per output)."""
    sig = np.vstack([x[None], y])
    C, nt = sig.shape
    assert nt % LANES == 0
    K = taps.size
    rt = _reversed_taps(taps)
    nout = nrows_out * LANES
    out = np.full(nrows_out * C * LANES, np.nan)
    writes = np.zeros(out.size, int)
    for c in range(C):
        for n0 in range(0, nout, TILE):
            signal = n0 < nt
            j0, t0 = _groups(n0, nout)
            o = np.zeros((j0.size, POINTS))
            if signal:
                s = _stage(sig[c], n0, K)
                live = t0 < nt
                # a group is all signal or all past it
                assert np.all(live == (t0 + POINTS - 1 < nt))
                o[live] = _fir4(s, rt, K, j0[live])
                if sub is not None:
                    lanes = (t0[live] & (LANES - 1))[:, None] + np.arange(4)
                    o[live] -= sub[c * LANES + lanes]
            for t, v in zip(t0, o):
                lane = t & (LANES - 1)
                assert lane + POINTS <= LANES   # one run of 128 lanes
                at = (t // LANES) * C * LANES + c * LANES + lane
                assert at % 4 == 0
                out[at:at + 4] = v
                writes[at:at + 4] += 1
    return out.reshape(nrows_out, C * LANES), writes


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_constants_and_shared_memory():
    """4 outputs a thread cover the tile, a tile is whole 128-lane runs,
    and the static shared memory (the largest stage and the taps) stays
    under the 48 KB a block gets without the opt-in attribute."""
    assert TILE == POINTS * THREADS and TILE % LANES == 0
    assert MAX_TAPS == pfir.PALLAS_FIR_MAX_TAPS
    assert 4 * (_stage_len(MAX_TAPS) + MAX_TAPS) < 48 * 1024
    src = (_CSRC / "fir.cu").read_text()
    assert "return (kTile + K - 1 + 7 + 3) & ~3;" in src      # _stage_len
    assert "kStageMax = stage_floats(kFirMaxTaps);" in src


@pytest.mark.parametrize("K", KS)
def test_stage_halo_and_zero_pad(K):
    """The first tile's stage: K - 1 zeros before x[0] (the halo at n0 =
    0), the tile, then at least 7 zeros to a multiple of 4; the reversed
    taps are zero-padded to a multiple of 4."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal(3 * TILE) + 2.0      # no sample is zero
    s = _stage(x, 0, K)
    span = TILE + K - 1
    assert s.size % 4 == 0 and s.size - span >= 7
    assert not np.any(s[:K - 1]) and not np.any(s[span:])
    np.testing.assert_array_equal(s[K - 1:span], x[:TILE])
    s1 = _stage(x, TILE, K)                       # a later tile's halo
    np.testing.assert_array_equal(s1[:span], x[TILE - (K - 1):2 * TILE])
    taps = rng.standard_normal(K)
    rt = _reversed_taps(taps)
    assert rt.size % 4 == 0 and rt.size - K < 4 and not np.any(rt[K:])
    np.testing.assert_array_equal(rt[:K], taps[::-1])


@pytest.mark.parametrize("K", KS)
def test_each_group_reads_its_samples_in_fir_point_order(K):
    """Output ``j0 + i`` takes its products at d = K - 1, K - 2, ..., 0
    (``fir_point``'s order: the top group ``emax + 1`` of them, with
    ``emax = K - 1 - 4 * ((K - 1) >> 2)``) from staged position
    ``j0 + i + d``, inside the span; the loads stay inside the stage."""
    rng = np.random.default_rng(K + 1)
    s = _stage(rng.standard_normal(2 * TILE), TILE, K)
    rt = _reversed_taps(rng.standard_normal(K))
    j0 = POINTS * np.arange(THREADS)
    log = []
    _fir4(s, rt, K, j0, log)
    assert [d for _, d, _ in log] == list(range(K - 1, -1, -1))
    top = K - 4 * ((K - 1) >> 2)          # emax + 1
    assert 1 <= top <= 4
    assert sum(g == (K - 1) >> 2 for g, _, _ in log) == top
    for _, d, pos in log:
        np.testing.assert_array_equal(
            pos, j0[:, None] + np.arange(4) + d)
        assert pos.max() < TILE + K - 1


@pytest.mark.parametrize("r", [0, 1, 2, 3])
@pytest.mark.parametrize("K", KS)
def test_fir_plan_matches_plain(K, r):
    """Kernel A's plan over two channels of 2348 + r samples (two whole
    tiles and one cut short; nt % 4 == r) equals ``fir_plain``."""
    rng = np.random.default_rng(10 * K + r)
    nt = 2 * TILE + 300 + r
    x = rng.standard_normal((2, nt))
    taps = rng.standard_normal(K) / np.sqrt(K)
    got, writes = _emulate_fir(x, taps)
    assert np.all(writes == 1)
    ref = pfir.fir_plain(torch.from_numpy(x), taps).numpy()
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("nt,K", [(1, 1), (3, 1024), (6, 5), (1023, 129),
                                  (1025, 128), (TILE, 1024)])
def test_fir_plan_short_signals(nt, K):
    """Signals shorter than a tile or than the halo, and one sample past
    a tile."""
    rng = np.random.default_rng(nt + K)
    x = rng.standard_normal((1, nt))
    taps = rng.standard_normal(K)
    got, writes = _emulate_fir(x, taps)
    assert np.all(writes == 1)
    ref = pfir.fir_plain(torch.from_numpy(x), taps).numpy()
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("extra_rows,sub", [(12, True), (-5, False),
                                            (0, True)])
@pytest.mark.parametrize("K", KS)
def test_fir_t_plan_matches_plain(K, extra_rows, sub):
    """Kernel I's plan for three signals of 20 rows of 128 (two and a half
    tiles) into ``20 + extra_rows`` rows, with and without ``sub``, equals
    ``fir_transpose_plain``; the rows past the signal are exact zeros."""
    rng = np.random.default_rng(100 + K + extra_rows)
    nr = 20
    nt, C = nr * LANES, 3
    x = rng.standard_normal(nt) + 0.5
    y = rng.standard_normal((C - 1, nt))
    taps = rng.standard_normal(K) / np.sqrt(K)
    nrows_out = nr + extra_rows
    sub_row = rng.standard_normal(C * LANES) if sub else None
    got, writes = _emulate_fir_t(x, y, taps, nrows_out, sub_row)
    assert np.all(writes == 1)
    ref = pfir.fir_transpose_plain(
        torch.from_numpy(x), torch.from_numpy(y), taps, nrows_out,
        None if sub_row is None else torch.from_numpy(sub_row)[None]).numpy()
    assert _rel(got, ref) <= 1e-12
    if extra_rows > 0:
        assert not np.any(got[nr:])
