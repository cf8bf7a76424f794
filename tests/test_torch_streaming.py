"""StreamingWelch of pyfft_tpu_torch against the JAX package's.

The same seeded blocks go through ``pyfft_tpu.streaming.StreamingWelch``
(JAX in x64, tests/conftest.py) and the port's (on the CPU, float64).
Tolerances, as max |port - JAX| / max |JAX| per output:

- one- and two-sided, detrend mean and none, ``'xla'`` and ``'pallas'``
  (kernel B's plain version, ``welch_plain``, on CPU tensors): 1e-9;
- checkpoints crossing between the packages: 1e-12;
- coherence and phase, ratios of the spectra: 100 times the spectra's;
- the port's own split invariance: 1e-10; checkpoint and resume: bit for
  bit;
- float32 blocks with DC offsets 100x the noise (the card's dtype, the
  ADC case): 2e-5 against JAX on the same values in float64, where the
  raw float32 sums of the JAX formulation miss by more (the control).
"""
import numpy as np
import pytest
import torch

from pyfft_tpu.streaming import StreamingWelch as JaxStreamingWelch
from pyfft_tpu import fft_pwelch as jax_fft_pwelch

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import streaming as pstream
from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.ops import welch as pw
from pyfft_tpu_torch.streaming import StreamingWelch

FS, N, NCH, NW = 1.0e4, 1 << 14, 3, 512
TOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _signals(offset=0.0, seed=7, n=N):
    """A line at 313 Hz under 0.1 noise; channel k lags by 0.4 (k + 1) rad
    and sits at ``offset * (k + 2)``, the reference at ``offset``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = np.sin(2 * np.pi * 313.0 * t) + 0.1 * rng.standard_normal(n) + offset
    y = np.stack([0.5 * np.sin(2 * np.pi * 313.0 * t - 0.4 * (k + 1))
                  + 0.1 * rng.standard_normal(n) + offset * (k + 2)
                  for k in range(NCH)])
    return x, y


def _iq(n=N):
    rng = np.random.default_rng(9)
    t = np.arange(n) / FS
    z = (np.exp(1j * (2 * np.pi * (-1200.0) * t + 0.4))
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    w = np.stack([c * np.exp(1j * (2 * np.pi * (-1200.0) * t - 0.5 * k))
                  + 0.05 * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
                  for k, c in enumerate((0.7, 0.3, 1.1))])
    return z, w


def _splits(sizes, n=N):
    out, i = [], 0
    for s in sizes:
        out.append(slice(i, min(i + s, n)))
        i += s
        if i >= n:
            break
    if i < n:
        out.append(slice(i, n))
    return out


def _stream(cls, x, y, blocks, **kw):
    sw = cls(nwins=NW, fs=FS, nch=y.shape[0], windowoverlap=0.5, **kw)
    for sl in blocks:
        sw.push(x[sl], y[:, sl])
    return sw


def _err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() \
        / np.abs(np.asarray(want)).max()


def _assert_close(got, want, tol):
    """The spectra within ``tol``; coherence and phase, ratios of them,
    within 100 ``tol``."""
    assert got.Navr == want.Navr and got.nseen == want.nseen
    np.testing.assert_allclose(got.freq, want.freq, rtol=1e-12)
    for name in ("Pxx", "Pyy", "Pxy", "Cxy2", "phi_xy"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.shape(g) == np.shape(w), name
        if name == "phi_xy":
            # where the cross power is above its floor
            keep = np.abs(want.Pxy) > 1e-6 * np.abs(want.Pxy).max()
            g, w = g[keep], w[keep]
        lim = tol if name.startswith("P") else 100 * tol
        assert _err(g, w) <= lim, (name, _err(g, w))


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("detrend", ["mean", "none"])
@pytest.mark.parametrize("onesided", [True, False])
def test_matches_jax_streaming(backend, detrend, onesided):
    """One- and two-sided streams, detrend mean and none, torch.fft and
    the 'pallas' route (kernel B's plain version on the CPU): the port's
    result equals the JAX package's to 1e-9 of max, per output."""
    x, y = _signals(offset=0.7) if onesided else _iq()
    blocks = _splits([3000] * 6)
    kw = dict(detrend=detrend, onesided=onesided)
    want = _stream(JaxStreamingWelch, x, y, blocks, **kw).result()
    got = _stream(StreamingWelch, x, y, blocks, fft_backend=backend,
                  **kw).result()
    _assert_close(got, want, TOL)


@pytest.mark.parametrize("onesided", [True, False])
def test_matches_batch_fft_pwelch(onesided):
    """Streamed == the JAX package's batch fft_pwelch on the same span
    (sub-span tbounds, so no reflect-extension), as
    tests/test_streaming.py aligns them."""
    x, y = _signals(offset=0.7) if onesided else _iq()
    t = np.arange(N) / FS
    xs, ys = x[1:N - 1], y[:, 1:N - 1]
    sw = StreamingWelch(nwins=NW, fs=FS, nch=NCH, windowoverlap=0.5,
                        onesided=onesided)
    for sl in _splits([4096] * 4, n=xs.size):
        sw.push(xs[sl], ys[:, sl])
    res = sw.result()
    freq, Pxy, Pxx, Pyy, _, _, info = jax_fft_pwelch(
        t, x, y.T, tbounds=[t[1], t[-2]], windowoverlap=0.5,
        windowfunction="hanning", plotit=False, verbose=False,
        detrend_style=1, tper=NW / FS)
    assert res.Navr == info.Navr
    np.testing.assert_allclose(res.freq, freq, rtol=1e-12)
    assert _err(res.Pxx, np.real(Pxx)) <= TOL
    assert _err(res.Pyy, np.real(Pyy).T) <= TOL
    assert _err(res.Pxy, Pxy.T) <= TOL


def test_split_invariance():
    """Any block partition gives the same sums (associativity)."""
    x, y = _signals(offset=0.7)
    a = _stream(StreamingWelch, x, y, _splits([N])).result()
    for sizes in ([1000] * 40, [NW // 2] * 200, [1] * 7 + [2000] * 10):
        r = _stream(StreamingWelch, x, y, _splits(sizes)).result()
        assert r.Navr == a.Navr
        for name in ("Pxx", "Pyy", "Pxy"):
            np.testing.assert_allclose(getattr(r, name), getattr(a, name),
                                       rtol=1e-10, atol=1e-15)


@pytest.mark.parametrize("onesided", [True, False])
def test_checkpoint_resume_bit_identical(tmp_path, onesided):
    x, y = _signals(offset=0.7) if onesided else _iq()
    blocks = _splits([1500] * 12)
    kw = dict(onesided=onesided, fft_backend="pallas")
    full = _stream(StreamingWelch, x, y, blocks, **kw)
    half = _stream(StreamingWelch, x, y, blocks[:6], **kw)
    p = half.checkpoint(str(tmp_path / "welch_ckpt.npz"))
    resumed = StreamingWelch.restore(p, fft_backend="pallas")
    assert resumed.device == torch.device("cpu")
    for sl in blocks[6:]:
        resumed.push(x[sl], y[:, sl])
    a, b = full.result(), resumed.result()
    assert a.Navr == b.Navr
    for name in ("Pxx", "Pyy", "Pxy"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("onesided", [True, False])
def test_checkpoints_cross_between_packages(tmp_path, writer, onesided):
    """A checkpoint written by one package restores in the other, with the
    same keys and dtypes, and the resumed stream ends within 1e-12 of an
    uninterrupted JAX stream."""
    x, y = _signals(offset=0.7) if onesided else _iq()
    blocks = _splits([2500] * 7)
    first, second = (JaxStreamingWelch, StreamingWelch)
    if writer == "port":
        first, second = second, first
    half = _stream(first, x, y, blocks[:3], onesided=onesided)
    p = half.checkpoint(str(tmp_path / "c.npz"))
    with np.load(p) as z:
        dtypes = {k: z[k].dtype for k in z.files}
    want_dtypes = {"Sxx": np.float64, "Syy": np.float64,
                   "Sxy": np.complex128, "Ax": np.complex128,
                   "Ay": np.complex128}
    real = np.float64 if onesided else np.complex128
    want_dtypes.update(sum_x=real, sum_y=real, _carry_x=real,
                       _carry_y=real)
    for k, dt in want_dtypes.items():
        assert dtypes[k] == dt, k
    resumed = second.restore(p)
    for sl in blocks[3:]:
        resumed.push(x[sl], y[:, sl])
    want = _stream(JaxStreamingWelch, x, y, blocks,
                   onesided=onesided).result()
    _assert_close(resumed.result(), want, 1e-12)


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_dc_offsets_100x_noise_match_jax(backend):
    """Offsets 100 and more times the noise (the int16 DAQ case): the
    centred block sums give the JAX package's result to 1e-9 in
    float64."""
    x, y = _signals(offset=10.0)
    blocks = _splits([2048 + 77] * 8)
    want = _stream(JaxStreamingWelch, x, y, blocks).result()
    got = _stream(StreamingWelch, x, y, blocks,
                  fft_backend=backend).result()
    _assert_close(got, want, TOL)


def _raw_float32_sums(x32, y32, blocks):
    """The JAX formulation in float32: the raw block's powers summed in
    float32 (``welch_plain`` without detrend), the linear sums and the
    post-hoc detrend in float64."""
    sw = StreamingWelch(nwins=NW, fs=FS, nch=NCH, windowoverlap=0.5)
    win = sw.win
    for sl in blocks:
        xb, yb = torch.as_tensor(x32[sl]), torch.as_tensor(y32[:, sl])
        sw.sum_x += xb.double().sum()
        sw.sum_y += yb.double().sum(-1)
        sw.nseen += xb.numel()
        xc = torch.cat([sw._carry_x.float(), xb])
        yc = torch.cat([sw._carry_y.float(), yb], 1)
        navr = 0 if xc.numel() < NW else 1 + (xc.numel() - NW) // sw.hop
        if navr:
            Pxx, Pyy, Pre, Pim = pw.welch_plain(
                xc, yc, win, sw.nfreq, 1.0, navr=navr, nwins=NW, hop=sw.hop,
                detrend_style=0)
            L = pstream._linear_sums(torch.cat([xc[None], yc]),
                                     torch.as_tensor(win), navr=navr,
                                     nwins=NW, hop=sw.hop, nfreq=sw.nfreq,
                                     onesided=True)
            sw.navr += navr
            sw.Sxx += Pxx.double()
            sw.Syy += Pyy.double()
            sw.Sxy += torch.complex(Pre.double(), Pim.double())
            sw.Ax += L[0]
            sw.Ay += L[1:]
        sw._carry_x = xc[navr * sw.hop:].double()
        sw._carry_y = yc[:, navr * sw.hop:].double()
    return sw.result()


def test_float32_blocks_with_dc_offsets():
    """float32 blocks (what the loader gives and the kernels take) with
    offsets of 100 to 400 times the noise: the port's centred sums hold
    2e-5 of JAX on the same values in float64; the raw float32 sums of
    the JAX formulation miss it (the control)."""
    x, y = _signals(offset=10.0)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    blocks = _splits([4096] * 4)
    want = _stream(JaxStreamingWelch, x32.astype(np.float64),
                   y32.astype(np.float64), blocks).result()
    got = _stream(StreamingWelch, x32, y32, blocks,
                  fft_backend="pallas").result()
    for name in ("Pxx", "Pyy", "Pxy"):
        assert _err(getattr(got, name), getattr(want, name)) <= 2e-5, name
    raw = _raw_float32_sums(x32, y32, blocks)
    assert max(_err(getattr(raw, n), getattr(want, n))
               for n in ("Pxx", "Pyy", "Pxy")) > 2e-5


def test_tensor_blocks_and_int_input():
    """Tensors are accepted as blocks, and integer input computes in
    float64, as the JAX package casts it."""
    x, y = _signals(offset=0.7)
    blocks = _splits([5000] * 4)
    want = _stream(JaxStreamingWelch, x, y, blocks).result()
    got = _stream(StreamingWelch, torch.as_tensor(x), torch.as_tensor(y),
                  blocks).result()
    _assert_close(got, want, TOL)
    xi = np.round(100 * x).astype(np.int16)
    yi = np.round(100 * y).astype(np.int16)
    want = _stream(JaxStreamingWelch, xi, yi, blocks).result()
    got = _stream(StreamingWelch, xi, yi, blocks).result()
    _assert_close(got, want, TOL)


def test_pallas_route_is_kernel_b_plain_on_cpu(monkeypatch):
    """On CPU tensors the 'pallas' route of a kernel-B geometry runs kernel
    B's plain version (``welch._run`` -> ``welch_plain``), once a push with
    a segment, in float64; a push with no segment runs nothing."""
    calls = []
    real_plain = pw.welch_plain

    def spy(x, y, *a, **kw):
        calls.append((x.dtype, kw["navr"]))
        return real_plain(x, y, *a, **kw)
    monkeypatch.setattr(pw, "welch_plain", spy)
    x, y = _signals(offset=0.7)
    sw = StreamingWelch(nwins=NW, fs=FS, nch=NCH, fft_backend="pallas")
    assert sw._route(3, False) == "B"
    assert sw.push(x[:100], y[:, :100]) == 0
    assert calls == []
    assert sw.push(x[100:2000], y[:, 100:2000]) == 6
    assert calls == [(torch.float64, 6)]


def test_non_power_of_two_takes_the_named_route():
    """nwins 1000 is outside kernel B: the route is kernel E's (its plain
    version in float64 on CPU tensors), as ``pallas_route`` names it, and
    the result is the JAX package's."""
    x, y = _signals(offset=0.7)
    blocks = _splits([3333] * 5)
    sw = StreamingWelch(nwins=1000, fs=FS, nch=NCH, fft_backend="pallas")
    assert sw._route(4, False) == pt.spectral.pallas_route(
        nwins=1000, noverlap=500, navr=4, nnyquist=500, onesided=True,
        detrend_style=0, ntmodel=False, is_cplx=False, nch=NCH) == "E"
    for sl in blocks:
        sw.push(x[sl], y[:, sl])
    want = JaxStreamingWelch(nwins=1000, fs=FS, nch=NCH)
    for sl in blocks:
        want.push(x[sl], y[:, sl])
    _assert_close(sw.result(), want.result(), TOL)


def test_parseval():
    x, y = _signals(offset=0.7)
    res = _stream(StreamingWelch, x, y, _splits([4096] * 4)).result()
    df = res.freq[1] - res.freq[0]
    assert abs(np.sum(res.Pxx) * df - np.var(x)) < 0.02 * np.var(x)


def test_errors():
    with pytest.raises(ValueError, match="linear"):
        StreamingWelch(nwins=64, detrend="linear")
    sw = StreamingWelch(nwins=64, nch=2)
    with pytest.raises(ValueError, match="shape"):
        sw.push(np.zeros(100), np.zeros((3, 100)))
    with pytest.raises(ValueError, match="shape"):
        sw.push(np.zeros(100))
    with pytest.raises(ValueError, match="onesided=False"):
        sw.push(np.zeros(100, complex), np.zeros((2, 100), complex))
    with pytest.raises(ValueError, match="segment"):
        sw.result()


def test_device_rule():
    """Without ``device=`` and without a package default the estimator
    lives on the card, and raises where there is none."""
    from pyfft_tpu_torch import config
    prev = config.set_default_device(None)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device"):
                StreamingWelch(nwins=64)
        assert StreamingWelch(nwins=64, device="cpu").Sxx.device.type == "cpu"
    finally:
        config.set_default_device(prev)
