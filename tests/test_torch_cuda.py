"""Kernels A to I on a CUDA card against their plain versions.

Runs only where there is a card (each test skips elsewhere, deciding in
the ``cuda_device`` fixture).  It imports neither JAX nor the JAX package,
so it runs on a machine without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

Each plain version runs in float64 on the card, so the bounds are the
kernels' float32 error alone.
"""
import numpy as np
import pytest
import torch

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import entry as pe
from pyfft_tpu_torch import segmentation as pseg
from pyfft_tpu_torch import spectral as psp
from pyfft_tpu_torch.hilbert import _analytic_factored, envelope_phase
from pyfft_tpu_torch.ops import fir as pfir
from pyfft_tpu_torch.ops import hilbert as phk
from pyfft_tpu_torch.ops import probe as pprobe
from pyfft_tpu_torch.ops import stft as pst
from pyfft_tpu_torch.ops import welch as pw
from pyfft_tpu_torch.ops import welch_v1 as pv
from pyfft_tpu_torch.utils import profiling as pprof


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,K", [
    (3, 100003, 1), (9, 1 << 20, 129), (2, 5000, 1024),
    (2, 4097, 2),        # nt % 4 == 1: the row's last group stored by floats
    (3, 3070, 3),        # nt % 4 == 2, K % 4 == 3 (the top group's emax 2)
    (1, 10001, 5),       # emax 0: the top group holds one tap
    (4, 65539, 127),     # nt % 4 == 3
    (2, 2050, 128),      # K % 4 == 0, a tile cut short after two samples
    (1, 7, 1024),        # the signal shorter than the halo
])
def test_fir_kernel_matches_plain_on_card(cuda_device, nch, nt, K):
    """Kernel A vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 1e-5 (float32 accumulation of K products)."""
    rng = np.random.default_rng(K)
    x = torch.as_tensor(rng.standard_normal((nch, nt)), dtype=torch.float32,
                        device=cuda_device)
    taps = rng.standard_normal(K)
    before = pfir.LAUNCHES
    got = pfir.fir_pallas(x, taps)
    assert pfir.LAUNCHES == before + 1
    ref = pfir.fir_plain(x.double(), taps)
    err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nr,K", [(8, 2000, 129), (2, 300, 1),
                                      (3, 97, 1024), (0, 64, 6)])
def test_fir_and_fir_t_kernels_agree_bit_for_bit_on_card(cuda_device, nch,
                                                          nr, K):
    """Kernels A and I run one loop (fir.cuh::fir4) on one staging plan:
    kernel I without ``sub``, de-interleaved, is kernel A's output bit for
    bit on the same signals."""
    rng = np.random.default_rng(nr + K)
    nt, C = 128 * nr, nch + 1
    sig = torch.as_tensor(rng.standard_normal((C, nt)), dtype=torch.float32,
                          device=cuda_device)
    taps = rng.standard_normal(K) / K
    a = pfir.fir_cuda(sig, taps)
    i = pfir.fir_t_cuda(sig[0].contiguous(), sig[1:], taps, nr)
    i = i.reshape(nr, C, 128).permute(1, 0, 2).reshape(C, nt)
    assert torch.equal(a, i)


def _welch_complex_sizes():
    """Complex cases at every power of two 16..16384: an odd navr (5 or 7),
    three channels up to 4096 and one above, no taps at even log2 N, 33 at
    odd, detrend at all but 2048."""
    out = []
    for logn in range(4, 15):
        n = 1 << logn
        navr = 5 if logn % 2 else 7
        out.append((3 if n <= 4096 else 1, n + (n // 2) * (navr - 1) + 3, n,
                    n // 2, 33 if logn % 2 else 0, int(logn != 11), True))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,nwins,hop,ntaps,detrend,cplx", [
    (3, 1 << 15, 2048, 1024, 129, 1, False),
    (0, 1 << 15, 2048, 1024, 0, 1, False),
    (20, 1 << 14, 1024, 200, 63, 0, False),
    (1, 1 << 14, 16, 7, 5, 1, False),
    (2, 1 << 16, 16384, 8192, 1024, 1, False),
    (2, 1 << 14, 512, 256, 97, 1, True),
    (2, 5000, 16, 1, 1024, 1, False),            # N 16, hop 1, K 1024
    (1, 1 << 14, 2048, 1, 33, 1, False),         # hop 1 at N 2048
    (3, 1 << 16, 16384, 4096, 1024, 0, False),   # no ring, K 1024
    (0, 5 << 14, 16384, 16384, 129, 1, False),   # no ring, nch 0, lone
    (8, 1 << 15, 2048, 1024, 129, 1, False),     # x filtered ahead
    (8, 2048 + 128 * 200, 2048, 128, 129, 1, False),  # ahead, the v2 hop
    (8, 1 << 16, 16384, 8192, 129, 1, False),    # ahead, no ring
    *_welch_complex_sizes(),
    (0, 4096 + 16 * 8, 4096, 16, 129, 1, True),  # nch 0, navr 9: lone
    (20, 1 << 13, 512, 256, 33, 0, True),        # nch 20
    (1, 16 + 40, 16, 1, 5, 1, True),             # hop 1, navr 41
    (2, 1024 + 60, 1024, 1, 1, 1, True),         # hop 1, no taps
    (1, 1 << 16, 16384, 16384, 1024, 1, True),   # A then B, K 1024
    (0, 5 << 14, 16384, 16384, 1, 0, True),      # A then B, nch 0, lone
    (3, 3 << 14, 16384, 8192, 129, 1, True),     # A then B, 5 segments
])
def test_welch_kernel_matches_plain_on_card(cuda_device, nch, nt, nwins, hop,
                                            ntaps, detrend, cplx):
    """Kernel B vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 2e-5 per output (float32 FFT, float64 sums).  Real signals
    take csrc/welch_pair.cu (counted by ``LAUNCHES``), complex ones
    csrc/welch.cu (``COMPLEX_LAUNCHES``)."""
    rng = np.random.default_rng(nt + nch)
    dt = torch.complex64 if cplx else torch.float32
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((nch, nt))
    if cplx:
        x = x + 1j * rng.standard_normal(nt)
        y = y + 1j * rng.standard_normal((nch, nt))
    xt = torch.as_tensor(x, dtype=dt, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dt, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    nf = nwins if cplx else nwins // 2
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps,
              detrend_style=detrend)
    before = pw.LAUNCHES, pw.COMPLEX_LAUNCHES
    got = pw.welch_cuda(xt, yt, win, nf, 1.0 / navr, **kw)
    assert (pw.LAUNCHES, pw.COMPLEX_LAUNCHES) == (
        before[0] + (not cplx), before[1] + cplx)
    wide = torch.complex128 if cplx else torch.float64
    ref = pw.welch_plain(xt.to(wide), yt.to(wide), win, nf, 1.0 / navr, **kw)
    for g, r in zip(got, ref):
        if r.numel():
            err = ((g.double() - r).abs().max() / r.abs().max()).item()
            assert err <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [0, 129])
@pytest.mark.parametrize("x_scale", [1.0, 1e-3, 1e-6])
def test_welch_kernel_holds_each_channel_to_its_own_max_on_card(
        cuda_device, x_scale, ntaps):
    """Channels at 1, 1/10, 1/1000 and 1/10^6 of their coherent part's
    amplitude beside a reference at ``x_scale`` (1: the reference loud;
    1e-6: the reverse, the first channel 10^6 times louder than x): each
    output of each channel (Pyy, and Pxy as a complex row) and Pxx within
    2e-5 of its own max |ref| (each sequence of a transform is scaled by its
    own power of two)."""
    rng = np.random.default_rng(31 + ntaps)
    nt, nwins, hop = 1 << 16, 2048, 1024
    x = rng.standard_normal(nt) + 0.2
    y = 0.5 * x + rng.standard_normal((4, nt))
    y /= np.array([1.0, 1e1, 1e3, 1e6])[:, None]
    x *= x_scale
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps, detrend_style=1)
    got = pw.welch_cuda(xt, yt, win, nwins // 2 + 1, 1.0 / navr, **kw)
    ref = pw.welch_plain(xt.double(), yt.double(), win, nwins // 2 + 1,
                         1.0 / navr, **kw)

    def err(g, r):
        return ((g.to(r.dtype) - r).abs().max() / r.abs().max()).item()

    assert err(got[0], ref[0]) <= 2e-5
    for c in range(4):
        assert err(got[1][c], ref[1][c]) <= 2e-5
        assert err(torch.complex(got[2][c], got[3][c]),
                   torch.complex(ref[2][c], ref[3][c])) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [0, 129])
@pytest.mark.parametrize("nwins", [4096, 16384])
def test_welch_complex_kernel_holds_each_channel_to_its_own_max_on_card(
        cuda_device, nwins, ntaps):
    """Complex channels at 1, 1/10, 1/1000 and 1/10^6 of their coherent
    part's amplitude beside a complex reference: each output of each
    channel (Pyy, and Pxy as a complex row) and Pxx within 2e-5 of its own
    max |ref| (a complex sequence fills its transform alone)."""
    rng = np.random.default_rng(37 + ntaps)
    nt, hop = 8 * nwins, nwins // 2
    x = rng.standard_normal(nt) + 1j * rng.standard_normal(nt) + 0.2
    y = 0.5 * x + (rng.standard_normal((4, nt))
                   + 1j * rng.standard_normal((4, nt)))
    y /= np.array([1.0, 1e1, 1e3, 1e6])[:, None]
    xt = torch.as_tensor(x, dtype=torch.complex64, device=cuda_device)
    yt = torch.as_tensor(y, dtype=torch.complex64, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps, detrend_style=1)
    got = pw.welch_cuda(xt, yt, win, nwins, 1.0 / navr, **kw)
    ref = pw.welch_plain(xt.to(torch.complex128), yt.to(torch.complex128),
                         win, nwins, 1.0 / navr, **kw)

    def err(g, r):
        return ((g.to(r.dtype) - r).abs().max() / r.abs().max()).item()

    assert err(got[0], ref[0]) <= 2e-5
    for c in range(4):
        assert err(got[1][c], ref[1][c]) <= 2e-5
        assert err(torch.complex(got[2][c], got[3][c]),
                   torch.complex(ref[2][c], ref[3][c])) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,nwins,hop,ntaps", [
    (8, 1 << 16, 2048, 1024, 129), (0, 5 << 12, 4096, 2048, 0),
    (2, 1 << 16, 16384, 8192, 5)])
def test_welch_complex_kernel_repeats_its_bits_on_card(cuda_device, nch, nt,
                                                       nwins, hop, ntaps):
    """The same complex call twice gives the same bits: the sums run in a
    fixed order whatever the order the blocks ran in."""
    rng = np.random.default_rng(nt + nch)
    x = rng.standard_normal(nt) + 1j * rng.standard_normal(nt)
    y = rng.standard_normal((nch, nt)) + 1j * rng.standard_normal((nch, nt))
    xt = torch.as_tensor(x, dtype=torch.complex64, device=cuda_device)
    yt = torch.as_tensor(y, dtype=torch.complex64, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps, detrend_style=1)
    win = np.hanning(nwins + 1)[:-1]
    a = pw.welch_cuda(xt, yt, win, nwins, 1.0 / navr, **kw)
    b = pw.welch_cuda(xt, yt, win, nwins, 1.0 / navr, **kw)
    for g, h in zip(a, b):
        assert torch.equal(g, h)


def _welch_real_fingerprints(device):
    """sha256 (first 16 hex digits) of the float32 outputs of kernel B on
    real signals (config-0-like: 3 channels, nwins 2048, 129 taps; nwins
    16384 without the ring) and of kernel H (auto and pair), on seeded
    inputs."""
    import hashlib
    rng = np.random.default_rng(5)
    nt = 1 << 16
    x = torch.as_tensor(rng.standard_normal(nt) + 0.3, dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(rng.standard_normal((3, nt)), dtype=torch.float32,
                        device=device)
    taps = rng.standard_normal(129) / 129
    out = {}
    for name, ys, nwins, hop, tp, packed in (
            ("b_2048", y, 2048, 1024, taps, False),
            ("b_16384", y, 16384, 8192, taps[:33], False),
            ("h_auto", y[:0], 4096, 2048, None, True),
            ("h_pair", y[:1], 2048, 1024, taps, True)):
        navr = (nt - nwins) // hop + 1
        got = pw.welch_cuda(x, ys, np.hanning(nwins + 1)[:-1],
                            nwins // 2 + 1, 1.0 / navr, navr=navr,
                            nwins=nwins, hop=hop, taps=tp, detrend_style=1,
                            packed=packed)
        h = hashlib.sha256()
        for g in got:
            h.update(g.cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]
    return out


# csrc/welch_pair.cu's outputs before the complex path moved to
# fft_reg.cuh (fir_pair moved to fir.cuh, nothing else changed), on an
# NVIDIA H100 80GB HBM3
_WELCH_REAL_FINGERPRINTS = {"b_2048": "62fb9ad16cf2434a",
                            "b_16384": "a86c36379b267bd9",
                            "h_auto": "82b120c12b0998d5",
                            "h_pair": "0fcb7fceb3ff5bae"}


@pytest.mark.cuda
def test_welch_real_kernel_keeps_its_bits_on_card(cuda_device):
    """Kernel B on real signals and kernel H give the bits they gave before
    the complex path's redesign."""
    assert _welch_real_fingerprints(cuda_device) == _WELCH_REAL_FINGERPRINTS


@pytest.mark.cuda
@pytest.mark.parametrize("nch,ntaps,cplx,packed,engaged", [
    (8, 129, False, False, True),
    (2, 5, False, False, True),
    (1, 129, False, False, False),
    (0, 129, False, False, False),
    (8, 0, False, False, False),
    (8, 129, True, False, False),
    (1, 129, False, True, False),
    (0, 0, False, True, False),
])
def test_welch_filters_x_ahead_once_a_call_on_card(cuda_device, tmp_path, nch,
                                                    ntaps, cplx, packed,
                                                    engaged):
    """A call behind the gate (real, two or more channels, two or more
    taps, not kernel H) filters x once with kernel A: one ``X_PREFILTERS``
    and one kernel A launch a call, none elsewhere.  A traced warm engaged
    call copies nothing from the host and runs kernel A once, inside
    ``welch_cuda.x_filter``."""
    import json
    rng = np.random.default_rng(nch + ntaps)
    nt, nwins, hop = 1 << 15, 2048, 1024
    dt = torch.complex64 if cplx else torch.float32
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((nch, nt))
    if cplx:
        x = x + 1j * rng.standard_normal(nt)
        y = y + 1j * rng.standard_normal((nch, nt))
    xt = torch.as_tensor(x, dtype=dt, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dt, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]

    def call():
        return pw.welch_cuda(xt, yt, win, nwins // 2 + 1, 1.0 / navr,
                             navr=navr, nwins=nwins, hop=hop, taps=taps,
                             detrend_style=1, packed=packed)

    for _ in range(2):
        before = pw.X_PREFILTERS, pfir.LAUNCHES
        call()
        assert (pw.X_PREFILTERS, pfir.LAUNCHES) == (before[0] + engaged,
                                                    before[1] + engaged)
    if not engaged:
        return
    torch.cuda.synchronize()
    with pprof.trace(tmp_path):
        call()
        torch.cuda.synchronize()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    assert not [e["name"] for e in events if e.get("cat") == "gpu_memcpy"
                and "HtoD" in e["name"]]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("fir_kernel" in k for k in kernels) == 1
    assert sum("welch_pair_kernel" in k for k in kernels) == 1
    assert [e["name"] for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "welch_cuda.x_filter"] == ["welch_cuda.x_filter"]


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,K,cplx", [
    (8, 1 << 20, 129, False),     # the resident cell's shape, scaled down
    (3, 100003, 129, False),      # nt % 4096 != 0: a remainder
    (8, 1 << 20, 1, False),       # a single tap
    (3, 70001, 129, True),        # complex64, two parts a signal
    (2, 4097, 2, True),
    (0, 1 << 16, 129, False),     # kernel H: one signal
    (1, 1 << 16, 129, False),     # kernel H: one pair
    (2, 700, 1024, False),        # the tail longer than the signal
])
def test_welch_means_kernel_matches_its_twin_on_card(cuda_device, nch, nt, K,
                                                     cplx):
    """The means kernel (csrc/means.cu) gives its torch twin's operand on
    the same CUDA tensors, equal on these seeded inputs (the same float64
    arithmetic in another order), one launch a call, and within one
    float32 ulp of the moment identity in float64 on the CPU; without
    detrend the operand is zeros and nothing is launched."""
    rng = np.random.default_rng(nt + K)
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((nch, nt)) - 0.2
    dt = torch.float32
    if cplx:
        x = x + 1j * (rng.standard_normal(nt) - 0.1)
        y = y + 1j * (rng.standard_normal((nch, nt)) + 0.4)
        dt = torch.complex64
    xt = torch.as_tensor(x, dtype=dt, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dt, device=cuda_device)
    taps = rng.standard_normal(K) / K
    before = pw.MEANS_LAUNCHES
    got = pw._means(xt, yt, taps, 1, cplx)
    assert pw.MEANS_LAUNCHES == before + 1
    assert torch.equal(got, pw._means_plain(xt, yt, taps, 1, cplx))
    rows = torch.cat([xt[None], yt]).cpu()
    ref = pw._moment_means(rows.to(torch.complex128 if cplx
                                   else torch.float64), taps)
    ref = (torch.view_as_real(ref) if cplx else ref).reshape(-1).numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert (np.abs(got.cpu().numpy() - ref) <= ulp).all()
    zero = pw._means(xt, yt, taps, 0, cplx)
    assert pw.MEANS_LAUNCHES == before + 1
    assert zero.shape == got.shape and not zero.any()


@pytest.mark.cuda
def test_resident_call_enqueues_three_prologue_operations_on_card(
        cuda_device, tmp_path):
    """At the resident cell's geometry (8 channels and x of 2^25 float32
    on the card, 129 taps, nwins 2048, 50% overlap), a warm
    welch_filtered_cross_spectra call takes its means from the means
    kernel once; its prologue launches three device operations (x's and
    y's block sums, the means kernel) and neither the prologue nor the
    launch stage waits on the card; the calls run 8 device operations
    each (kernels, copies and memsets), as the benchmark's
    ``device_ops_per_call`` reads them over a traced stretch of calls.
    An operation counts for the calls whose spans hold its launch (by
    the trace's correlation ids, which an offset between the device's
    and the host's clocks in the trace does not move).  The profiler has
    been seen to leave device operations out of a window that holds one
    call, for no known cause, so a spin kernel and an uncounted call open
    the window, as the benchmark's stretch of calls has no such edge."""
    import json
    nt, nch, ncalls = 1 << 25, 8, 4
    g = torch.Generator(device=cuda_device).manual_seed(30)
    x = torch.randn(nt, generator=g, device=cuda_device) + 0.3
    y = torch.randn((nch, nt), generator=g, device=cuda_device) - 0.2
    taps = np.random.default_rng(30).standard_normal(129) / 129
    plan = pseg.plan_segments(nt, nwins=2048, windowoverlap=0.5)
    win = np.hanning(2048)

    def call():
        return pt.welch_filtered_cross_spectra(x, y, taps, win, plan, 1e6)

    call()
    torch.cuda.synchronize()
    before = pw.MEANS_LAUNCHES
    with pprof.trace(tmp_path):
        torch.cuda._sleep(100000)
        call()
        torch.cuda.synchronize()
        for _ in range(ncalls):
            with torch.profiler.record_function("test.call"):
                call()
    assert pw.MEANS_LAUNCHES == before + 1 + ncalls
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("ph") == "X"]

    def inside(lo, hi, cats):
        return [e for e in events if e.get("cat") in cats
                and lo <= e["ts"] and e["ts"] + e["dur"] <= hi]

    def correlation(e):
        return (e.get("args") or {}).get("correlation")

    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] == "test.call")
    assert len(calls) == ncalls
    launched = {correlation(e) for lo, hi in calls
                for e in inside(lo, hi, ("cuda_runtime", "cuda_driver"))}
    launched.discard(None)
    device = [e["name"] for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and correlation(e) in launched]
    assert len(device) / ncalls == 8, sorted(n[:48] for n in device)
    assert sum("means_kernel" in k for k in device) == ncalls
    assert sum("reduce_kernel" in k for k in device) == 2 * ncalls
    for lo, hi in calls:
        stages = {e["name"]: (e["ts"], e["ts"] + e["dur"])
                  for e in inside(lo, hi, ("user_annotation",))}
        prologue, launch = (
            [e["name"] for e in inside(*stages[name],
                                       ("cuda_runtime", "cuda_driver"))]
            for name in ("welch_cuda.prologue", "welch_cuda.launch"))
        assert sum("Launch" in n for n in prologue) == 3, prologue
        assert not [n for n in prologue + launch
                    if "Synchronize" in n or "Memcpy" in n]


def _stft_sizes():
    """Every power of two 16..16384 with half-overlapping segments, real:
    an odd navr (5) at even log2 N, an even one (6) at odd log2 N."""
    out = []
    for logn in range(4, 15):
        n = 1 << logn
        navr = 5 if logn % 2 == 0 else 6
        out.append((2 if n < 4096 else 1, n + (n // 2) * (navr - 1) + 3, n,
                    n // 2, False, 1))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("nsig,nt,nwins,hop,cplx,detrend", [
    (1, 1 << 15, 2048, 1024, False, 1),
    (9, 5000, 16, 7, False, 0),
    (9, 1 << 16, 2048, 2048, True, 1),
    (1, (1 << 16) + 3, 16384, 1024, True, 0),
    (1, 1 << 17, 16384, 16384, False, 1),
    (9, 3001, 16, 16, True, 1),
    (1, 777, 16, 7, True, 0),
    *_stft_sizes(),
    (3, 4096 + 5, 4096, 4096, False, 1),          # navr = 1, alone
    (1, 4096 + 5, 4096, 4096, True, 1),           # navr = 1, complex
    (1, 1024 + 40, 1024, 1, False, 1),            # hop 1, navr 41
    (2, 512 * 10 + 7, 512, 512, False, 0),        # hop = N, navr 10
    (9, (1 << 15) + 500, 2048, 1024, False, 1),   # nsig 9 real, navr 31
])
def test_stft_kernel_matches_plain_on_card(cuda_device, nsig, nt, nwins, hop,
                                           cplx, detrend):
    """Kernel C vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 2e-5 (float32 Stockham FFT, two real segments per complex
    transform)."""
    rng = np.random.default_rng(nt + nsig)
    dt = torch.complex64 if cplx else torch.float32
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((nsig - 1, nt)) - 0.1
    if cplx:
        x = x + 1j * (rng.standard_normal(nt) + 0.2)
        y = y + 1j * rng.standard_normal((nsig - 1, nt))
    xt = torch.as_tensor(x, dtype=dt, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dt, device=cuda_device)
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=detrend)
    before = pst.LAUNCHES
    got = pst.stft_cuda(xt, yt if nsig > 1 else None, win, 0.5, **kw)
    torch.cuda.synchronize()
    assert pst.LAUNCHES == before + 1
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (nsig, navr, nwins)
    wide = torch.complex128 if cplx else torch.float64
    ref = pst.stft_plain(xt.to(wide), yt.to(wide), win, 0.5, **kw)
    err = ((got.to(torch.complex128) - ref).abs().max()
           / ref.abs().max()).item()
    assert err <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ratio,detrend", [(10, 1), (1000, 1), (1e6, 0)])
def test_stft_kernel_bursty_pairs_hold_per_segment_on_card(cuda_device,
                                                           ratio, detrend):
    """Odd segments with 1/ratio of their neighbours' amplitude share a
    complex FFT with them: each segment is held to 2e-5 of its own max
    |ref|, whatever the ratio (each is scaled by its own power of two).
    At 1:10^6 the global mean would swamp the quiet segments, so that case
    runs without detrend."""
    rng = np.random.default_rng(23)
    nwins, navr = 1024, 63
    x = rng.standard_normal(nwins * navr)
    x[np.arange(x.size) // nwins % 2 == 1] /= ratio
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=nwins, detrend_style=detrend)
    got = pst.stft_cuda(xt, None, win, 1.0, **kw).to(torch.complex128)
    ref = pst.stft_plain(xt.double(), None, win, 1.0, **kw)
    err = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
    assert err.max().item() <= 2e-5


@pytest.mark.cuda
def test_stft_kernel_raises_outside_its_domain_on_card(cuda_device):
    x = torch.ones(4096, device=cuda_device)
    win = np.ones(512)
    with pytest.raises(ValueError, match="float32 or complex64"):
        pst.stft_cuda(x.double(), None, win, 1.0, navr=3, nwins=512, hop=256)
    with pytest.raises(ValueError, match="geometry"):
        pst.stft_cuda(x, None, np.ones(500), 1.0, navr=3, nwins=500,
                      hop=250)
    with pytest.raises(ValueError, match="do not fit"):
        pst.stft_cuda(x, None, win, 1.0, navr=30, nwins=512, hop=256)


@pytest.mark.cuda
@pytest.mark.parametrize("cplx", [False, True])
def test_fftanal_default_takes_kernel_c_on_card(cuda_device, cplx):
    """The default backend on the card takes kernel C once per signal and
    agrees with the torch.fft core ('xla') on the same float32 input."""
    rng = np.random.default_rng(4)
    nt, fs = 1 << 16, 1e6
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 97e3 * t) + 0.3 * rng.standard_normal(nt)
    y = np.roll(x, 3) + 0.1 * rng.standard_normal(nt)
    if cplx:
        x = x + 1j * np.roll(x, 11)
        y = y + 1j * np.roll(y, 11)
    dt = np.complex64 if cplx else np.float32
    x, y = x.astype(dt), y.astype(dt)
    kw = dict(tper=1024.5 / fs, windowoverlap=0.5, plotit=False,
              verbose=False)
    before = pst.LAUNCHES
    a = pt.fftanal(t, x, y, **kw)
    a.pwelch()
    assert pst.LAUNCHES == before + 2
    b = pt.fftanal(t, x, y, fft_backend="xla", **kw)
    b.pwelch()
    assert pst.LAUNCHES == before + 2
    for f in ("Xseg", "Yseg", "Xpow", "tseg", "Pxx", "Pyy", "Pxy"):
        u, v = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert np.abs(u - v).max() <= 2e-5 * np.abs(v).max(), f
    plan = pseg.plan_segments(nt, nwins=1024, windowoverlap=0.5)
    out = pt.stft_segments(torch.as_tensor(x, device=cuda_device), t,
                           a.win, plan, fs, onesided=not cplx)
    assert pst.LAUNCHES == before + 3
    assert np.abs(out[2] - a.Xseg).max() <= 2e-5 * np.abs(a.Xseg).max()


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,max_row", [
    (1 << 12, phk.ROW_MAX), (9 << 10, phk.ROW_MAX), (1 << 20, phk.ROW_MAX),
    (1 << 12, 16), (9 << 10, 64), (3 << 16, phk.ROW_DEFAULT),
    (1 << 20, phk.ROW_DEFAULT),
    # one row length for every log2(M) in 4..14, odd n1 among them; below
    # M = 2048 a block takes several rows, and n1 leaves some slots empty
    (5 << 4, phk.ROW_MAX), (5 << 5, phk.ROW_MAX), (7 << 6, phk.ROW_MAX),
    (3 << 7, phk.ROW_MAX), (9 << 8, phk.ROW_MAX), (1023 << 9, phk.ROW_MAX),
    (33 << 10, phk.ROW_MAX), (129 << 11, phk.ROW_MAX),
    (3 << 12, phk.ROW_MAX), (2047 << 13, phk.ROW_MAX),
    (5 << 14, phk.ROW_MAX)])
def test_hilbert_kernel_matches_plain_on_card(cuda_device, nfft, max_row):
    """Kernel D vs its plain version in complex128 on the card, on the
    outer spectrum's rows of a random float32 signal: max |diff| / max |ref|
    <= 1e-5 (float32 register-radix FFTs of up to 16384 points, float32
    twiddles from float64).  Then the whole chain against a complex128
    torch.fft analytic signal, same bound."""
    rng = np.random.default_rng(nfft + max_row)
    x = torch.as_tensor(rng.standard_normal(nfft), dtype=torch.float32,
                        device=cuda_device)
    n1, M = phk.row_split(nfft, max_row)
    A = torch.fft.fft(x.reshape(n1, M), dim=0).contiguous()
    before = phk.LAUNCHES
    got = phk.hilbert_cuda(A)
    torch.cuda.synchronize()
    assert phk.LAUNCHES == before + 1
    assert got.dtype == torch.complex64 and got.shape == A.shape
    ref = phk.hilbert_plain(A.to(torch.complex128))
    err = ((got.to(torch.complex128) - ref).abs().max()
           / ref.abs().max()).item()
    assert err <= 1e-5
    z = _analytic_factored(x, split=(n1, M))
    xd = x.double()
    h = torch.zeros(nfft, dtype=torch.float64, device=cuda_device)
    h[0] = h[nfft // 2] = 1.0
    h[1:nfft // 2] = 2.0
    zref = torch.fft.ifft(torch.fft.fft(xd) * h)
    err = ((z.to(torch.complex128) - zref).abs().max()
           / zref.abs().max()).item()
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n1,M", [(130, 16), (3, 1024), (2047, 8192),
                                  (5, 16384)])
def test_hilbert_kernel_repeats_its_bits_on_card(cuda_device, n1, M):
    """Two launches on the same rows give the same bits: every output has
    one thread and a fixed order of operations."""
    rng = np.random.default_rng(n1 + M)
    A = torch.as_tensor(rng.standard_normal((n1, M))
                        + 1j * rng.standard_normal((n1, M)),
                        dtype=torch.complex64, device=cuda_device)
    before = phk.LAUNCHES
    a = phk.hilbert_cuda(A)
    b = phk.hilbert_cuda(A)
    torch.cuda.synchronize()
    assert phk.LAUNCHES == before + 2
    assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))


@pytest.mark.cuda
def test_hilbert_kernel_raises_outside_its_domain_on_card(cuda_device):
    A = torch.zeros(4, 16, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError, match="complex64"):
        phk.hilbert_cuda(A.to(torch.complex128))
    with pytest.raises(ValueError, match="unsupported"):
        phk.hilbert_cuda(torch.zeros(4, 24, dtype=torch.complex64,
                                     device=cuda_device))
    with pytest.raises(ValueError, match="unsupported"):
        phk.hilbert_cuda(torch.zeros(1, 1 << 15, dtype=torch.complex64,
                                     device=cuda_device))
    assert phk.blocks_per_sm(16384) >= 1


@pytest.mark.cuda
def test_envelope_phase_takes_kernel_d_once_on_card(cuda_device):
    """A 1-D float32 signal with a row split takes kernel D once and agrees
    with the CPU route (the same chain with the plain version); an N-D
    signal takes torch.fft and launches nothing."""
    nt, fs = 1 << 20, 1e6
    t = np.arange(nt) / fs
    am = ((1 + 0.5 * np.sin(2 * np.pi * 500 * t))
          * np.sin(2 * np.pi * 50e3 * t)).astype(np.float32)
    before = phk.LAUNCHES
    env, ph = envelope_phase(torch.as_tensor(am, device=cuda_device))
    assert phk.LAUNCHES == before + 1
    env0, ph0 = envelope_phase(am, device="cpu")
    assert np.abs(env - env0).max() <= 2e-5 * np.abs(env0).max()
    keep = env0 > 1e-2 * env0.max()
    dphi = np.angle(np.exp(1j * (ph.astype(np.float64) - ph0)))
    assert np.abs(dphi[keep]).max() <= 1e-4
    envs, _ = envelope_phase(torch.as_tensor(np.stack([am, am]),
                                             device=cuda_device))
    assert phk.LAUNCHES == before + 1
    assert np.abs(envs[0] - env0).max() <= 2e-5 * np.abs(env0).max()


@pytest.mark.cuda
def test_blocked_iir_on_card_matches_cpu(cuda_device):
    """The blocked lfilter/filtfilt in float64 on the card against the same
    code on the CPU: rtol 1e-12 (another matmul order only)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1 << 16))
    b, a = pt.filters.butter(4, 0.05)
    got = pt.filters.filtfilt(b, a, torch.as_tensor(x, device=cuda_device))
    want = pt.filters.filtfilt(b, a, x, device="cpu")
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    got = pt.filters.downsample_efficient(x.T, 1e6, 5e4, device=cuda_device)
    want = pt.filters.downsample_efficient(x.T, 1e6, 5e4, device="cpu")
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,nwins,hop,detrend", [
    (3, 60000, 1964, 982, 1),       # the heat-pulse test set's geometry
    (6, 400000, 4871, 2435, 1),     # the full-size heat-pulse geometry
    (2, 1 << 16, 4096, 2048, -1),   # radix-2, linear detrend
    (0, 5000, 301, 150, -1),        # no channels, odd nwins
    (1, 3000, 3, 1, 0),             # shortest Bluestein length
    (4, 20000, 8191, 3000, 1),      # longest (M = 16384)
    (2, 5000, 1, 1, 0),             # one-sample segments
    (0, 400000, 4871, 2435, 1),     # the heat-pulse nwins, no channels
    (5, 400000, 4871, 2435, -1),    # the heat-pulse nwins, odd nch
    (3, 1 << 16, 16, 8, 1),         # the shortest direct transform
    (2, 1 << 16, 8, 3, -1),         # a power of two below 16 (M = 16)
])
def test_welch_dft_kernel_matches_plain_on_card(cuda_device, nch, nt, nwins,
                                                hop, detrend):
    """Kernel E vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 2e-5 per output (float32 Bluestein FFTs of up to 16384
    points, float64 sums)."""
    rng = np.random.default_rng(nt + nwins)
    t = np.arange(nt)
    xt = torch.as_tensor(rng.standard_normal(nt) + 0.3 + 1e-5 * t,
                         dtype=torch.float32, device=cuda_device)
    yt = torch.as_tensor(rng.standard_normal((nch, nt)) - 2e-5 * t,
                         dtype=torch.float32, device=cuda_device)
    navr = (nt - nwins) // hop + 1
    nf = nwins // 2 + 1
    win = np.hanning(nwins + 1)[:-1] if nwins > 1 else np.ones(1)
    kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=detrend)
    before = pv.LAUNCHES
    got = pv.welch_dft_cuda(xt, yt, win, nf, 1.0 / navr, **kw)
    torch.cuda.synchronize()
    assert pv.LAUNCHES == before + 1
    ref = pv.welch_dft_plain(xt.double(), yt.double(), win, nf, 1.0 / navr,
                             **kw)
    # Pxy as one complex array (its imaginary part is 0 for nwins = 1)
    got = (got[0], got[1], torch.complex(got[2], got[3]))
    ref = (ref[0], ref[1], torch.complex(ref[2], ref[3]))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if r.numel():
            err = ((g.to(r.dtype) - r).abs().max() / r.abs().max()).item()
            assert err <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("detrend", [1, -1])
def test_welch_dft_kernel_holds_each_channel_to_its_own_max_on_card(
        cuda_device, detrend):
    """Kernel E at the heat-pulse nwins (M = 8192) with channels at 1, 1/10,
    1/100 and 1/1000 of their coherent part's amplitude: each output of
    each channel (Pyy, and Pxy as a complex row) and Pxx within 2e-5 of
    its own max |ref| (each signal has its own transforms)."""
    rng = np.random.default_rng(47)
    nt, nwins, hop = 120000, 4871, 2435
    x = rng.standard_normal(nt) + 0.2
    y = 0.5 * x + rng.standard_normal((4, nt))
    y /= np.array([1.0, 1e1, 1e2, 1e3])[:, None]
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=cuda_device)
    navr = (nt - nwins) // hop + 1
    nf = nwins // 2 + 1
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=detrend)
    got = pv.welch_dft_cuda(xt, yt, win, nf, 1.0 / navr, **kw)
    ref = pv.welch_dft_plain(xt.double(), yt.double(), win, nf, 1.0 / navr,
                             **kw)

    def err(g, r):
        return ((g.to(r.dtype) - r).abs().max() / r.abs().max()).item()

    assert err(got[0], ref[0]) <= 2e-5
    for c in range(4):
        assert err(got[1][c], ref[1][c]) <= 2e-5
        assert err(torch.complex(got[2][c], got[3][c]),
                   torch.complex(ref[2][c], ref[3][c])) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cap_spectra", [7, 3])
def test_welch_dft_kernel_in_chunks_matches_one_chunk_on_card(
        cuda_device, monkeypatch, cap_spectra):
    """Kernel E with its scratch capped at 7 spectra (every signal in one
    group, one segment a chunk: the sums carried in float64 from chunk to
    chunk) and at 3 (channel groups of two, x transformed again in each):
    within 1e-6 of max of the same call in one chunk (float32 outputs of
    float64 sums added in another order, so at most a rounding apart), and
    one launch counted per call."""
    rng = np.random.default_rng(5)
    nt, nwins, hop, nch = 30000, 1000, 700, 5
    xt = torch.as_tensor(rng.standard_normal(nt) + 0.1,
                         dtype=torch.float32, device=cuda_device)
    yt = torch.as_tensor(rng.standard_normal((nch, nt)),
                         dtype=torch.float32, device=cuda_device)
    navr = (nt - nwins) // hop + 1
    nf = nwins // 2 + 1
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=-1)
    one = pv.welch_dft_cuda(xt, yt, win, nf, 1.0 / navr, **kw)
    monkeypatch.setattr(pv, "SCRATCH_CAP", 8 * nf * cap_spectra)
    assert len(pv._chunks(nch, navr, nf)) >= navr
    before = pv.LAUNCHES
    got = pv.welch_dft_cuda(xt, yt, win, nf, 1.0 / navr, **kw)
    torch.cuda.synchronize()
    assert pv.LAUNCHES == before + 1
    for g, o in zip(got, one):
        assert (g - o).abs().max().item() <= 1e-6 * o.abs().max().item()


@pytest.mark.cuda
def test_welch_dft_kernel_raises_outside_its_domain_on_card(cuda_device):
    x = torch.ones(20000, device=cuda_device)
    y = torch.ones(2, 20000, device=cuda_device)
    kw = dict(navr=3, hop=100, detrend_style=1)
    with pytest.raises(ValueError, match="float32"):
        pv.welch_dft_cuda(x.double(), y.double(), np.ones(300), 151, 1.0,
                          nwins=300, **kw)
    with pytest.raises(ValueError, match="geometry"):
        pv.welch_dft_cuda(x, y, np.ones(8193), 100, 1.0, nwins=8193, **kw)
    with pytest.raises(ValueError, match="geometry"):
        pv.welch_dft_cuda(x, y, np.ones(300), 200, 1.0, nwins=300, **kw)
    with pytest.raises(ValueError, match="do not fit"):
        pv.welch_dft_cuda(x, y, np.ones(300), 151, 1.0, nwins=300,
                          navr=300, hop=100)


@pytest.mark.cuda
def test_fft_pwelch_pallas_takes_kernel_e_on_card(cuda_device):
    """fft_pwelch('pallas') at nwins = 1820 and with linear detrend at a
    radix-2 nwins launches kernel E once (kernel B never) and agrees with
    the torch.fft core on the card."""
    rng = np.random.default_rng(1)
    N = 1 << 13
    t = np.arange(N) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(N)
    y = np.stack([np.sin(2 * np.pi * 97.0 * t - 0.5), 0.3 * t]) \
        + 0.1 * rng.standard_normal((2, N))
    for args in (dict(Navr=8, detrend_style=1),
                 dict(tper=1024.5 / 1e3, detrend_style=-1)):
        kw = dict(tbounds=[t[1], t[-2]], plotit=False, **args)
        b0, e0 = pw.LAUNCHES, pv.LAUNCHES
        P = pt.fft_pwelch(t, x, y, fft_backend="pallas", **kw)
        assert pv.LAUNCHES == e0 + 1 and pw.LAUNCHES == b0
        X = pt.fft_pwelch(t, x, y, fft_backend="xla", **kw)
        for k in (1, 2, 3):
            assert np.abs(P[k] - X[k]).max() <= 2e-5 * np.abs(X[k]).max()


@pytest.mark.cuda
def test_heatpulse_pallas_launches_kernel_e_once_on_card(cuda_device):
    """HeatPulseFFT on its test set on the card: one launch of kernel
    E, none of kernel B; Amp, Phase and Coh agree with the CPU run of the
    same route to 1e-5 (float32 kernel against float32 plain version)."""
    from pyfft_tpu_torch import heatpulse as php
    data = php.synth_heatpulse_data(nch=6, fmod=33.0, fs=16.0e3, T=4.0)
    runinfo = dict(fmod=33.0, harms=np.asarray([1, 2]), intno2per=2,
                   overlap=0.5, winfun="hanning", fwid=8.0,
                   tbounds=np.asarray([0.25, 3.75]), DutyCycle=0.5)
    b0, e0 = pw.LAUNCHES, pv.LAUNCHES
    card = php.HeatPulseFFT(dict(runinfo), dict(data))
    card.PreCheck()
    card.run(fft_backend="pallas")
    assert pv.LAUNCHES == e0 + 1 and pw.LAUNCHES == b0
    cpu = php.HeatPulseFFT(dict(runinfo, device="cpu"), dict(data))
    cpu.PreCheck()
    cpu.run(fft_backend="pallas")
    for f in ("Amp", "Phase", "Coh"):
        u, v = getattr(card, f), getattr(cpu, f)
        assert np.abs(u - v).max() <= 1e-5 * np.abs(v).max(), f


# kernel G against its plain version: 1e-4 of the largest sum on two-tap T,
# whose chain every order of float32 sums computes bit for bit (a chain
# without the bf16 re-rounding misses it by more than 5e-4 at these
# inputs, tests/test_torch_chain_plan.py); on the probe's dense T the tensor
# cores' order rounds about 4e-5 of a pass's elements to the neighbouring
# bf16 value, which 12 passes carry to about 1e-3 (0.9e-3 to 2.7e-3 here)
CHAIN_TOL = 1e-4
CHAIN_ORDER_TOL = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("nrows,N,rows_blk", [(4096, 1152, 512),
                                              (1024, 100, 256),
                                              (2048, 4, 1024),
                                              (1024, 200, 128),
                                              (1024, 1000, 128),
                                              (512, 97, 256)])
def test_probe_kernels_match_plain_on_card(cuda_device, nrows, N, rows_blk):
    """Kernel F vs float32 column sums (1e-5 * max|ref|) and kernel G vs
    its plain version (``CHAIN_TOL`` on two-tap T, ``CHAIN_ORDER_TOL`` on a
    dense T), streamed and resident, over ragged widths (N = 97: G stages
    x with 4-byte copies)."""
    rng = np.random.default_rng(N)
    x = torch.as_tensor(rng.standard_normal((nrows, N)),
                        dtype=torch.float32, device=cuda_device)
    T = torch.as_tensor(rng.standard_normal((128, 128)) / 16.0,
                        device=cuda_device).to(torch.bfloat16)
    if N % 4 == 0:
        c0 = pprobe.LAUNCHES["colsum"]
        got = pprobe.colsum(x, rows_blk)
        torch.cuda.synchronize()
        assert pprobe.LAUNCHES["colsum"] == c0 + 1
        ref = pprobe.colsum_plain(x.double(), rows_blk)
        assert ((got.double() - ref).abs().max()
                / ref.abs().max()).item() <= 1e-5
    else:
        with pytest.raises(ValueError):
            pprobe.colsum(x, rows_blk)
    T2 = pprobe.two_tap_T(N, cuda_device)
    for passes, resident in ((0, False), (1, False), (12, False), (3, True)):
        for Tc, tol in ((T2, CHAIN_TOL), (T, CHAIN_ORDER_TOL)):
            g0 = pprobe.LAUNCHES["chain"]
            got = pprobe.chain(x, Tc, rows_blk, passes, resident)
            torch.cuda.synchronize()
            assert pprobe.LAUNCHES["chain"] == g0 + 1
            ref = pprobe.chain_plain(x, Tc, rows_blk, passes, resident)
            assert got.shape == (1, N)
            assert ((got - ref).abs().max()
                    / ref.abs().max()).item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("N,rows_blk,passes", [(1152, 512, 12),
                                               (200, 128, 1),
                                               (1000, 256, 3)])
def test_chain_resident_equals_streamed_over_one_block_on_card(
        cuda_device, N, rows_blk, passes):
    """Over a single row block the resident and streamed runs read the
    same rows into the same tiles: kernel G's two results agree bit for
    bit (on a dense T, where the order of sums would show)."""
    rng = np.random.default_rng(N + passes)
    x = torch.as_tensor(rng.standard_normal((rows_blk, N)),
                        dtype=torch.float32, device=cuda_device)
    T = torch.as_tensor(rng.standard_normal((128, 128)) / 16.0,
                        device=cuda_device).to(torch.bfloat16)
    streamed = pprobe.chain(x, T, rows_blk, passes, False)
    resident = pprobe.chain(x, T, rows_blk, passes, True)
    assert torch.equal(streamed, resident)
    assert torch.isfinite(streamed).all()


@pytest.mark.cuda
def test_measure_pipeline_overlap_on_card(cuda_device):
    out = pprof.measure_pipeline_overlap(nrows=8192, N=1152, iters=2)
    assert all(np.isfinite(v) and v > 0 for k, v in out.items()
               if k != "overlap_fraction")
    assert out["read_gbs"] <= 1.05 * pprof.device_peaks()[2]


@pytest.mark.cuda
@pytest.mark.parametrize("pair,nt,nwins,hop,ntaps,detrend,nf,amp", [
    (False, 1 << 16, 4096, 2048, 0, 1, 2049, 1.0),     # config 1's geometry
    (False, 1 << 16, 4096, 2048, 129, 1, 2049, 1.0),   # with the band-pass
    (False, 40000, 512, 384, 33, 0, 512, 1.0),         # odd navr, all bins
    (False, 5000, 16, 7, 5, 1, 9, 1.0),                # smallest window
    (False, 1 << 17, 16384, 8192, 1024, 1, 8193, 1.0),  # largest
    (True, 1 << 16, 4096, 2048, 0, 1, 2049, 1.0),
    (True, 1 << 16, 1024, 512, 129, 0, 700, 0.1),      # |y| = |x| / 10
    (True, 30000, 128, 100, 63, 1, 128, 1.0),          # odd hop, all bins
    (True, 1 << 17, 16384, 8192, 0, 1, 8193, 1.0),
])
def test_welch_packed_kernel_matches_plain_on_card(cuda_device, pair, nt,
                                                   nwins, hop, ntaps, detrend,
                                                   nf, amp):
    """Kernel H (csrc/welch_pair.cu, launched as packed) vs its plain
    version (kernel B's, at nch = 0 or 1) in float64 on the card: max
    |diff| / max |ref| <= 2e-5 per output (float32 FFTs of two real
    sequences at once, float64 sums)."""
    rng = np.random.default_rng(nt + nwins + pair)
    xt = torch.as_tensor(rng.standard_normal(nt) + 0.3, dtype=torch.float32,
                         device=cuda_device)
    yt = torch.as_tensor(amp * (rng.standard_normal(nt) - 0.2),
                         dtype=torch.float32, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps,
              detrend_style=detrend)
    ys = yt[None] if pair else xt.new_empty((0, nt))
    before, b0 = pw.PACKED_LAUNCHES, pw.LAUNCHES
    got = pw.welch_cuda(xt, ys, win, nf, 1.0 / navr, packed=True, **kw)
    torch.cuda.synchronize()
    assert pw.PACKED_LAUNCHES == before + 1 and pw.LAUNCHES == b0
    ref = pw.welch_plain(xt.double(), ys.double(), win, nf, 1.0 / navr, **kw)
    if not pair:
        got, ref = got[:1], ref[:1]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = ((g.double() - r).abs().max() / r.abs().max()).item()
        assert err <= 2e-5


@pytest.mark.cuda
def test_welch_pair_packed_holds_a_quiet_channel_on_card(cuda_device):
    """welch_pair_packed on a pair at 1:1000 (y the delayed x plus noise,
    divided by 1000): kernel H launches once and each output, Pyy above
    all, holds 2e-5 of its own max |ref| (before the per-sequence scaling
    the quiet sequence carried the loud one's float32 error)."""
    from pyfft_tpu_torch.ops import welch_packed as pwp
    rng = np.random.default_rng(17)
    nt, nwins, nov = 1 << 18, 1024, 512
    x = rng.standard_normal(nt)
    y = (0.5 * np.roll(x, 5) + rng.standard_normal(nt)) / 1000
    xt = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=cuda_device)
    navr = (nt - nov) // (nwins - nov)
    win = np.hanning(nwins + 1)[:-1]
    nf = nwins // 2 + 1
    h0 = pw.PACKED_LAUNCHES
    got = pwp.welch_pair_packed(xt, yt, win, nf, 1.0 / navr, navr=navr,
                                nwins=nwins, noverlap=nov, detrend_style=1)
    assert pw.PACKED_LAUNCHES == h0 + 1
    ref = pw.welch_plain(xt.double(), yt[None].double(), win, nf, 1.0 / navr,
                         navr=navr, nwins=nwins, hop=nwins - nov,
                         detrend_style=1)
    for g, r in zip(got[:2], ref[:2]):
        assert ((g.double() - r).abs().max() / r.abs().max()).item() <= 2e-5
    gp, rp = torch.complex(got[2], got[3]), torch.complex(ref[2], ref[3])
    assert ((gp.to(rp.dtype) - rp).abs().max() / rp.abs().max()).item() \
        <= 2e-5


@pytest.mark.cuda
def test_pyfft_packed_route_takes_kernel_h_on_card(cuda_device, monkeypatch):
    """welch_cross_spectra('pallas') on one channel with PYFFT_PACKED=1
    launches kernel H once (kernel B never) and agrees with the same call
    without the variable (kernel B): 2e-5 of max per output."""
    rng = np.random.default_rng(5)
    nt, fs = 1 << 18, 1e6
    x = torch.as_tensor(rng.standard_normal(nt), dtype=torch.float32,
                        device=cuda_device)
    y = torch.roll(x, 3) + 0.1 * torch.as_tensor(
        rng.standard_normal(nt), dtype=torch.float32, device=cuda_device)
    plan = pseg.plan_segments(nt, nwins=1024, windowoverlap=0.5)
    win = np.hanning(1025)[:-1]
    b0, h0 = pw.LAUNCHES, pw.PACKED_LAUNCHES
    monkeypatch.setenv("PYFFT_PACKED", "1")
    got = pt.welch_cross_spectra(x, y, win, plan, fs, fft_backend="pallas")
    assert pw.PACKED_LAUNCHES == h0 + 1 and pw.LAUNCHES == b0
    monkeypatch.delenv("PYFFT_PACKED")
    ref = pt.welch_cross_spectra(x, y, win, plan, fs, fft_backend="pallas")
    assert pw.PACKED_LAUNCHES == h0 + 1 and pw.LAUNCHES == b0 + 1
    for k in ("Pxx", "Pyy", "Pxy"):
        assert np.abs(got[k] - ref[k]).max() <= 2e-5 * np.abs(ref[k]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,nwins,noverlap,ntaps", [
    (3, 1 << 16, 2048, 1920, 129),
    (2, 1 << 16, 4096, 3584, 63),
    (1, 1 << 18, 16384, 8192, 0),
])
def test_welch_kernel_at_v2_geometries_on_card(cuda_device, nch, nt, nwins,
                                               noverlap, ntaps):
    """Kernel B at geometries where the JAX package runs its v2 kernel (TPU
    #8: its v2 gate holds there, tests/test_torch_welch_v2.py; the v3 gate
    fails), against its plain version in float64 on the card: 2e-5 per
    output, global-mean detrend."""
    from pyfft_tpu_torch.ops.welch_packed import _v3_geometry
    rng = np.random.default_rng(nwins + ntaps)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    assert _v3_geometry(nwins, noverlap, nch) is None
    xt = torch.as_tensor(rng.standard_normal(nt) + 0.4, dtype=torch.float32,
                         device=cuda_device)
    yt = torch.as_tensor(rng.standard_normal((nch, nt)) - 0.3,
                         dtype=torch.float32, device=cuda_device)
    hop = nwins - noverlap
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    before = pw.LAUNCHES
    got = pw.welch_fir_pallas_fused(xt, yt, win, nwins // 2 + 1, 1.0 / navr,
                                    navr=navr, nwins=nwins, noverlap=noverlap,
                                    taps=taps, detrend_style=1)
    assert pw.LAUNCHES == before + 1
    ref = pw.welch_plain(xt.double(), yt.double(), win, nwins // 2 + 1,
                         1.0 / navr, navr=navr, nwins=nwins, hop=hop,
                         taps=taps, detrend_style=1)
    for g, r in zip(got, ref):
        err = ((g.double() - r).abs().max() / r.abs().max()).item()
        assert err <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,ntaps,extra_rows,sub", [
    (3, 1 << 16, 129, 64, True),     # zero tail, sub_row
    (0, 1 << 14, 33, 0, False),      # one signal (C = 1)
    (2, 128 * 300, 1, 12, False),    # taps = (1.0,): a pure interleave
    (1, 1 << 15, 1024, -64, True),   # fewer rows out than in the signal
])
def test_fir_t_kernel_matches_plain_on_card(cuda_device, nch, nt, ntaps,
                                            extra_rows, sub):
    """Kernel I vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 1e-5 (float32 sums of K products), rows past the signal
    exactly 0."""
    rng = np.random.default_rng(nt + nch)
    taps = np.ones(1) if ntaps == 1 else rng.standard_normal(ntaps) / ntaps
    xt = torch.as_tensor(rng.standard_normal(nt) + 0.5, dtype=torch.float32,
                         device=cuda_device)
    yt = torch.as_tensor(rng.standard_normal((nch, nt)), dtype=torch.float32,
                         device=cuda_device)
    C, nr = nch + 1, nt // 128
    nrows_out = nr + extra_rows
    sub_row = (torch.as_tensor(rng.standard_normal((1, C * 128)),
                               dtype=torch.float32, device=cuda_device)
               if sub else None)
    before = pfir.FIR_T_LAUNCHES
    got = pfir.fir_transpose_pallas(xt, yt, taps, nrows_out, sub_row=sub_row)
    torch.cuda.synchronize()
    assert pfir.FIR_T_LAUNCHES == before + 1
    assert got.shape == (nrows_out, C * 128) and got.dtype == torch.float32
    ref = pfir.fir_transpose_plain(xt.double(), yt.double(), taps, nrows_out,
                                   None if sub_row is None
                                   else sub_row.double())
    err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    assert err <= 1e-5
    if extra_rows > 0:
        assert torch.count_nonzero(got[nr:]).item() == 0


# --------------------------------------------------------------------------- #
# The streaming tier on the card
# --------------------------------------------------------------------------- #

def _stream_blocks(sw, x, y, block):
    for s in range(0, x.shape[-1], block):
        sw.push(x[s:s + block], y[:, s:s + block])
    return sw


def _stream_errs(got, ref):
    return {k: float(np.abs(getattr(got, k) - getattr(ref, k)).max()
                     / np.abs(getattr(ref, k)).max())
            for k in ("Pxx", "Pyy", "Pxy")}


@pytest.mark.cuda
@pytest.mark.parametrize("cplx,nwins,block,offset", [
    (False, 2048, 1 << 16, 0.0), (False, 2048, 50001, 100.0),
    (False, 256, 3000, 300.0), (True, 4096, 1 << 17, 0.0),
    (True, 512, 7777, 100.0)])
def test_streaming_kernel_route_matches_plain_on_card(cuda_device, cplx,
                                                      nwins, block, offset):
    """StreamingWelch with fft_backend='pallas' on the card (kernel B once a
    push with a segment: real blocks in float32 through welch_pair.cu,
    complex ones in complex64 through welch.cu) against the 'xla' route in
    float64 on the card: max |diff| / max |ref| <= 2e-5 per output, also
    with DC offsets 100 and 300 times the noise (the centred sums)."""
    rng = np.random.default_rng(nwins + block)
    nt, nch = 1 << 18, 3
    t = np.arange(nt) / 1e6
    x = np.sin(2 * np.pi * 97e3 * t) + rng.standard_normal(nt) + offset
    y = (0.5 * np.sin(2 * np.pi * 97e3 * t - 0.3)[None]
         + rng.standard_normal((nch, nt)) + offset * np.arange(1, nch + 1)[
             :, None])
    if cplx:
        x = x + 1j * rng.standard_normal(nt)
        y = y + 1j * rng.standard_normal((nch, nt))
    dt = torch.complex64 if cplx else torch.float32
    xt = torch.as_tensor(x, dtype=dt, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dt, device=cuda_device)
    kw = dict(nwins=nwins, fs=1e6, nch=nch, onesided=not cplx,
              device=cuda_device)
    before = pw.LAUNCHES, pw.COMPLEX_LAUNCHES
    sw = _stream_blocks(pt.StreamingWelch(fft_backend="pallas", **kw), xt, yt,
                        block)
    pushes = sum(1 for s in range(0, nt, block))
    assert (pw.LAUNCHES - before[0], pw.COMPLEX_LAUNCHES - before[1]) == (
        (0, pushes) if cplx else (pushes, 0))
    wide = torch.complex128 if cplx else torch.float64
    ref = _stream_blocks(pt.StreamingWelch(fft_backend="xla", **kw),
                         xt.to(wide), yt.to(wide), block)
    for k, e in _stream_errs(sw.result(), ref.result()).items():
        assert e <= 2e-5, (k, e)


@pytest.mark.cuda
def test_streaming_pushes_without_a_segment_launch_nothing_on_card(
        cuda_device):
    """Pushes that complete no segment launch nothing; the push that
    completes the first launches kernel B once."""
    x = torch.randn(2048, device=cuda_device)
    y = torch.randn(2, 2048, device=cuda_device)
    sw = pt.StreamingWelch(nwins=1024, nch=2, fft_backend="pallas",
                           device=cuda_device)
    before = pw.LAUNCHES
    for s in range(0, 1000, 100):
        assert sw.push(x[s:s + 100], y[:, s:s + 100]) == 0
    assert pw.LAUNCHES == before
    assert sw.push(x[1000:2048], y[:, 1000:2048]) == 3
    assert pw.LAUNCHES == before + 1


@pytest.mark.cuda
def test_streaming_non_power_of_two_takes_the_named_route_on_card(
        cuda_device):
    """nwins 1000 is outside kernel B: each push takes the route
    ``pallas_route`` names (kernel E), within 2e-5 of the float64 'xla'
    route on the card."""
    rng = np.random.default_rng(3)
    nt = 1 << 16
    xt = torch.as_tensor(rng.standard_normal(nt) + 5.0, dtype=torch.float32,
                         device=cuda_device)
    yt = torch.as_tensor(rng.standard_normal((2, nt)), dtype=torch.float32,
                         device=cuda_device)
    kw = dict(nwins=1000, nch=2, device=cuda_device)
    sw = pt.StreamingWelch(fft_backend="pallas", **kw)
    assert sw._route(5, False) == "E"
    before = pv.LAUNCHES, pw.LAUNCHES
    _stream_blocks(sw, xt, yt, 8192)
    assert (pv.LAUNCHES - before[0], pw.LAUNCHES - before[1]) == (8, 0)
    ref = _stream_blocks(pt.StreamingWelch(fft_backend="xla", **kw),
                         xt.double(), yt.double(), 8192)
    for k, e in _stream_errs(sw.result(), ref.result()).items():
        assert e <= 2e-5, (k, e)


@pytest.mark.cuda
def test_streaming_checkpoint_resumes_bit_for_bit_on_card(cuda_device,
                                                          tmp_path):
    rng = np.random.default_rng(4)
    nt = 1 << 17
    xt = torch.as_tensor(rng.standard_normal(nt) + 100.0,
                         dtype=torch.float32, device=cuda_device)
    yt = torch.as_tensor(rng.standard_normal((3, nt)), dtype=torch.float32,
                         device=cuda_device)
    kw = dict(nwins=2048, nch=3, fft_backend="pallas", device=cuda_device)
    full = _stream_blocks(pt.StreamingWelch(**kw), xt, yt, 10000)
    half = _stream_blocks(pt.StreamingWelch(**kw), xt[:60000],
                          yt[:, :60000], 10000)
    sw = pt.StreamingWelch.restore(half.checkpoint(str(tmp_path / "c.npz")),
                                   fft_backend="pallas", device=cuda_device)
    _stream_blocks(sw, xt[60000:], yt[:, 60000:], 10000)
    a, b = full.result(), sw.result()
    for k in ("Pxx", "Pyy", "Pxy"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.cuda
def test_stream_welch_from_disk_on_card(cuda_device, tmp_path):
    """An int16 capture with ADC offsets through the native loader and
    ``stream_welch`` on the card (pinned staging, kernel B once a push)
    against the same file on the CPU in float64: 2e-5 per output."""
    rng = np.random.default_rng(5)
    nt, nch, block = 300001, 4, 1 << 15
    t = np.arange(nt) / 1e6
    sig = (2000.0 + 200 * np.arange(nch)
           + 40 * np.sin(2 * np.pi * 97e3 * t)[:, None]
           + 16 * rng.standard_normal((nt, nch)))
    path = tmp_path / "shot.i16"
    path.write_bytes(np.round(sig).astype(np.int16).tobytes())
    before = pw.LAUNCHES
    with pt.ShotLoader(path, nch, "int16") as ld:
        assert ld.native
        got = pt.io.stream_welch(ld, nwins=2048, fs=1e6, block=block,
                                 fft_backend="pallas", device=cuda_device)
        assert pw.LAUNCHES - before == -(-nt // block)
        ref = pt.StreamingWelch(nwins=2048, fs=1e6, nch=nch, device="cpu")
        for blk in ld.stream(block=block):
            blk = blk.astype(np.float64)
            ref.push(blk[0], blk)
    for k, e in _stream_errs(got, ref.result()).items():
        assert e <= 2e-5, (k, e)


@pytest.mark.cuda
def test_multitaper_and_cwt_match_the_cpu_on_card(cuda_device):
    """multitaper_psd (each weighting), multitaper_csd and cwt of float32
    tensors on the card against the CPU float64 path on the same values:
    1e-4 of max."""
    rng = np.random.default_rng(6)
    n = 1 << 15
    x = rng.standard_normal(n).astype(np.float32)
    y = (0.5 * x + rng.standard_normal(n)).astype(np.float32)
    xd = torch.as_tensor(x, device=cuda_device)
    yd = torch.as_tensor(y, device=cuda_device)

    def err(g, r):
        return float(np.abs(g - r).max() / np.abs(r).max())
    for w in ("unity", "eigen", "adaptive"):
        assert err(pt.multitaper_psd(xd, weighting=w)[1],
                   pt.multitaper_psd(x.astype(np.float64), weighting=w,
                                     device="cpu")[1]) <= 1e-4
    got = pt.multitaper_csd(xd, yd)
    ref = pt.multitaper_csd(x.astype(np.float64), y.astype(np.float64),
                            device="cpu")
    for i in (1, 2, 3):
        assert err(got[i], ref[i]) <= 1e-4
    W = pt.wavelet.cwt(xd, dt=1e-6)[0]
    assert err(W, pt.wavelet.cwt(x.astype(np.float64), dt=1e-6,
                                 device="cpu")[0]) <= 1e-4


@pytest.mark.cuda
def test_entry_forward_matches_kernel_b_plain_on_card(cuda_device):
    """entry()'s forward on the card launches kernel B once and is within
    2e-5 of each output's max of kernel B's plain version, in float64 on
    the same tensors, with the same averaging and one-sided scaling."""
    fwd, (x, y) = pe.entry()
    assert x.is_cuda and y.is_cuda
    before = pw.LAUNCHES
    got = fwd(x, y)
    assert pw.LAUNCHES == before + 1
    plan, win, s1sq_enbw = pe.flagship_geometry()
    norm = float(np.float32(1.0 / (s1sq_enbw * plan.navr)))
    ref = pw.welch_plain(x.double(), y.double(), win, plan.nnyquist, norm,
                         navr=plan.navr, nwins=plan.nwins, hop=plan.hop,
                         detrend_style=1)
    sc = torch.as_tensor(psp._onesided_power_scale(plan.nfft, plan.nnyquist),
                         device=x.device)
    ref = (ref[0] * sc, (ref[1] * sc).T, (ref[2] * sc).T, (ref[3] * sc).T)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.shape == r.shape
        assert ((g.double() - r).abs().max() / r.abs().max()).item() <= 2e-5


@pytest.mark.cuda
def test_dryrun_multichip_one_rank_on_card(cuda_device):
    """dryrun_multichip(1) on a one-rank NCCL group it starts and destroys:
    every stage passes, launching kernels A, B (real and complex), C and
    E."""
    import torch.distributed as dist
    before = (pfir.LAUNCHES, pw.LAUNCHES, pw.COMPLEX_LAUNCHES, pst.LAUNCHES,
              pv.LAUNCHES)
    line = pe.dryrun_multichip(1)
    after = (pfir.LAUNCHES, pw.LAUNCHES, pw.COMPLEX_LAUNCHES, pst.LAUNCHES,
             pv.LAUNCHES)
    assert line.startswith("dryrun_multichip OK: mesh=(1x1)")
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_resident_chain_marks_its_stages_on_card(cuda_device, tmp_path):
    """A profiled call of welch_filtered_cross_spectra on signals already on
    the card, after a warm call: the call's range holds its arguments,
    kernel B's prologue and launch (which holds the filter of x ahead) and
    the finalization, in that order, and the finalization the one copy
    back (the result block); the call launches kernel B once and copies
    nothing from the host."""
    import json
    rng = np.random.default_rng(21)
    nt, nch = 1 << 20, 8
    x = torch.as_tensor(rng.standard_normal(nt), dtype=torch.float32,
                        device=cuda_device)
    y = torch.as_tensor(rng.standard_normal((nch, nt)), dtype=torch.float32,
                        device=cuda_device)
    taps = rng.standard_normal(129) / 129
    plan = pseg.plan_segments(nt, nwins=2048, windowoverlap=0.5)
    win = np.hanning(2048)

    def call():
        return pt.welch_filtered_cross_spectra(x, y, taps, win, plan, 1e6)

    call()
    torch.cuda.synchronize()
    before = pw.LAUNCHES
    with pprof.trace(tmp_path):
        out = call()
    assert pw.LAUNCHES == before + 1
    assert out["Pxy"].shape == (plan.nnyquist, nch)
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"),
                   key=lambda s: (s[1], -s[2]))
    copies = [s for s in spans if s[0] == "copy.d2h"]
    stages = [s for s in spans if s[0] != "copy.d2h"]
    outer = "welch_filtered_cross_spectra"
    assert [s[0] for s in stages] == [
        outer, f"{outer}.args", "welch_cuda.prologue", "welch_cuda.launch",
        "welch_cuda.x_filter", f"{outer}.finalize"]
    (_, lo, hi), *inner = stages
    assert all(lo <= s <= e <= hi for _, s, e in inner)
    (_, llo, lhi), (_, xlo, xhi) = stages[3:5]
    assert llo <= xlo <= xhi <= lhi
    _, flo, fhi = stages[-1]
    assert len(copies) == 1
    assert all(flo <= s <= e <= fhi for _, s, e in copies)
    assert not [e["name"] for e in events if e.get("cat") == "gpu_memcpy"
                and "HtoD" in e["name"]]
