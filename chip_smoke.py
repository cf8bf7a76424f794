"""Smoke test of pyfft_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyfft_tpu_torch/csrc`` with ``nvcc``,
holds each against its plain PyTorch version at the shapes of the main
paths, then drives the main paths.  Kernel A (the causal FIR) is held
against its plain version first, on 9 signals of 2**25 samples at 129 and
1024 taps and on 9 of 2**24 at 129 (phase 2: timed 25 times beside
``conv1d``, traced once, with ptxas' registers and spills); it runs on its
own main path inside phase 4.  The paths:

- the fused FIR -> Welch cross-spectral chain at the size of bench
  configurations 0 and 5: 8 channels of 2**25 float32 samples at fs = 1 MHz
  with a 129-tap band-pass and nwins = 2048, and 8 channels of 2**24
  samples with nwins = 4096 through ``fft_pwelch`` (phases 4-5), after
  kernel B (``csrc/welch_pair.cu`` for real signals) against its plain
  version at both sizes, each channel also held to its own max with the
  channels 10 and 1000 times quieter than the reference, and one config-0
  call traced under ``torch.profiler`` (phase 3);
- the STFT path through the ``fftanal`` class at the size of bench
  configuration 2, a 2**24-sample chirp with nwins = 2048 and 50% overlap,
  and a two-signal ``fftanal`` with nwins = 4096 (phases 7-8), after
  kernel C against its plain version in five cases (phase 6: config 2,
  complex, nine signals, an odd segment count, and segments of alternating
  amplitude, 1:10 to 1:1000, held per segment), each with its plain
  version (and at config
  2 ``torch.stft``) timed 25 times and one call of each traced under
  ``torch.profiler``;
- the Hilbert demodulation path through ``hilbert_mod.envelope_phase`` at
  the size of bench configuration 4, a 2**24-sample AM signal at fs = 1 MHz
  (phase 10), after kernel D against its plain version in five cases
  (phase 9: each timed and traced, beside the four-step chain and the same
  analytic signal through whole-length cuFFT, with the occupancy and
  ptxas' report for every row length); then a
  light drive of the analysis tier on the card (``downsample_efficient``
  of 8 channels of 2**22 samples, the blocked IIR; the synthetic Doppler
  chain through ``fftanal``), held against the CPU route;
- the heat-pulse transport analysis, ``HeatPulseFFT(...).run(fft_backend=
  'pallas')``, on a 10 s programme of 32 ECE channels at 40 kHz (phase
  12), after kernel E against its plain version (phase 11): nwins 4871,
  not a power of two, so kernel E takes the Welch stage (Bluestein on
  8192-point FFTs); phase 11 holds E at that geometry (timed 25 times,
  traced, with its occupancy and ptxas' report), with linear detrend at
  nwins 4096, through the pre-framed entry at nwins 2047, with four
  channels at 1:1 to 1:1000 each held to its own max, and at nwins 3;
- the profiling tier: kernels F and G against their plain versions (G on
  the probe's inputs and on a two-tap T whose chain does not depend on the
  order of float32 sums, each with a control that leaves out the bf16
  re-rounding; the share of one pass's elements where G and its plain
  version round apart; G timed beside the same chain as 12 cuBLAS bf16
  matmuls and traced once), then
  ``utils.profiling.measure_pipeline_overlap`` at its default size
  (phase 13);
- bench configuration 1, the single-signal PSD of a 2**24-sample signal
  with nwins = 4096 and 50% overlap, through ``ops.welch_auto_packed``
  (kernel H, kernel B's real kernel for one signal: two segments per
  complex FFT), timed
  against kernel B at nch = 0 and the plain version over 25 runs each and
  traced once under ``torch.profiler`` (phase 14); then the ``PYFFT_PACKED=1``
  route of ``welch_cross_spectra`` on one real pair (kernel H in its pair
  mode, phase 15);
- kernel B at two geometries where the JAX package runs its v2 kernel
  (phase 16: nwins 2048 every 128 samples with the 129-tap band-pass,
  through ``welch_filtered_cross_spectra``; nwins 16384, 50% overlap);
- the FIR-transpose feeder ``ops.fir_transpose_pallas`` (kernel I) on the
  config-0 signals into the interleaved layout with a zero tail (phase
  17), after kernel I against its plain version (timed 25 times, traced
  once) and against kernel A: without ``sub`` and de-interleaved, its
  output must be kernel A's bit for bit;
- the Doppler IQ path, ``fft_pwelch(..., fft_backend='pallas')`` on a
  complex reference and 8 complex channels of 2**24 samples at 1 MHz
  sharing a tone at -37 kHz, each channel lagging the reference by a known
  phase (phase 19: two-sided line, coherence and cross-phase, against the
  ``'xla'`` route), after kernel B on complex signals (``csrc/welch.cu``)
  against its plain version on those signals at nwins 4096 (each channel
  also at 1:10 and 1:1000 of the reference) and at nwins 2048 with the
  129-tap band-pass (phase 18: timed 10 times, traced once, with the
  occupancy and ptxas' report at nwins 2048 and 4096);
- the streaming tier: the Doppler IQ signals pushed through
  ``StreamingWelch(nwins=4096, onesided=False, fft_backend='pallas')`` in
  blocks of 2**20 over phase 19's span (kernel B on complex signals once a
  push), against phase 19's batch result (phase 20); config 0 streamed
  from disk: 8 interleaved int16 channels of 2**25 samples (512 MiB; a
  shared tone at 97 kHz with a known lag per channel, unit noise, DC
  offsets 100 to 275 times the noise) written to a temporary file, read
  by ``ShotLoader``'s C++ reader and ``stream_welch(..., block=2**18,
  fft_backend='pallas')`` on the card (kernel B on real signals once a
  push), against the batch ``fft_pwelch(..., 'pallas')`` over the same
  span, with the wall split by step and one push traced (phase 21); a
  checkpoint at half that stream, restored and finished, against the
  uninterrupted result bit for bit (phase 22); ``multitaper_psd``
  (adaptive) and ``multitaper_csd`` of 2**20 samples and the ``cwt`` of a
  2**18-sample chirp, against the port's CPU float64 path (phase 23);
- the mesh tier (``pyfft_tpu_torch.parallel``) on a one-rank NCCL group
  started by ``parallel.init_distributed()``, a 1 x 1 mesh (phases 24-28):
  ``fft_pwelch(..., mesh=..., fft_backend='pallas')`` at config 5 (kernel
  B) and on Doppler IQ signals of 9 x 2**22 (kernel B on complex
  signals), ``stft_sharded`` on config 2's chirp (kernel C),
  ``fir_filter_sharded`` on config 0's channels with the 129-tap
  band-pass (kernel A) and the lazy per-segment fill of a mesh
  ``fft_pwelch`` at 2**20 samples (kernel C), each against the
  single-device path on the card, with the collectives it issued
  (``parallel.audit_collectives``' rows), its wall split by step and a
  check that no operation touched a tensor off the card;
- the mesh tier's FFT half on the same group (phases 29-31, the same
  records beside the card's ``nvidia-smi`` name and power limit): the
  four-step ``fft_sharded`` on 2**24 complex64 samples and on 8 x 2**22
  real ones against ``torch.fft.fft`` (and complex128), ``ifft_sharded``
  back, ``rfft_sharded``/``irfft_sharded`` at 2**24 (phase 29); the
  distributed Bluestein at N = 10**7, M = 2**25, against a complex128
  ``torch.fft.fft`` (phase 30); ``envelope_phase(..., mesh=...)`` on
  config 4's AM signal against the single-device call (phase 31).  This
  path launches no kernel of the port;
- the top-level entry points (``pyfft_tpu_torch.entry``), last on the same
  group: ``entry()``'s forward step (kernel B on 4 channels of 2**15,
  nwins 1024), timed 25 times and traced once, against kernel B's plain
  version on the same tensors (phase 32); ``dryrun_multichip(1)``, every
  stage of the JAX dry run on its own shapes against the single-device
  pipeline, launching kernels A, B (real and complex), C and E, with the
  collectives it issued and a check that no operation touched a tensor
  off the card (phase 33).

Every phase prints one JSON line.  Then come the kernels' line
(``{"kernels": [...]}``, launches counted over the main-path phases only:
each path runs with the counts set to 0 just before it and read just
after; each kernel's ``bound_ms`` from ``utils.profiling.bound_ms`` with
the card's book peaks, and ``library_ms`` the time of one PyTorch call
that computes the same function, where there is one), the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises: the exit code is then non-zero and no
``ok`` line is printed.  There is no CPU fallback: without a CUDA device
the script exits with code 2.

Float32 convolutions and matmuls run in full float32 (both TF32 flags are
set to False), so the plain versions are float32 references computed by
cuDNN/cuFFT, on the same inputs as the kernels.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

FS = 1e6
NCH = 8
SEED = 0
FIR_TOL = 1e-5      # kernel A: max |kernel - plain| / max |plain|
WELCH_TOL = 2e-5    # kernels B and H: the same, per output
FIR_T_TOL = 1e-5    # kernel I: the same
PARSEVAL_TOL = 0.01  # config 1: |sum(Pxx) df / var(x) - 1|
LAG_PHASE_TOL = 1e-2  # the pair route: cross-phase at the line vs the lag
LAG = 3             # the pair route: y is x delayed by LAG samples
IQ_F0 = -37e3       # the Doppler IQ signals: a tone at a negative frequency
STFT_TOL = 2e-5     # kernel C: the same, per case
HILB_TOL = 1e-5     # kernel D: the same, on its rows and on the analytic signal
PHASE_TOL = 1e-4    # config 4: wrapped phase (rad) where env > 1e-2 max
ENV_TOL = 1e-3      # config 4: |envelope - (1 + 0.5 sin)| away from the edges
IIR_TOL = 1e-12     # blocked IIR: card vs CPU, float64, relative to max
DOPPLER_TOL = 1e-4  # Doppler chain: kernel C (float32) vs CPU (float64)
DFT_TOL = 2e-5      # kernel E: max |kernel - plain| / max |plain|, per output
COLSUM_TOL = 1e-5   # kernel F: the same (float32 sums in another order)
# kernel G: the same, where the chain does not depend on the order of its
# float32 sums (``probe.two_tap_T``) and on the probe's inputs at one
# pass; a chain without the bf16 re-rounding between passes misses the
# plain version by more than 1e-3 on either and must fail it (the controls)
CHAIN_TOL = 1e-4
# kernel G on the probe's dense T over many passes: the tensor cores add
# their products in another order than the plain version's float32 loop,
# which rounds about 4e-5 of each pass's elements to the neighbouring bf16
# value, and the chain carries them on (1.1e-3 streamed and 2.4e-3
# resident at 65536 x 1152 and 12 passes on an H100): any float32 order
# other than the plain version's lands there
CHAIN_ORDER_TOL = 5e-3
# heat-pulse run, kernel route (float32) vs 'xla' (float64): |dAmp| (log
# amplitude), |dPhase| (rad), |dCoh|; kernel E's 2e-5 of the largest power
# is up to 4e-4 of the outermost channel's (5% of it)
HP_TOL = 1e-4
TAU_DAMP = 0.05     # the outermost of 32 channels at exp(-31*0.05) = 0.21
STREAM_BLOCK = 1 << 18  # the streamed capture: frames a block of stream_welch
STREAM_LSB = 16     # the streamed capture: int16 counts per unit of noise
STREAM_TONE = 2.0   # the streamed capture: the tone's amplitude (noise units)
DC_TOL = 1e-3       # the streamed capture: bins 0-2, streamed vs batch, over
                    # the noise floor (the median of Pyy)
MT_TOL = 1e-4       # multitaper, cwt: card (float32) vs CPU (float64)
MESH_FFT_TOL = 2e-5  # the four-step (complex64) vs torch.fft, share of max
BLUESTEIN_TOL = 1e-4  # Bluestein at M = 2**25 in complex64 vs complex128
MESH_ENV_TOL = 2e-5  # envelope over the mesh vs one card, share of max
HP_RUNINFO = dict(  # tests/test_heatpulse.py's RUNINFO over a 10 s programme
    fmod=33.0, harms=[1, 2], intno2per=2, overlap=0.5, winfun="hanning",
    fwid=8.0, tbounds=[0.25, 9.75], DutyCycle=0.5, usesegs=False, igch=None,
    plotit=False, verbose=False, saveit=False, useMLAB=False, savedir=".",
    sfilename="hp", vmcfil="", xpname="synth")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, ref):
    """max |got - ref| / max |ref| in float64 (complex allowed)."""
    import torch
    got = torch.as_tensor(got).to(torch.complex128)
    ref = torch.as_tensor(ref).to(torch.complex128)
    scale = ref.abs().max().item()
    return (got.to(ref.device) - ref).abs().max().item() / scale, scale


def chain_unrounded(x, T, rows_blk, passes):
    """Kernel G's chain without the bf16 re-rounding between passes (float32
    throughout after ``bf16(x)``), streamed: the control that ``CHAIN_TOL``
    must fail."""
    import torch
    y = x.reshape(-1, 128, x.shape[1]).to(torch.bfloat16).float()
    Tf = T.float()
    for _ in range(passes):
        y = torch.matmul(Tf, y)
    return y.sum(dim=(0, 1)).reshape(1, -1)


def ptxas_report(kernel, named=False):
    """ptxas' lines (registers, spills, stack) for the kernels whose names
    hold ``kernel``, from the build's ``build.log``; with ``named``, a dict
    from each kernel's (mangled) name to its lines."""
    from pyfft_tpu_torch.ops import _build
    out, keep = {}, None
    for line in (_build.build().parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            keep = (line.split("'")[1] if "'" in line else line) \
                if kernel in line else None
        elif keep and ("registers" in line or "spill" in line):
            out.setdefault(keep, []).append(
                " ".join(line.replace("ptxas info    :", "").split()))
    return out if named else [v for lines in out.values() for v in lines]


def chain_flip_share(T, ncols, seed):
    """Share of the bf16 elements of one pass, ``bf16(T @ bf16(x))`` with x
    (128, ncols), where kernel G and its plain version differ.  Row i alone
    comes out of a launch with every other row of T zero: the column sums
    of one group then hold that row's values exactly."""
    import numpy as np
    import torch
    from pyfft_tpu_torch.ops import probe
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (128, ncols)), dtype=torch.float32, device=T.device)
    flips = 0
    for i in range(128):
        Ti = torch.zeros_like(T)
        Ti[i] = T[i]
        got = probe.chain_cuda(x, Ti, 128, 1)
        flips += int((got != probe.chain_plain(x, Ti, 128, 1)).sum().item())
    return flips / (128 * ncols)


def cublas_chain(x, T, passes):
    """The chain as ``passes`` bf16 ``torch.matmul`` calls (cuBLAS, bf16
    out, float32 accumulation), then the float32 column sums: the
    yardstick of kernel G, never called by the port."""
    import torch
    y = x.reshape(-1, 128, x.shape[1]).to(torch.bfloat16)
    for _ in range(passes):
        y = torch.matmul(T, y)
    return y.float().sum(dim=(0, 1)).reshape(1, -1)


def time_runs(fn, reps=5):
    """`reps` timed runs after one warm-up, by CUDA events (ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, reps=5):
    """Median of `reps` timed runs after one warm-up, by CUDA events."""
    return statistics.median(time_runs(fn, reps))


def time_host(fn, reps=3):
    """Median seconds of ``reps`` calls of ``fn`` after one warm-up, by the
    host clock to a synchronize (calls that end on the host)."""
    import torch
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs)


def trace_call(fn, kernel, windows=3):
    """One call of ``fn`` under ``torch.profiler``: its wall (ms, host clock
    to a synchronize), the device's busy time and idle share, the device
    time and the recorded launches of the kernels whose names hold
    ``kernel``, the count of pageable
    host -> device copies, and the top device and host entries (host: the
    operators' own CPU time).  A spin kernel opens each window and is
    left out of the record.  The profiler has left device operations out
    of a window on an H100, for no cause known yet: in one window of
    phase 14 it recorded only the last of the four that kernel H's call
    launched, and with the spin kernel it recorded the spin and still
    left out kernel H's prologue (its block sum and the means kernel), so
    a window's busy time can read low.  A window in which the profiler
    recorded no device activity at all (it happened on an H100 to one call
    of phase 14 that launched six device operations) is traced again, up
    to ``windows`` in all; ``trace_windows`` counts them."""
    import torch
    from pyfft_tpu_torch.utils import profiling
    cuda_t = torch.autograd.DeviceType.CUDA
    opener = "spin_kernel"
    for window in range(1, windows + 1):
        with tempfile.TemporaryDirectory() as logdir, \
                profiling.trace(logdir) as tr:
            torch.cuda._sleep(100000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev_ms, host_ms, pageable, launches = {}, {}, 0, 0
        for e in tr.key_averages():
            if getattr(e, "is_user_annotation", False):
                continue
            if e.device_type != cuda_t:
                host_ms[e.key] = e.self_cpu_time_total / 1e3
                continue
            if opener in e.key:
                continue
            dev_ms[e.key] = e.self_device_time_total / 1e3
            if kernel in e.key:
                launches += e.count
            if "HtoD" in e.key and "Pageable" in e.key:
                pageable += e.count
        busy = sum(dev_ms.values())
        if busy > 0:
            break

    def top(ms):
        return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:6])
    return dict(wall_ms=wall, device_busy_ms=busy,
                device_idle_share=1 - busy / wall,
                kernel_ms=sum(v for k, v in dev_ms.items() if kernel in k),
                kernel_launches=launches, h2d_pageable=pageable,
                host_ms=sum(host_ms.values()), trace_windows=window,
                top_device_ms=top(dev_ms), top_host_ms=top(host_ms))


def trace_launches(fn, kernel, calls=5):
    """The device time a launch of the kernels whose names hold ``kernel``
    over ``calls`` calls of ``fn`` traced under ``torch.profiler``, and
    :func:`trace_call`'s record.  The profiler recorded no launch of a
    window that held one call alone on an H100: a torch operation opens
    the window, the calls follow, and the time is taken per launch it
    recorded."""
    import torch

    def run():
        torch.zeros(1, device="cuda").add_(1.0)
        for _ in range(calls):
            fn()
    tr = trace_call(run, kernel)
    return tr["kernel_ms"] / max(tr["kernel_launches"], 1), tr


def channel_errs(got, ref):
    """Per channel of Welch outputs ``(Pxx, Pyy, Pxy_re, Pxy_im)``: max
    |got - ref| / max |ref| of ``Pyy`` and of ``Pxy`` (complex) over each
    channel's bins, and of ``Pxx``."""
    import torch
    gxy = torch.complex(got[2], got[3]).to(torch.complex128)
    rxy = torch.complex(ref[2], ref[3]).to(torch.complex128).to(gxy.device)

    def per(g, r):
        r = r.to(g.device)
        return ((g - r).abs().amax(-1) / r.abs().amax(-1)).tolist()
    return {"Pxx": [per(got[0].double(), ref[0].double())],
            "Pyy": per(got[1].double(), ref[1].double()),
            "Pxy": per(gxy, rxy)}


def seg_rel_err(got, ref):
    """Per segment of ``(nsig, navr, nwins)`` spectra: max |got - ref| over
    the segment's bins / max |ref| over them; the largest over segments."""
    ref = ref.to(got.device)
    err = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
    return float(err.max().item())


def smi_query(fields):
    """``nvidia-smi --query-gpu=<fields>`` of card 0, as one string."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def signals(nt, dev):
    """bench.py's signals: a 97 kHz sine plus 0.3 noise, and channels
    tile(x) + 0.1 noise, seeded with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    t = (np.arange(nt) / FS).astype(np.float32)
    x = (np.sin(2 * np.pi * 97e3 * t)
         + 0.3 * rng.standard_normal(nt)).astype(np.float32)
    y = (np.tile(x, (NCH, 1))
         + 0.1 * rng.standard_normal((NCH, nt))).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def iq_phases():
    """The lag of each IQ channel behind the reference (rad)."""
    import numpy as np
    return 0.3 + 0.7 * np.arange(NCH)


def iq_signals(nt, dev):
    """The Doppler IQ signals: a complex64 reference x (nt,) and NCH
    channels y (NCH, nt) at FS, each the tone exp(2 pi i IQ_F0 t) under
    independent complex noise of unit power, channel c lagging x by
    ``iq_phases()[c]``; made on the card from SEED."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    t = torch.arange(nt, device=dev, dtype=torch.float64) / FS
    tone = torch.polar(torch.ones_like(t), 2 * np.pi * IQ_F0 * t)
    lag = torch.polar(torch.ones(NCH, dtype=torch.float64, device=dev),
                      -torch.as_tensor(iq_phases(), device=dev))
    x = (tone + torch.randn(nt, dtype=torch.complex128, device=dev,
                            generator=gen)).to(torch.complex64)
    y = torch.empty((NCH, nt), dtype=torch.complex64, device=dev)
    for c in range(NCH):
        y[c] = tone * lag[c] + torch.randn(nt, dtype=torch.complex128,
                                           device=dev, generator=gen)
    return x, y


def chirp(nt):
    """bench.py's config-2 chirp: f_inst from 1 kHz to 200 kHz over nt
    samples at FS, as float32 (NumPy), with f_inst."""
    import numpy as np
    f_inst = 1e3 + (200e3 - 1e3) * np.arange(nt) / nt
    return (np.sin(2 * np.pi * np.cumsum(f_inst) / FS)
            .astype(np.float32)), f_inst


def stft_split(x, tvec, plan, win):
    """Wall time of ``stft_segments``' kernel route on ``x`` (NumPy),
    split into its steps: host gates, host -> device copy, kernel C with
    its means prologue, the float64 device epilogue, device -> host copy
    and the host epilogue.  Returns (seconds by step, (tt, X, pseg))."""
    import numpy as np
    import torch
    from pyfft_tpu_torch import segmentation as seg
    from pyfft_tpu_torch.fftanal import (_pallas_epilogue, _pallas_spectra,
                                         _uniform)
    from pyfft_tpu_torch.ops.stft import stft_applicable
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    tv = np.asarray(tvec, dtype=np.float64)
    dt = (tv[-1] - tv[0]) / (len(tv) - 1)
    s1, s2 = seg.get_s1(win), seg.get_s2(win)
    # fftanal's __Fs__, so that the scaling is bit-identical
    enbw = seg.get_enbw((len(tv) - 1) / (tv[-1] - tv[0]), s1, s2)
    check(stft_applicable(plan.nwins, plan.noverlap) and _uniform(tv, dt),
          "kernel route gates")
    t1 = time.perf_counter()
    xt = torch.as_tensor(x, device="cuda")
    sync()
    t2 = time.perf_counter()
    X = _pallas_spectra(xt, win, plan, 1)
    sync()
    t3 = time.perf_counter()
    Xs, pseg = _pallas_epilogue(xt, X, win, dt, s1, s2, enbw, plan,
                                onesided=True, detrend_style=1)
    sync()
    t4 = time.perf_counter()
    Xh, ph = Xs.cpu().numpy(), pseg.cpu().numpy()
    t5 = time.perf_counter()
    starts = plan.starts()
    cs = np.concatenate([[0.0], np.cumsum(tv)])
    tt = (cs[starts + plan.nwins] - cs[starts]) / plan.nwins
    t6 = time.perf_counter()
    steps = {"host_gates": t1 - t0, "h2d": t2 - t1, "kernel": t3 - t2,
             "device_epilogue": t4 - t3, "d2h": t5 - t4,
             "host_epilogue": t6 - t5, "total": t6 - t0}
    return steps, (tt, Xh, ph)


def am_signal(nt):
    """bench.py's config-4 AM signal (``bench.py:331-332``), built on a
    float64 time base and cast to float32 (a float32 time base is coarser
    than 1 us past 8 s).  Returns (am, envelope, t)."""
    import numpy as np
    t = np.arange(nt) / FS
    env = 1 + 0.5 * np.sin(2 * np.pi * 500 * t)
    return (env * np.sin(2 * np.pi * 50e3 * t)).astype(np.float32), env, t


def fft_analytic(x, h):
    """The analytic signal of ``x`` through one whole-length ``torch.fft``
    pair with the mask ``h``: the yardstick of kernel D's four-step chain,
    never called by the port."""
    import torch
    return torch.fft.ifft(torch.fft.fft(x) * h)


def hilbert_split(am):
    """Wall time of ``envelope_phase``'s kernel route on ``am`` (NumPy),
    split into its steps: host -> device copy, outer DFT, kernel D, inverse
    outer DFT, envelope and phase, device -> host copy.  Returns (seconds
    by step, (env, phase))."""
    import torch
    from pyfft_tpu_torch.ops import hilbert as hk
    sync = torch.cuda.synchronize
    nt = am.shape[0]
    n1, M = hk.row_split(nt)
    sync()
    t0 = time.perf_counter()
    x = torch.as_tensor(am, device="cuda")
    sync()
    t1 = time.perf_counter()
    A = torch.fft.fft(x.reshape(n1, M), dim=0).contiguous()
    sync()
    t2 = time.perf_counter()
    B = hk.hilbert_cuda(A)
    sync()
    t3 = time.perf_counter()
    z = torch.fft.ifft(B, dim=0).reshape(nt)
    sync()
    t4 = time.perf_counter()
    env, ph = z.abs(), z.angle()
    sync()
    t5 = time.perf_counter()
    env_h, ph_h = env.cpu().numpy(), ph.cpu().numpy()
    t6 = time.perf_counter()
    steps = {"h2d": t1 - t0, "outer_dft": t2 - t1, "kernel": t3 - t2,
             "inverse_outer_dft": t4 - t3, "envelope_phase": t5 - t4,
             "d2h": t6 - t5, "total": t6 - t0}
    return steps, (env_h, ph_h)


def stream_dc():
    """Each streamed channel's DC offset in units of its noise: 100 to 275
    (an ADC's offset, far above the noise)."""
    import numpy as np
    return 100.0 + 25.0 * np.arange(NCH)


def stream_lags():
    """The lag of each streamed channel's tone behind channel 0 (rad)."""
    import numpy as np
    return 0.6 * np.arange(NCH)


def write_shot(path, nt, dev):
    """The streamed capture: NCH interleaved int16 channels of ``nt``
    frames at FS, each ``STREAM_LSB`` times (its DC offset + a tone of
    ``STREAM_TONE`` at 97 kHz lagging channel 0 by ``stream_lags()`` +
    unit noise), made on the card from SEED in chunks of 2**22 frames."""
    import numpy as np
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    dc = torch.as_tensor(stream_dc(), device=dev)[:, None]
    lag = torch.as_tensor(stream_lags(), device=dev)[:, None]
    with open(path, "wb") as f:
        for s in range(0, nt, 1 << 22):
            n = min(1 << 22, nt - s)
            t = torch.arange(s, s + n, device=dev, dtype=torch.float64) / FS
            sig = (dc + STREAM_TONE * torch.sin(2 * np.pi * 97e3 * t - lag)
                   + torch.randn((NCH, n), generator=gen, device=dev,
                                 dtype=torch.float64))
            f.write(torch.round(STREAM_LSB * sig).to(torch.int16).T
                    .contiguous().cpu().numpy().tobytes())


def stream_navrs(nt, block, nwins, hop):
    """The segments each push of a stream of ``nt`` frames in blocks of
    ``block`` completes."""
    carry, out = 0, []
    for pos in range(0, nt, block):
        nb = carry + min(block, nt - pos)
        navr = 0 if nb < nwins else 1 + (nb - nwins) // hop
        out.append(navr)
        carry = nb - navr * hop
    return out


def stream_split(path, nt, nwins, dev):
    """Each step of ``stream_welch`` over the capture at ``path``, timed
    alone: the loader's reads into a pinned buffer (host clock, every
    block), and per push (CUDA events, median of 10 after a warm-up) the
    pinned host -> device copy, kernel B on the centred block, the float64
    linear sums and a whole ``push``; one push traced; then ``result()``
    (host clock).  Returns the seconds by step for the whole stream and
    the trace."""
    import torch
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import streaming as pstream
    nblk = -(-nt // STREAM_BLOCK)
    buf = torch.empty(NCH * STREAM_BLOCK, dtype=torch.float32,
                      pin_memory=True)
    host = buf.view(NCH, STREAM_BLOCK)
    with pt.ShotLoader(path, NCH, "int16") as ld:
        t0 = time.perf_counter()
        for pos in range(0, nt, STREAM_BLOCK):
            ld.read(pos, STREAM_BLOCK, out=host.numpy())
        loader_s = time.perf_counter() - t0
        sw = pt.StreamingWelch(nwins=nwins, fs=FS, nch=NCH,
                               fft_backend="pallas", device=dev)
        blk = torch.from_numpy(ld.read(0, STREAM_BLOCK + sw.noverlap)).to(dev)
    navr = 1 + (blk.shape[1] - nwins) // sw.hop
    sig = torch.cat([blk[:1], blk])
    span = (navr - 1) * sw.hop + nwins
    sigc = sig[:, :span] - sig[:, :span].mean(-1, keepdim=True)
    xc, yc = sigc[0].contiguous(), sigc[1:]
    centred = sw._centred_sums(sw._route(navr, False), navr)
    win, _ = sw._window(torch.float32)
    steps = {
        "h2d": lambda: host.to(dev, non_blocking=True),
        "kernel_b": lambda: centred(xc, yc),
        "linear_sums": lambda: pstream._linear_sums(
            sig, win, navr=navr, nwins=nwins, hop=sw.hop, nfreq=sw.nfreq,
            onesided=True),
        "push": lambda: sw.push(blk[0], blk)}
    ms = {k: time_ms(f, 10) for k, f in steps.items()}
    prof = trace_call(steps["push"], "welch_pair_kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sw.result()
    final_s = time.perf_counter() - t0
    per = {f"{k}_ms_per_push": v for k, v in ms.items()}
    total = {f"{k}_s": v * nblk / 1e3 for k, v in ms.items()}
    return dict(loader_s=loader_s, **total, finalization_s=final_s,
                **per), prof


def stream_phases(tmp, dev, launches, nt=1 << 25):
    """Phases 21-22: config 0 streamed from an int16 file on disk through
    ``stream_welch`` (the native loader, kernel B on real signals), held
    against the batch ``fft_pwelch`` over the same span, split by step;
    then a checkpoint at half the stream, restored and finished, against
    the uninterrupted result bit for bit."""
    import numpy as np
    import torch
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch.ops import stft, welch, welch_v1
    nwins, hop = 2048, 1024
    path = tmp / "config0.i16"
    t0 = time.perf_counter()
    write_shot(path, nt, dev)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(pt.io.native_available(), "the C++ shot loader did not build")
    loader_build_s = time.perf_counter() - t0

    # ---- twelfth main path: phase 21, config 0 from disk ----------------- #
    navrs = stream_navrs(nt, STREAM_BLOCK, nwins, hop)
    pushes = sum(n > 0 for n in navrs)
    reset_counts()
    t0 = time.perf_counter()
    with pt.ShotLoader(path, NCH, "int16") as ld:
        native = ld.native
        check(native and ld.nsamples == nt, f"loader native={ld.native} "
              f"nsamples={ld.nsamples}")
        res = pt.io.stream_welch(ld, nwins=nwins, fs=FS, block=STREAM_BLOCK,
                                 fft_backend="pallas", device=dev)
    wall = time.perf_counter() - t0
    check(welch.LAUNCHES == pushes and welch.COMPLEX_LAUNCHES == 0
          and welch_v1.LAUNCHES == 0 and welch.PACKED_LAUNCHES == 0
          and stft.LAUNCHES == 0,
          f"stream_welch launched kernel B {welch.LAUNCHES} times for "
          f"{pushes} pushes (complex {welch.COMPLEX_LAUNCHES}, E "
          f"{welch_v1.LAUNCHES}, H {welch.PACKED_LAUNCHES})")
    launches["welch"] += welch.LAUNCHES
    launches_b = welch.LAUNCHES

    # the batch fft_pwelch on the card over the same span: the capture
    # with one frame more at each end, tbounds [t1, t-2]
    with pt.ShotLoader(path, NCH, "int16") as ld:
        data = torch.from_numpy(ld.read()).to(dev)
    padded = torch.nn.functional.pad(data[None], (1, 1), mode="replicate")[0]
    del data
    tvec = np.arange(nt + 2) / FS
    t0 = time.perf_counter()
    freq, Pxy, Pxx, Pyy, _, _, info = pt.fft_pwelch(
        tvec, padded[0], padded, tbounds=[tvec[1], tvec[-2]],
        tper=(nwins + 0.5) / FS, windowoverlap=0.5, detrend_style=1,
        plotit=False, fft_backend="pallas")
    wall_batch = time.perf_counter() - t0
    del padded
    torch.cuda.empty_cache()
    check(info.nwins == nwins and res.Navr == info.Navr == sum(navrs),
          f"navr streamed {res.Navr}, batch {info.Navr}, planned "
          f"{sum(navrs)}")
    check(np.allclose(res.freq, freq, rtol=1e-12), "freq differs")
    errs = {"Pxx": rel_err(res.Pxx, np.real(Pxx))[0],
            "Pyy": rel_err(res.Pyy, np.real(Pyy).T)[0],
            "Pxy": rel_err(res.Pxy, Pxy.T)[0]}
    # bins 0-2 (the offsets' and their leakage's) against the noise floor
    floor = np.median(res.Pyy, axis=-1)
    dc_err = float(np.max(np.abs(res.Pyy[:, :3] - np.real(Pyy).T[:, :3])
                          / floor[:, None]))
    chans = np.arange(NCH)
    ipk = np.argmax(res.Pyy, axis=-1)
    fpk = res.freq[ipk]
    coh = res.Cxy2[chans, ipk]
    phi = res.phi_xy[chans, ipk]
    dphi = np.abs(np.angle(np.exp(1j * (phi + stream_lags()))))
    split, prof = stream_split(path, nt, nwins, dev)
    busy = prof["device_busy_ms"] * pushes / 1e3
    emit("stream_config0", nt=nt, nch=NCH, nwins=nwins, block=STREAM_BLOCK,
         dtype="int16", file_mb=nt * NCH * 2 / 2 ** 20, write_s=write_s,
         loader_build_s=loader_build_s, native=native, pushes=len(navrs),
         launches=launches_b,
         navr=res.Navr, dc_offsets=stream_dc().tolist(),
         rel_err_vs_batch=errs, tol=WELCH_TOL, dc_bins_err_over_floor=dc_err,
         dc_tol=DC_TOL, peak_hz=fpk.tolist(), coh2_at_peak=coh.tolist(),
         phase_at_peak=phi.tolist(), phase_want=(-stream_lags()).tolist(),
         phase_tol=LAG_PHASE_TOL, wall_s=wall,
         samples_per_s=NCH * nt / wall, frames_per_s=nt / wall,
         wall_s_batch_fft_pwelch=wall_batch, split=split,
         device_busy_share_est=busy / wall, push_profile=prof)
    for k, e in errs.items():
        check(e <= WELCH_TOL, f"streamed config 0 {k}: vs batch {e}")
    check(dc_err <= DC_TOL, f"streamed config 0 bins 0-2: {dc_err} of the "
          f"noise floor from the batch")
    check(np.all(np.abs(fpk - 97e3) <= FS / nwins), f"Pyy peaks at {fpk}")
    check(np.all(coh > 0.9), f"|Cxy|^2 at the peak {coh}")
    check(np.all(dphi <= LAG_PHASE_TOL), f"phase at the peak {phi} against "
          f"{-stream_lags()}")
    check(prof["h2d_pageable"] == 0, f"a push made {prof['h2d_pageable']} "
          f"pageable host -> device copies")

    # ---- phase 22: checkpoint at half the stream, restore, finish -------- #
    half = pushes // 2
    ckpt = tmp / "welch_ckpt.npz"
    sw = pt.StreamingWelch(nwins=nwins, fs=FS, nch=NCH, fft_backend="pallas",
                           device=dev)
    with pt.ShotLoader(path, NCH, "int16") as ld:
        for i, blk in enumerate(ld.stream(block=STREAM_BLOCK)):
            if i == half:
                t0 = time.perf_counter()
                sw.checkpoint(str(ckpt))
                sw = pt.StreamingWelch.restore(str(ckpt), fft_backend="pallas",
                                               device=dev)
                ckpt_s = time.perf_counter() - t0
            blk = torch.from_numpy(blk).to(dev)
            sw.push(blk[0], blk)
    res2 = sw.result()
    same = {k: bool(np.array_equal(getattr(res2, k), getattr(res, k)))
            for k in ("Pxx", "Pyy", "Pxy", "Cxy2", "phi_xy")}
    emit("stream_resume", at_push=half, checkpoint_kb=ckpt.stat().st_size
         / 1024, checkpoint_restore_s=ckpt_s, bit_identical=same,
         navr=res2.Navr)
    check(all(same.values()) and res2.Navr == res.Navr,
          f"resumed stream differs from the uninterrupted one: {same}")


def multitaper_wavelet(dev, n=1 << 20, nc=1 << 18):
    """Phase 23: multitaper_psd (adaptive) and multitaper_csd of ``n``
    samples and the cwt of an ``nc``-sample chirp on the card (float32),
    each against the port's CPU float64 path on the same values; the cwt
    ridge against the chirp's instantaneous frequency."""
    import numpy as np
    import torch
    import pyfft_tpu_torch as pt
    rng = np.random.default_rng(SEED + 23)
    t = np.arange(n) / FS
    x = (np.sin(2 * np.pi * 97e3 * t)
         + 0.5 * rng.standard_normal(n)).astype(np.float32)
    y = (0.6 * np.sin(2 * np.pi * 97e3 * t - 0.7)
         + 0.5 * rng.standard_normal(n)).astype(np.float32)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    t0 = time.perf_counter()
    f_c, S_c = pt.multitaper_psd(xd, fs=FS, NW=4, weighting="adaptive")
    first_s = time.perf_counter() - t0          # the tapers, then cached
    t0 = time.perf_counter()
    pt.multitaper_psd(xd, fs=FS, NW=4, weighting="adaptive")
    psd_s = time.perf_counter() - t0
    _, S_h = pt.multitaper_psd(x.astype(np.float64), fs=FS, NW=4,
                               weighting="adaptive", device="cpu")
    t0 = time.perf_counter()
    csd_c = pt.multitaper_csd(xd, yd, fs=FS, NW=4)
    csd_s = time.perf_counter() - t0
    csd_h = pt.multitaper_csd(x.astype(np.float64), y.astype(np.float64),
                              fs=FS, NW=4, device="cpu")
    errs = {"psd_adaptive": rel_err(S_c, S_h)[0]}
    for k, i in (("csd_Pxy", 1), ("csd_Pxx", 2), ("csd_Pyy", 3)):
        errs[k] = rel_err(csd_c[i], csd_h[i])[0]
    ipk = int(np.argmax(np.abs(csd_c[1])))
    coh, phi = float(csd_c[4][ipk]), float(csd_c[5][ipk])

    tc = np.arange(nc) / FS
    f_inst = 20e3 + 180e3 * tc / tc[-1]
    xc = np.sin(2 * np.pi * np.cumsum(f_inst) / FS).astype(np.float32)
    xcd = torch.from_numpy(xc).to(dev)
    pt.wavelet.cwt(xcd, dt=1 / FS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W_c, scales, freqs, coi = pt.wavelet.cwt(xcd, dt=1 / FS)
    cwt_s = time.perf_counter() - t0
    W_h = pt.wavelet.cwt(xc.astype(np.float64), dt=1 / FS, device="cpu")[0]
    errs["cwt"] = rel_err(W_c, W_h)[0]
    del W_h
    ridge = {}
    for frac in (0.25, 0.5, 0.75):
        i = int(frac * nc)
        fr = float(freqs[int(np.argmax(np.abs(W_c[:, i])))])
        ridge[str(frac)] = [fr, float(f_inst[i])]
    emit("multitaper_wavelet", n_mt=n, n_cwt=nc, scales=len(scales),
         rel_err_vs_cpu_float64=errs, tol=MT_TOL, csd_peak_hz=float(
             f_c[ipk]), csd_coh2_at_peak=coh, csd_phase_at_peak=phi,
         cwt_ridge_hz_vs_f_inst=ridge, first_psd_s=first_s,
         psd_adaptive_s=psd_s, csd_s=csd_s, cwt_s=cwt_s)
    for k, e in errs.items():
        check(e <= MT_TOL, f"{k}: card vs CPU {e} > {MT_TOL}")
    check(abs(f_c[ipk] - 97e3) <= 8 * FS / n and coh > 0.95
          and abs(phi + 0.7) < 0.05, f"multitaper csd peak {f_c[ipk]} Hz, "
          f"coh2 {coh}, phase {phi}")
    for frac, (fr, fi) in ridge.items():
        check(abs(fr - fi) / fi < 0.15, f"cwt ridge at {frac}: {fr} Hz "
              f"against {fi}")


def mesh_run(name, fn, counts, reps):
    """A mesh phase's drive of ``fn``: the main-path call with every
    kernel's count set to 0 before it and ``counts()`` read after it (the
    first call: it pays the one-rank group's first collectives), ``reps``
    calls timed by the host clock to a synchronize, one call under
    ``parallel.runtime.recording`` for the collectives and the wall split
    by the steps the call marks (moments, halo, kernel, reductions; fft,
    twiddle, all_to_all; the rest host), and one
    under a dispatch mode that lists every operation with a tensor off the
    card (the host -> device copies of small NumPy constants counted
    apart).
    Returns ``(first output, main-path counts, fields to emit)``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from pyfft_tpu_torch.parallel import runtime
    copies = (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default,
              torch.ops.aten.lift_fresh.default)
    # a result's hand-over to NumPy (``.numpy()`` detaches the host copy)
    handover = (torch.ops.aten.detach.default, torch.ops.aten.alias.default)

    class OnCard(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.host_ops, self.h2d = {}, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            off = any(isinstance(a, torch.Tensor) and a.device.type != "cuda"
                      for a in tree_leaves((args, kwargs)))
            out = func(*args, **kwargs)
            if off and func not in handover:
                if func in copies:
                    self.h2d += 1
                else:
                    key = str(func)
                    self.host_ops[key] = self.host_ops.get(key, 0) + 1
            return out

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n = counts()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    with runtime.recording() as rec:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with OnCard() as oc:             # apart: the mode costs host time
        fn()
    split = {k: v for k, v in rec.wall.items() if k != "host"}
    split["host"] = wall - sum(split.values())
    check(not oc.host_ops, f"{name}: operations on tensors off the card "
          f"{oc.host_ops}")
    return out, n, dict(
        launches=n, first_s=first_s, wall_s=statistics.median(runs),
        wall_s_quartiles=statistics.quantiles(runs, n=4), reps=reps,
        audited_wall_s=wall, wall_s_split=split,
        collectives=rec.rows, host_tensor_ops=oc.host_ops,
        h2d_copies=oc.h2d)


def mesh_phases(dev, launches):
    """Phases 24-28: the mesh tier (``pyfft_tpu_torch.parallel``) on a
    one-rank NCCL group, a 1 x 1 mesh: every step of the path runs (the
    global moments and their all-reduce, the kernels on the rank's block,
    the all-reduce of the sums and the gathers) with no halo to exchange.
    (a) ``fft_pwelch(..., mesh=..., fft_backend='pallas')`` at config 5
    (kernel B), (b) the same on Doppler IQ signals of 9 x 2**22 (kernel B
    on complex signals), (c) ``stft_sharded`` on config 2's chirp (kernel
    C), (d) ``fir_filter_sharded`` on config 0's channels with the
    129-tap band-pass (kernel A), (e) the lazy per-segment fill of a mesh
    ``fft_pwelch`` at 2**20 samples (kernel C, every signal in one
    launch); each against the single-device path on the same card."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import parallel as par
    from pyfft_tpu_torch import segmentation as seg
    from pyfft_tpu_torch.ops import fir, stft, welch

    par.init_distributed()
    mesh = par.make_mesh(1, 1)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and mesh.device_type == "cuda",
          f"mesh group: {dist.get_backend()} over {dist.get_world_size()} "
          f"ranks, mesh on {mesh.device_type}")

    def counts():
        return dict(welch=welch.LAUNCHES, welch_complex=welch.COMPLEX_LAUNCHES,
                    stft=stft.LAUNCHES, fir=fir.LAUNCHES)

    def errs_of(got, ref):
        return {k: rel_err(got[i], ref[i])[0]
                for k, i in (("Pxx", 2), ("Pyy", 3), ("Pxy", 1))}

    # ---- (a) config 5 through fft_pwelch(mesh=...) ----------------------- #
    nt5 = 1 << 24
    x5, y5 = signals(nt5, dev)
    tvec = np.arange(nt5) / FS
    args = dict(tbounds=[tvec[1], tvec[-2]], tper=4096.5 / FS, plotit=False,
                fft_backend="pallas")
    got, n, info = mesh_run(
        "mesh_config5", lambda: pt.fft_pwelch(tvec, x5, y5, mesh=mesh,
                                              **args),
        counts, 10)
    check(n == dict(welch=1, welch_complex=0, stft=0, fir=0),
          f"mesh config 5 launched {n}")
    launches["welch"] += n["welch"]
    ref = pt.fft_pwelch(tvec, x5, y5, **args)
    errs = errs_of(got, ref)
    check(got[6].nwins == 4096 and "_lazy_segments" in got[6].__dict__,
          "mesh config 5: nwins or the lazy fill")
    emit("mesh_config5", nt=nt5, nch=NCH, nwins=4096, navr=got[6].Navr,
         rel_err_vs_single_device=errs, tol=WELCH_TOL,
         single_device_wall_s=time_host(
             lambda: pt.fft_pwelch(tvec, x5, y5, **args)), **info)
    for k, e in errs.items():
        check(e <= WELCH_TOL, f"mesh config 5 {k}: {e} > {WELCH_TOL}")
    del x5, y5, got, ref
    torch.cuda.empty_cache()

    # ---- (b) Doppler IQ through fft_pwelch(mesh=...) --------------------- #
    ntq = 1 << 22
    xq, yq = iq_signals(ntq, dev)
    tq = np.arange(ntq) / FS
    argq = dict(tbounds=[tq[1], tq[-2]], tper=4096.5 / FS, plotit=False,
                fft_backend="pallas")
    got, n, info = mesh_run(
        "mesh_doppler_iq", lambda: pt.fft_pwelch(tq, xq, yq, mesh=mesh,
                                                 **argq),
        counts, 10)
    check(n == dict(welch=0, welch_complex=1, stft=0, fir=0),
          f"mesh IQ launched {n}")
    launches["welch_complex"] += n["welch_complex"]
    ref = pt.fft_pwelch(tq, xq, yq, **argq)
    errs = errs_of(got, ref)
    chans = np.arange(NCH)
    ipk = np.argmax(np.abs(got[3]), axis=0)
    phi = np.angle(got[1][ipk, chans])
    dphi = np.abs(np.angle(np.exp(1j * (phi + iq_phases()))))
    emit("mesh_doppler_iq", nt=ntq, nch=NCH, nwins=got[6].nwins,
         navr=got[6].Navr, two_sided=bool(got[0][0] < 0),
         peak_hz=got[0][ipk].tolist(), phase_at_peak=phi.tolist(),
         rel_err_vs_single_device=errs, tol=WELCH_TOL,
         single_device_wall_s=time_host(
             lambda: pt.fft_pwelch(tq, xq, yq, **argq)), **info)
    for k, e in errs.items():
        check(e <= WELCH_TOL, f"mesh IQ {k}: {e} > {WELCH_TOL}")
    check(got[0][0] < 0 and np.all(np.abs(got[0][ipk] - IQ_F0)
                                   <= FS / got[6].nwins)
          and np.all(dphi <= LAG_PHASE_TOL), f"mesh IQ line {got[0][ipk]} "
          f"Hz, phase {phi}")
    del xq, yq, got, ref

    # ---- (c) stft_sharded on config 2's chirp ----------------------------- #
    nt2 = 1 << 24
    x2, _ = chirp(nt2)
    x2d = torch.from_numpy(x2).to(dev)
    t2 = np.arange(nt2) / FS
    plan2 = seg.plan_segments(nt2, nwins=2048, windowoverlap=0.5)
    win2 = np.hanning(2049)[:-1]
    got, n, info = mesh_run(
        "mesh_stft", lambda: par.stft_sharded(x2d, t2, win2, plan2, FS, mesh),
        counts, 5)
    check(n == dict(welch=0, welch_complex=0, stft=1, fir=0),
          f"mesh STFT launched {n}")
    launches["stft"] += n["stft"]
    ref = pt.stft_segments(x2d, t2, win2, plan2, FS)
    err, _ = rel_err(got[2], ref[2])
    tt_err = float(np.abs(got[0] - ref[0]).max())
    emit("mesh_stft", nt=nt2, nwins=2048, navr=plan2.navr,
         X_shape=list(got[2].shape), rel_err_vs_single_device=err,
         tt_max_abs_diff_s=tt_err, tol=STFT_TOL,
         single_device_wall_s=time_host(
             lambda: pt.stft_segments(x2d, t2, win2, plan2, FS)), **info)
    check(got[2].shape == (plan2.navr, plan2.nnyquist) and err <= STFT_TOL
          and tt_err <= 1e-9, f"mesh STFT: {got[2].shape}, rel err {err}, "
          f"tt {tt_err}")
    del x2d, got, ref

    # ---- (d) fir_filter_sharded on config 0's channels ------------------- #
    taps = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    _, y0 = signals(1 << 25, dev)
    got, n, info = mesh_run(
        "mesh_fir", lambda: par.fir_filter_sharded(y0, taps, mesh),
        counts, 5)
    check(n == dict(welch=0, welch_complex=0, stft=0, fir=1),
          f"mesh FIR launched {n}")
    launches["fir"] += n["fir"]
    ref = pt.filters.fir_filter(y0, taps, backend="pallas")
    err, _ = rel_err(got, ref)
    same = bool(np.array_equal(got, ref))
    emit("mesh_fir", shape=list(got.shape), ntaps=len(taps),
         rel_err_vs_single_device=err, tol=FIR_TOL,
         bit_for_bit_with_single_device=same,
         differing=int(np.count_nonzero(got != ref)),
         single_device_wall_s=time_host(
             lambda: pt.filters.fir_filter(y0, taps, backend="pallas")),
         **info)
    check(got.shape == tuple(y0.shape) and err <= FIR_TOL,
          f"mesh FIR {got.shape}: rel err {err}")
    del y0, got, ref
    torch.cuda.empty_cache()

    # ---- (e) the lazy per-segment fill of a mesh fft_pwelch -------------- #
    nte = 1 << 20
    xe, ye = signals(nte, dev)
    te = np.arange(nte) / FS
    arge = dict(tbounds=[te[1], te[-2]], tper=4096.5 / FS, plotit=False,
                fft_backend="pallas")
    fields = ("Pxx_seg", "Pyy_seg", "Pxy_seg", "Xfft_seg", "Yfft_seg")

    def filled(**kw):
        info_e = pt.fft_pwelch(te, xe, ye, **arge, **kw)[6]
        return {k: getattr(info_e, k) for k in fields}
    got, n, info = mesh_run("mesh_lazy_fill", lambda: filled(mesh=mesh),
                            counts, 5)
    check(n == dict(welch=1, welch_complex=0, stft=1, fir=0),
          f"mesh fill launched {n}")
    launches["welch"] += n["welch"]
    launches["stft"] += n["stft"]
    ref = filled()
    errs = {k: rel_err(got[k], ref[k])[0] for k in fields}
    emit("mesh_lazy_fill", nt=nte, nch=NCH,
         shapes={k: list(v.shape) for k, v in got.items()},
         dtypes={k: str(v.dtype) for k, v in got.items()},
         rel_err_vs_single_device=errs, tol=STFT_TOL,
         single_device_wall_s=time_host(filled), **info)
    for k, e in errs.items():
        check(got[k].dtype == np.complex128 and got[k].shape == ref[k].shape
              and e <= STFT_TOL, f"mesh fill {k}: {got[k].dtype} "
              f"{got[k].shape}, rel err {e}")


def mesh_fft_phases(dev, card, n=1 << 24,
                    n_blue=10 ** 7):
    """Phases 29-31: the mesh tier's FFT half (``parallel.fft``) on the
    one-rank NCCL group, a 1 x 1 mesh: every all-to-all of the path runs,
    between ranks of one.  (29) ``fft_sharded`` (the four-step) on 2**24
    complex64 samples and on 8 x 2**22 real float32 ones against
    ``torch.fft.fft``, ``ifft_sharded`` back, ``rfft_sharded`` and
    ``irfft_sharded`` at 2**24; (30) ``_bluestein_sharded`` at N = 10**7 (M
    = 2**25), which the public route takes only where d**2 does not divide
    N, never on one rank, against a complex128 ``torch.fft.fft``; (31)
    ``envelope_phase(..., mesh=...)`` on config 4's AM signal against the
    single-device ``envelope_phase`` (kernel D's chain).  The path launches
    no kernel of the port: every count must stay 0.  ``card`` (the
    ``nvidia-smi`` name and power limit) goes on every line; ``n`` and
    ``n_blue`` are the lengths (the real input is 8 x ``n/4``)."""
    import numpy as np
    import torch
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import parallel as par
    from pyfft_tpu_torch.parallel import fft as pfft

    par.init_distributed()
    mesh = par.make_mesh(1, 1)
    zero = {k: 0 for k in read_counts()}

    def drive(name, fn):
        out, n, info = mesh_run(name, fn, read_counts, 10)
        check(n == zero, f"{name} launched kernels {n}")
        return out, info

    gen = torch.Generator(device=dev).manual_seed(SEED)
    c128 = torch.complex128

    # ---- phase 29: fft_sharded, the four-step ---------------------------- #
    n29 = n
    z = torch.randn(n29, dtype=torch.complex64, device=dev, generator=gen)
    (yr, yi), info = drive("mesh_fft_four_step",
                           lambda: par.fft_sharded(z, mesh))
    y = torch.complex(yr, yi)
    e64 = rel_err(y, torch.fft.fft(z))[0]
    e128 = rel_err(y, torch.fft.fft(z.to(c128)))[0]
    cufft128 = rel_err(torch.fft.fft(z), torch.fft.fft(z.to(c128)))[0]
    emit("mesh_fft_four_step", card=card, n=n29,
         factors=list(par.four_step_factor(n29, 1)),
         rel_err_vs_torch_fft=e64, rel_err_vs_complex128=e128,
         torch_fft_rel_err_vs_complex128=cufft128, tol=MESH_FFT_TOL,
         torch_fft_wall_s=time_host(lambda: torch.fft.fft(z), 10),
         four_step_ms=time_ms(lambda: pfft._fourstep_run(z, mesh), 10),
         torch_fft_ms=time_ms(lambda: torch.fft.fft(z), 10), **info)
    check(y.shape == (n29,) and e64 <= MESH_FFT_TOL
          and e128 <= MESH_FFT_TOL, f"four-step 2**24: {y.shape}, rel err "
          f"{e64} (complex128 {e128})")

    xr = torch.randn(NCH, n // 4, device=dev, generator=gen)
    (br, bi), info = drive("mesh_fft_real_batched",
                           lambda: par.fft_sharded(xr, mesh))
    e64 = rel_err(torch.complex(br, bi), torch.fft.fft(xr))[0]
    e128 = rel_err(torch.complex(br, bi), torch.fft.fft(xr.double()))[0]
    emit("mesh_fft_real_batched", card=card, shape=list(xr.shape),
         rel_err_vs_torch_fft=e64, rel_err_vs_complex128=e128,
         tol=MESH_FFT_TOL,
         torch_fft_wall_s=time_host(lambda: torch.fft.fft(xr), 10), **info)
    check(br.shape == xr.shape and e64 <= MESH_FFT_TOL
          and e128 <= MESH_FFT_TOL, f"four-step 8 x 2**22 real: rel err "
          f"{e64} (complex128 {e128})")
    del xr, br, bi

    (zr, zi), info = drive("mesh_ifft", lambda: par.ifft_sharded(y, mesh))
    e_back = rel_err(torch.complex(zr, zi), z)[0]
    emit("mesh_ifft", card=card, n=n29, rel_err_vs_input=e_back,
         tol=MESH_FFT_TOL, **info)
    check(e_back <= MESH_FFT_TOL, f"ifft_sharded back: rel err {e_back}")
    del y, zr, zi

    x29 = z.real.contiguous()

    def round_trip():
        re, im = par.rfft_sharded(x29, mesh)
        return re, im, par.irfft_sharded(re, im, n29, mesh)
    (re, im, back), info = drive("mesh_rfft_irfft", round_trip)
    ref = torch.fft.rfft(x29)
    e_r = rel_err(re + 1j * im, ref)[0]
    e_r128 = rel_err(re + 1j * im, torch.fft.rfft(x29.double()))[0]
    e_back = rel_err(back, x29)[0]
    emit("mesh_rfft_irfft", card=card, n=n29, bins=int(re.shape[-1]),
         rel_err_rfft_vs_torch_fft=e_r, rel_err_rfft_vs_complex128=e_r128,
         rel_err_irfft_vs_input=e_back, tol=MESH_FFT_TOL,
         dtypes=[str(re.dtype), str(back.dtype)], **info)
    check(re.shape == (n29 // 2 + 1,) and back.shape == (n29,)
          and max(e_r, e_r128, e_back) <= MESH_FFT_TOL,
          f"rfft/irfft_sharded: rel err {e_r}, {e_r128}, back {e_back}")
    del z, x29, re, im, back, ref
    torch.cuda.empty_cache()

    # ---- phase 30: the distributed Bluestein ----------------------------- #
    n30 = n_blue
    z30 = torch.randn(n30, dtype=torch.complex64, device=dev, generator=gen)
    y30, info = drive("mesh_bluestein",
                      lambda: pfft._bluestein_sharded(z30, mesh))
    e64 = rel_err(y30, torch.fft.fft(z30))[0]
    e128 = rel_err(y30, torch.fft.fft(z30.to(c128)))[0]
    emit("mesh_bluestein", card=card, n=n30, M=pfft.bluestein_size(n30, 1),
         rel_err_vs_complex128=e128, rel_err_vs_torch_fft=e64,
         tol=BLUESTEIN_TOL,
         torch_fft_wall_s=time_host(lambda: torch.fft.fft(z30), 10), **info)
    check(y30.shape == (n30,) and e128 <= BLUESTEIN_TOL,
          f"Bluestein 10**7: {y30.shape}, rel err vs complex128 {e128}")
    del z30, y30
    torch.cuda.empty_cache()

    # ---- phase 31: envelope_phase over the mesh at config 4 -------------- #
    nt4 = n
    am = torch.as_tensor(am_signal(nt4)[0], device=dev)
    (env, ph), info = drive(
        "mesh_envelope_phase",
        lambda: pt.hilbert_mod.envelope_phase(am, mesh=mesh))
    env1, ph1 = pt.hilbert_mod.envelope_phase(am)
    env_err = float(np.abs(env - env1).max() / np.abs(env1).max())
    keep = env1 > 1e-2 * env1.max()
    dphi = np.angle(np.exp(1j * (ph.astype(np.float64) - ph1)))
    ph_err = float(np.abs(dphi[keep]).max())
    emit("mesh_envelope_phase", card=card, nt=nt4,
         rel_err_env_vs_single_device=env_err, env_tol=MESH_ENV_TOL,
         phase_err_vs_single_device_rad=ph_err, phase_tol=PHASE_TOL,
         single_device_wall_s=time_host(
             lambda: pt.hilbert_mod.envelope_phase(am), 10), **info)
    check(env.shape == ph.shape == (nt4,) and env.dtype == np.float32
          and env_err <= MESH_ENV_TOL and ph_err <= PHASE_TOL,
          f"mesh envelope_phase: {env.shape}, envelope {env_err}, phase "
          f"{ph_err} rad")


def entry_phases(dev, card, launches):
    """Phases 32-33: the top-level entry points (``pyfft_tpu_torch.entry``).
    (32) ``entry()``'s forward step on the card (kernel B at 4 channels of
    2**15 samples, nwins 1024), timed 25 times by CUDA events, against
    kernel B's plain version on the same tensors; (33)
    ``dryrun_multichip(1)`` on the one-rank NCCL group that
    :func:`mesh_phases` started: every stage of the mesh tier on the JAX
    dry run's shapes, each held against the single-device pipeline, with
    the launches of kernels A, B (real and complex), C and E, the
    collectives it issued and the operations it ran off the card (through
    :func:`mesh_run`).  ``card`` (the ``nvidia-smi`` name and power limit)
    goes on both lines."""
    import contextlib
    import io
    import numpy as np
    import torch
    import torch.distributed as dist
    from pyfft_tpu_torch import entry as pe
    from pyfft_tpu_torch.spectral import _onesided_power_scale
    from pyfft_tpu_torch.ops import welch
    from pyfft_tpu_torch.utils import profiling

    # ---- phase 32: entry()'s forward step -------------------------------- #
    fwd, (x, y) = pe.entry()
    check(x.is_cuda and y.is_cuda, f"entry's inputs on {x.device}")
    reset_counts()
    got = fwd(x, y)
    torch.cuda.synchronize()
    n = read_counts()
    check(n["welch"] == n["means"] == 1 and sum(n.values()) == 2,
          f"entry's forward launched {n}")
    launches["welch"] += n["welch"]
    plan, win, s1sq_enbw = pe.flagship_geometry()
    norm = float(np.float32(1.0 / (s1sq_enbw * plan.navr)))
    sc = torch.as_tensor(_onesided_power_scale(plan.nfft, plan.nnyquist),
                         dtype=torch.float32, device=dev)

    def plain():
        out = welch.welch_plain(x, y, win, plan.nnyquist, norm,
                                navr=plan.navr, nwins=plan.nwins,
                                hop=plan.hop, detrend_style=1)
        return (out[0] * sc, (out[1] * sc).T, (out[2] * sc).T,
                (out[3] * sc).T)
    ref = plain()
    names = ("Pxx", "Pyy", "Pxy_re", "Pxy_im")
    errs = {k: rel_err(g, r)[0] for k, g, r in zip(names, got, ref)}
    shapes = [list(g.shape) for g in got]
    runs = {"ms": time_runs(lambda: fwd(x, y), 25),
            "plain_ms": time_runs(plain, 25)}
    prof32 = trace_call(lambda: fwd(x, y), "welch_pair_kernel")
    nsig = 1 + y.shape[0]
    ms32, by32 = profiling.bound_ms(
        profiling.welch_flops(plan.navr, plan.nwins, y.shape[0]),
        4.0 * nsig * (plan.nsig + 3 * plan.nnyquist), "fp32", kind=card)
    emit("entry_forward", card=card, nt=plan.nsig, nch=int(y.shape[0]),
         nwins=plan.nwins, navr=plan.navr, nfreq=plan.nnyquist,
         shapes=shapes, launches=n["welch"], rel_err_vs_plain=errs,
         tol=WELCH_TOL,
         ms=statistics.median(runs["ms"]),
         plain_ms=statistics.median(runs["plain_ms"]),
         quartiles_ms={k: statistics.quantiles(v, n=4)
                       for k, v in runs.items()},
         reps=25, bound_ms=ms32, bound_by=by32,
         kernel_device_ms=prof32["kernel_ms"], profile=prof32)
    check(prof32["h2d_pageable"] == 0,
          f"entry's forward: {prof32['h2d_pageable']} pageable host -> "
          f"device copies in a call after the first")
    check(shapes == [[plan.nnyquist]] + [[plan.nnyquist, 4]] * 3
          and all(bool(torch.isfinite(g).all().item()) for g in got),
          f"entry's forward: shapes {shapes} or non-finite values")
    for k, e in errs.items():
        check(e <= WELCH_TOL, f"entry's forward {k}: rel err {e} > "
              f"{WELCH_TOL}")
    del x, y, got, ref

    # ---- phase 33: dryrun_multichip(1) on the one-rank NCCL group -------- #
    check(dist.is_initialized() and dist.get_world_size() == 1
          and dist.get_backend() == "nccl",
          "phase 33 needs mesh_phases' one-rank NCCL group")

    def dryrun():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            line = pe.dryrun_multichip(1)
        check(buf.getvalue().strip() == line, f"dry run printed "
              f"{buf.getvalue()!r}, returned {line!r}")
        return line
    t0 = time.perf_counter()
    line, n, info = mesh_run("dryrun_multichip", dryrun, read_counts, 3)
    total_s = time.perf_counter() - t0
    used = ("fir", "welch", "welch_complex", "stft", "welch_dft")
    ops = {}
    for r in info["collectives"]:
        ops[r["op"]] = ops.get(r["op"], 0) + 1
    emit("dryrun_multichip", card=card, ok_line=line,
         collective_counts=ops,
         collective_bytes=sum(r["bytes"] for r in info["collectives"]),
         phase_s=total_s, **info)
    check(line.startswith("dryrun_multichip OK: mesh=(1x1), nch=2, "
                          "nt=4096, navr=31, nfreq=128, checks="),
          f"dry run line {line!r}")
    for k in used:
        check(n[k] > 0, f"the dry run launched kernel {k} {n[k]} times")
        launches[k] += n[k]
    # the means kernel among them: no kernel B call of the dry run on the
    # card takes mean detrend
    check(all(v == 0 for k, v in n.items() if k not in used),
          f"the dry run launched kernels off its path: {n}")


def reset_counts():
    """Every kernel's launch count to 0, before a main path."""
    from pyfft_tpu_torch.ops import fir, probe, stft, welch, welch_v1
    from pyfft_tpu_torch.ops import hilbert as hk
    fir.LAUNCHES = welch.LAUNCHES = stft.LAUNCHES = hk.LAUNCHES = 0
    welch_v1.LAUNCHES = welch.PACKED_LAUNCHES = fir.FIR_T_LAUNCHES = 0
    welch.COMPLEX_LAUNCHES = welch.X_PREFILTERS = welch.MEANS_LAUNCHES = 0
    probe.LAUNCHES.update(colsum=0, chain=0)


def read_counts():
    """Every kernel's launch count."""
    from pyfft_tpu_torch.ops import fir, probe, stft, welch, welch_v1
    from pyfft_tpu_torch.ops import hilbert as hk
    return dict(fir=fir.LAUNCHES, welch=welch.LAUNCHES,
                welch_complex=welch.COMPLEX_LAUNCHES, stft=stft.LAUNCHES,
                hilbert=hk.LAUNCHES, welch_dft=welch_v1.LAUNCHES,
                welch_packed=welch.PACKED_LAUNCHES,
                fir_t=fir.FIR_T_LAUNCHES, means=welch.MEANS_LAUNCHES,
                **probe.LAUNCHES)


def main():
    if not (HERE / "pyfft_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: pyfft_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import segmentation as seg
    from pyfft_tpu_torch.hilbert import _analytic_factored
    from pyfft_tpu_torch.ops import (_build, fir, probe, stft, welch,
                                     welch_packed, welch_v1)
    from pyfft_tpu_torch.ops import hilbert as hk
    from pyfft_tpu_torch.utils import profiling
    check(Path(pt.__file__).resolve().parent == HERE / "pyfft_tpu_torch",
          f"pyfft_tpu_torch imported from {pt.__file__}")
    check("jax" not in sys.modules and "pyfft_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    def bound(flops, nbytes, unit="fp32"):
        """The kernels line's bound_ms and bound_by for this card."""
        ms, by = profiling.bound_ms(flops, nbytes, unit, kind=smi)
        return dict(bound_ms=ms, bound_by=by)

    def fir_ops(nt, ntaps, nch):
        """The least operations of a causal FIR: direct form or
        overlap-save, whichever needs fewer."""
        return min(profiling.fir_flops(nt, ntaps, nch, "direct"),
                   profiling.fir_flops(nt, ntaps, nch, "overlap-save"))

    # ---- phase 1: device and build --------------------------------------- #
    t0 = time.perf_counter()
    _build.library()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         build_s=time.perf_counter() - t0, nvcc_s=_build.build_seconds())

    nt0 = 1 << 25
    x0, y0 = signals(nt0, dev)
    taps0 = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    kernels = {}

    # ---- phase 2: kernel A against its plain version --------------------- #
    sig9 = torch.cat([x0[None], y0])
    rng = np.random.default_rng(SEED + 1)
    long_taps = rng.standard_normal(1024) / 32
    # config-0 signals at 129 and 1024 taps, and config-5-sized ones
    for nt, K, taps in ((nt0, 129, taps0), (nt0, 1024, long_taps),
                        (nt0 // 2, 129, taps0)):
        sig = sig9[:, :nt].contiguous()
        got = fir.fir_cuda(sig, taps)
        ref = fir.fir_plain(sig, taps)
        err, scale = rel_err(got, ref)
        max_abs = err * scale
        del got, ref
        runs = time_runs(lambda: fir.fir_cuda(sig, taps), 25)
        ms = statistics.median(runs)
        plain_ms = time_ms(lambda: fir.fir_plain(sig, taps))
        # library: one cuDNN convolution (zero padding on both sides)
        wflip = torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                                dtype=torch.float32, device=dev).view(1, 1, K)
        lib_runs = time_runs(lambda: torch.nn.functional.conv1d(
            sig.view(-1, 1, nt), wflip, padding=K - 1), 25)
        lib_ms = statistics.median(lib_runs)
        b2 = bound(fir_ops(nt, K, sig.shape[0]), 8.0 * sig.numel())
        # the direct form's 2 K flops an output at the book's float32 rate
        floor2 = bound(profiling.fir_flops(nt, K, sig.shape[0], "direct"),
                       8.0 * sig.numel())["bound_ms"]
        dms2, tr2 = trace_launches(lambda: fir.fir_cuda(sig, taps),
                                   "fir_kernel")
        emit("fir_vs_plain", shape=list(sig.shape), K=K, rel_err=err,
             max_abs_err=max_abs, tol=FIR_TOL, ms=ms,
             ms_quartiles=statistics.quantiles(runs, n=4),
             plain_ms=plain_ms, library_ms=lib_ms,
             library_ms_quartiles=statistics.quantiles(lib_runs, n=4),
             kernel_device_ms=dms2, traced_launches=tr2["kernel_launches"],
             ptxas=ptxas_report("fir_kernel"), direct_floor_ms=floor2, **b2)
        check(err <= FIR_TOL, f"kernel A {list(sig.shape)} K={K}: rel err "
              f"{err} > {FIR_TOL}")
        if nt == nt0 and K == 129:
            kernels["fir"] = dict(max_abs_err=max_abs, ms=ms,
                                  plain_ms=plain_ms, library_ms=lib_ms, **b2)
    del sig9, sig

    # ---- phase 3: kernel B against its plain version --------------------- #
    x5, y5 = x0[:nt0 // 2], y0[:, :nt0 // 2]
    for cfg, x, y, nwins, taps in ((0, x0, y0, 2048, taps0),
                                   (5, x5, y5, 4096, None)):
        nt = x.shape[0]
        plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
        win = np.hanning(nwins + 1)[:-1]
        s1 = seg.get_s1(win)
        norm = 1.0 / (s1 ** 2 * seg.get_enbw(FS, s1, seg.get_s2(win))
                      * plan.navr)
        kw = dict(navr=plan.navr, nwins=nwins, hop=plan.hop, taps=taps,
                  detrend_style=1)
        got = welch.welch_cuda(x, y, win, plan.nnyquist, norm, **kw)
        ref = welch.welch_plain(x, y, win, plan.nnyquist, norm, **kw)
        errs = {"Pxx": rel_err(got[0], ref[0]),
                "Pyy": rel_err(got[1], ref[1]),
                "Pxy": rel_err(torch.complex(got[2], got[3]),
                               torch.complex(ref[2], ref[3]))}
        chan = {"1_to_1": channel_errs(got, ref)}
        del got, ref
        if cfg == 0:
            # every channel 10 and 1000 times quieter than the reference:
            # each channel's Pyy and Pxy held to its own max
            for g in (10, 1000):
                yq = y / g
                chan[f"1_to_{g}"] = channel_errs(
                    welch.welch_cuda(x, yq, win, plan.nnyquist, norm, **kw),
                    welch.welch_plain(x, yq, win, plan.nnyquist, norm, **kw))
                del yq
        runs = {"ms": time_runs(lambda: welch.welch_cuda(
                    x, y, win, plan.nnyquist, norm, **kw), 10),
                "plain_ms": time_runs(lambda: welch.welch_plain(
                    x, y, win, plan.nnyquist, norm, **kw), 5)}
        ms, plain_ms = (statistics.median(runs[k]) for k in ("ms", "plain_ms"))
        max_abs = max(e * s for e, s in errs.values())
        prof = (trace_call(lambda: welch.welch_cuda(x, y, win, plan.nnyquist,
                                                    norm, **kw),
                           "welch_pair_kernel") if cfg == 0 else None)
        emit("welch_vs_plain", config=cfg, nch=NCH, nt=nt, nwins=nwins,
             navr=plan.navr, ntaps=0 if taps is None else len(taps),
             rel_err={k: e for k, (e, _) in errs.items()},
             channel_rel_err=chan, max_abs_err=max_abs, tol=WELCH_TOL,
             ms=ms, plain_ms=plain_ms,
             quartiles_ms={k: statistics.quantiles(v, n=4)
                           for k, v in runs.items()})
        for name, (e, _) in errs.items():
            check(e <= WELCH_TOL,
                  f"kernel B config {cfg} {name}: rel err {e} > {WELCH_TOL}")
        for ratio, per in chan.items():
            for name, e in per.items():
                check(max(e) <= WELCH_TOL, f"kernel B config {cfg} {ratio} "
                      f"{name} per channel: {e} > {WELCH_TOL}")
        if cfg == 0:
            emit("welch_profile", config=0, **prof)
            check(prof["kernel_ms"] > 0, "the profiler saw no "
                  "welch_pair_kernel")
            check(prof["h2d_pageable"] == 0,
                  f"kernel B config 0: {prof['h2d_pageable']} pageable host "
                  f"-> device copies in a call after the first")
            nsig = 1 + y.shape[0]
            kernels["welch"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None, kernel_device_ms=prof["kernel_ms"],
                **bound(fir_ops(nt, len(taps), nsig)
                        + profiling.welch_flops(plan.navr, nwins, NCH),
                        4.0 * nsig * (nt + 3 * plan.nnyquist)))

    # ---- main path: counts from here on ---------------------------------- #
    reset_counts()

    # ---- phase 4: config 0 through welch_filtered_cross_spectra ---------- #
    nwins = 2048
    plan = seg.plan_segments(nt0, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1]
    t0 = time.perf_counter()
    out = pt.welch_filtered_cross_spectra(x0, y0, taps0, win, plan, FS)
    wall_fused = time.perf_counter() - t0
    check(welch.LAUNCHES == 1 and fir.LAUNCHES == welch.X_PREFILTERS == 1
          and welch.MEANS_LAUNCHES == 1,
          f"fused chain launched kernel B {welch.LAUNCHES} times, kernel A "
          f"{fir.LAUNCHES} (x filtered ahead {welch.X_PREFILTERS} times), "
          f"the means kernel {welch.MEANS_LAUNCHES} times")
    freq = out["freq"]
    ipk = np.argmax(np.abs(out["Pyy"]), axis=0)          # per channel
    df = FS / nwins
    fpk = freq[ipk]
    coh2 = (np.abs(out["Pxy"][ipk, np.arange(NCH)]) ** 2
            / (np.abs(out["Pxx"][ipk]) * np.abs(out["Pyy"][ipk, np.arange(NCH)])))
    check(np.all(np.isfinite(out["Pyy"])) and np.all(np.isfinite(out["Pxy"])),
          "non-finite spectra")
    check(np.all(np.abs(fpk - 97e3) <= df), f"Pyy peaks at {fpk}")
    check(np.all(coh2 > 0.9), f"|Cxy|^2 at the peak {coh2}")
    # the filter-first route (kernel A, then torch.fft) on the same tensors
    fir_before = fir.LAUNCHES
    t0 = time.perf_counter()
    ref = pt.welch_filtered_cross_spectra(x0, y0, taps0, win, plan, FS,
                                          fft_backend="xla")
    wall_unfused = time.perf_counter() - t0
    check(fir.LAUNCHES > fir_before, "filter-first route did not launch "
          "kernel A")
    errs4 = {k: rel_err(out[k], ref[k])[0] for k in ("Pxx", "Pyy", "Pxy")}
    emit("main_config0", nt=nt0, nch=NCH, nwins=nwins, navr=plan.navr,
         ntaps=len(taps0), peak_hz=fpk.tolist(), coh2_at_peak=coh2.tolist(),
         wall_s_fused=wall_fused, wall_s_filter_first=wall_unfused,
         rel_err_vs_filter_first=errs4, tol=WELCH_TOL)
    for k, e in errs4.items():
        check(e <= WELCH_TOL, f"config 0 {k}: fused vs filter-first {e}")
    del out, ref

    # ---- phase 4b: the means kernel against its plain version ------------ #
    # config 0's signals and taps filter to means near 0, where a wrong
    # means operand would pass every check above; so here each signal has
    # an offset, and the taps are config 0's and a low-pass set (sum 1)
    off = torch.linspace(-2.0, 2.0, NCH + 1, device=dev)
    xm = x0 + off[0]
    ym = y0 + off[1:, None]
    for name, taps in (("band_pass", taps0),
                       ("low_pass", pt.filters.firwin(129, 0.1))):
        t64 = np.asarray(taps, np.float64)
        before = welch.MEANS_LAUNCHES
        got = welch._means(xm, ym, t64, 1, False)
        check(welch.MEANS_LAUNCHES == before + 1,
              f"means {name}: {welch.MEANS_LAUNCHES - before} launches")
        ref = welch._means_plain(xm, ym, t64, 1, False)
        differ = int((got != ref).sum().item())
        want = (off * float(t64.sum())).cpu().numpy()
        dev_from_offset = float(np.abs(got.cpu().numpy() - want).max())
        emit("means_vs_plain", taps=name, nt=nt0, nch=NCH, ntaps=len(taps),
             means=got.tolist(), plain=ref.tolist(), differing=differ,
             max_abs_from_offset=dev_from_offset)
        check(differ == 0, f"means {name}: {differ} values differ from the "
              f"plain version: {got.tolist()} against {ref.tolist()}")
        check(dev_from_offset <= 1e-3, f"means {name}: {got.tolist()}, "
              f"the offsets give {want.tolist()}")
    del xm, ym, got, ref

    # ---- phase 5: config 5 through fft_pwelch ---------------------------- #
    nt5 = x5.shape[0]
    tvec = np.arange(nt5) / FS
    args = dict(tbounds=[tvec[1], tvec[-2]], tper=4096.5 / FS, plotit=False)
    before = welch.LAUNCHES
    t0 = time.perf_counter()
    f_p, Pxy_p, Pxx_p, Pyy_p, C_p, phi_p, info = pt.fft_pwelch(
        tvec, x5, y5, fft_backend="pallas", **args)
    wall_pallas = time.perf_counter() - t0
    check(welch.LAUNCHES == before + 1, "fft_pwelch('pallas') did not "
          "launch kernel B")
    check(info.nwins == 4096, f"nwins resolved to {info.nwins}")
    check("_lazy_segments" in info.__dict__, "per-segment fill not armed")
    t0 = time.perf_counter()
    f_x, Pxy_x, Pxx_x, Pyy_x, C_x, phi_x, info_x = pt.fft_pwelch(
        tvec, x5, y5, fft_backend="xla", **args)
    wall_xla = time.perf_counter() - t0
    check(np.array_equal(f_p, f_x), "freq differs between backends")
    errs5 = {"Pxx": rel_err(Pxx_p, Pxx_x)[0], "Pyy": rel_err(Pyy_p, Pyy_x)[0],
             "Pxy": rel_err(Pxy_p, Pxy_x)[0], "Cxy": rel_err(C_p, C_x)[0],
             "phi_xy": rel_err(phi_p, phi_x)[0]}
    seg_shape = info.Pxx_seg.shape              # fills lazily (xla core)
    check("_lazy_segments" not in info.__dict__, "lazy fill did not run")
    check(seg_shape == (info.Navr, info.Nnyquist), f"Pxx_seg {seg_shape}")
    errs5["Pxx_seg"] = rel_err(info.Pxx_seg, info_x.Pxx_seg)[0]
    emit("main_config5", nt=nt5, nch=NCH, nwins=info.nwins, navr=info.Navr,
         wall_s_pallas=wall_pallas, wall_s_xla=wall_xla,
         rel_err_vs_xla=errs5, tol=WELCH_TOL, Pxx_seg_shape=list(seg_shape))
    for k, e in errs5.items():
        check(e <= WELCH_TOL, f"config 5 {k}: pallas vs xla {e}")
    check(np.all(np.isfinite(Pxx_p)) and np.all(np.isfinite(C_p)),
          "non-finite fft_pwelch outputs")

    launches = {"fir": fir.LAUNCHES, "welch": welch.LAUNCHES}

    # ---- phase 6: kernel C against its plain version --------------------- #
    nt2 = 1 << 24
    chirp2, f_inst = chirp(nt2)
    nt_b = 1 << 22
    rng = np.random.default_rng(SEED + 2)
    tb = np.arange(nt_b) / FS
    iq = (np.exp(2j * np.pi * 97e3 * tb)
          + 0.3 * (rng.standard_normal(nt_b)
                   + 1j * rng.standard_normal(nt_b))).astype(np.complex64)
    # bursty: noise whose odd segments of 1024 have 1/10 (and 1/100,
    # 1/1000) of their neighbours' amplitude
    noise_e = rng.standard_normal(nt_b).astype(np.float32)
    odd = (np.arange(nt_b) // 1024) % 2 == 1
    burst = {g: torch.from_numpy(np.where(odd, noise_e / g, noise_e)
                                 .astype(np.float32)).to(dev)
             for g in (10, 100, 1000)}
    cases = (("a_config2_chirp", torch.from_numpy(chirp2).to(dev), None,
              2048, 1024),
             ("b_iq_complex64", torch.from_numpy(iq).to(dev), None, 4096,
              1024),
             ("c_reference_and_8_channels", x0[:nt_b], y0[:, :nt_b], 512,
              256),
             ("d_odd_navr", x0[:nt_b + 1000], None, 2048, 1024),
             ("e_bursty", burst[10], None, 1024, 1024))
    for name, x, y, nwins, hop in cases:
        nt = x.shape[0]
        navr = (nt - nwins) // hop + 1
        win = np.hanning(nwins + 1)[:-1]
        kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=1)
        got = stft.stft_cuda(x, y, win, 1.0, **kw)
        ref = stft.stft_plain(x, y, win, 1.0, **kw)
        err, scale = rel_err(got, ref)
        max_abs = err * scale
        extra = {}
        if name.startswith("e_"):
            extra["seg_rel_err"] = seg_rel_err(got, ref)
            for g in (100, 1000):
                extra[f"seg_rel_err_1_to_{g}"] = seg_rel_err(
                    stft.stft_cuda(burst[g], None, win, 1.0, **kw),
                    stft.stft_plain(burst[g], None, win, 1.0, **kw))
        del got, ref
        runs = {"ms": time_runs(lambda: stft.stft_cuda(x, y, win, 1.0, **kw),
                                25),
                "plain_ms": time_runs(lambda: stft.stft_plain(
                    x, y, win, 1.0, **kw), 25)}
        prof = {"kernel": trace_call(lambda: stft.stft_cuda(x, y, win, 1.0,
                                                            **kw),
                                     "stft_kernel"),
                "plain": trace_call(lambda: stft.stft_plain(x, y, win, 1.0,
                                                            **kw),
                                    "stft_kernel")}
        lib = None
        if name.startswith("a_"):
            # library: torch.stft of the mean-removed signal
            xm = x - x.mean()
            wt = torch.as_tensor(win, dtype=torch.float32, device=dev)

            def lib():
                return torch.stft(xm, nwins, hop_length=hop, window=wt,
                                  center=False, onesided=False,
                                  return_complex=True)
            runs["library_ms"] = time_runs(lib, 25)
            prof["library"] = trace_call(lib, "stft_kernel")
        ms, plain_ms = (statistics.median(runs[k]) for k in ("ms", "plain_ms"))
        lib_ms = statistics.median(runs["library_ms"]) if lib else None
        nsig = 1 + (0 if y is None else y.shape[0])
        emit("stft_vs_plain", case=name, nsig=nsig, nt=nt, nwins=nwins,
             hop=hop, navr=navr, dtype=str(x.dtype), rel_err=err,
             max_abs_err=max_abs, tol=STFT_TOL, ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms,
             quartiles_ms={k: statistics.quantiles(v, n=4)
                           for k, v in runs.items()},
             out_mb=8 * nsig * navr * nwins / 1e6, **extra)
        emit("stft_profile", case=name, **prof)
        check(err <= STFT_TOL, f"kernel C {name}: rel err {err} > {STFT_TOL}")
        for k, e in extra.items():
            check(e <= STFT_TOL,
                  f"kernel C {name}: {k} {e} > {STFT_TOL}")
        check(prof["kernel"]["kernel_ms"] > 0, "the profiler saw no "
              "stft_kernel")
        check(prof["kernel"]["h2d_pageable"] == 0,
              f"kernel C {name}: {prof['kernel']['h2d_pageable']} pageable "
              f"host -> device copies in a call after the first")
        if name.startswith("a_"):
            del xm
            kernels["stft"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                kernel_device_ms=prof["kernel"]["kernel_ms"],
                **bound(navr * (2 * nwins
                                + profiling.fft_flops(nwins, real=True)),
                        4.0 * nt + 8.0 * navr * nwins))
    del cases, iq, x, y, burst, noise_e, odd
    torch.cuda.empty_cache()

    # ---- second main path: counts from here on --------------------------- #
    reset_counts()

    # ---- phase 7: config 2 through fftanal ------------------------------- #
    t2 = np.arange(nt2) / FS
    kw7 = dict(tper=2048.5 / FS, windowoverlap=0.5, plotit=False,
               verbose=False)
    t0 = time.perf_counter()
    a7 = pt.fftanal(t2, chirp2, **kw7)
    a7.pwelch()
    wall_kernel = time.perf_counter() - t0
    check(a7.nwins == 2048 and a7.Navr == 16383,
          f"nwins {a7.nwins}, Navr {a7.Navr}")
    check(stft.LAUNCHES == 1, f"fftanal.pwelch launched kernel C "
          f"{stft.LAUNCHES} times")
    ipk = np.argmax(np.abs(a7.Xseg), axis=1)
    f_at = 1e3 + (200e3 - 1e3) * (a7.tseg * FS) / nt2
    bins = np.abs(a7.freq[ipk] - f_at) / (FS / a7.nwins)
    check(np.all(bins <= 2), f"chirp peak off f_inst by {bins.max()} bins")
    t0 = time.perf_counter()
    b7 = pt.fftanal(t2, chirp2, fft_backend="xla", **kw7)
    b7.pwelch()
    wall_xla = time.perf_counter() - t0
    check(stft.LAUNCHES == 1, "the 'xla' backend launched kernel C")
    errs7 = {k: rel_err(getattr(a7, k), getattr(b7, k))[0]
             for k in ("Xseg", "Xpow", "tseg", "Pxx")}
    del b7
    s7 = pt.stft(t2, chirp2, tper=2048.5 / FS, windowoverlap=0.5,
                 verbose=False)
    check(stft.LAUNCHES == 2, "spectrogram.stft did not launch kernel C")
    check(np.array_equal(s7.Xseg, a7.Xseg), "pt.stft gave another Xseg")
    del s7
    emit("main_config2", nt=nt2, nwins=a7.nwins, navr=a7.Navr,
         peak_off_bins_max=float(bins.max()),
         wall_s_pwelch_kernel=wall_kernel, wall_s_pwelch_xla=wall_xla,
         rel_err_vs_xla=errs7, tol=STFT_TOL)
    for k, e in errs7.items():
        check(e <= STFT_TOL, f"config 2 {k}: kernel vs xla {e}")
    seg7 = (a7._plan(), a7.win, a7.tseg, a7.Xseg, a7.Xpow)
    del a7

    # ---- phase 8: two signals through fftanal ---------------------------- #
    x8 = x0[:nt2].cpu().numpy()
    y8 = y0[0, :nt2].cpu().numpy()
    kw8 = dict(tper=4096.5 / FS, windowoverlap=0.5, plotit=False,
               verbose=False)
    before = stft.LAUNCHES
    res = {}
    for backend in (None, "xla"):
        t0 = time.perf_counter()
        o = pt.fftanal(t2, x8, y8, fft_backend=backend, **kw8)
        o.pwelch()
        o.crosscorr()
        o.convert2amplitudes()
        res[backend] = (o, time.perf_counter() - t0)
        if backend is None:
            check(stft.LAUNCHES == before + 2, f"two-signal pwelch launched "
                  f"kernel C {stft.LAUNCHES - before} times")
    a8, b8 = res[None][0], res["xla"][0]
    check(stft.LAUNCHES == before + 2, "the 'xla' backend launched kernel C")
    ik = int(np.argmin(np.abs(a8.freq - 97e3)))
    coh = float(np.abs(a8.Cxy[ik]))
    phi = float(a8.phi_xy[ik])
    errs8 = {k: rel_err(getattr(a8, k), getattr(b8, k))[0]
             for k in ("Pxx", "Pyy", "Pxy", "Cxy")}
    finite = all(np.all(np.isfinite(np.asarray(getattr(a8, k))))
                 for k in ("Pxx", "Pyy", "Pxy", "Cxy", "phi_xy", "Rxy",
                           "corrcoef", "Lxx", "Lyy", "Lxy"))
    emit("main_two_signal", nt=nt2, nwins=a8.nwins, navr=a8.Navr,
         Cxy_97k=coh, phi_xy_97k=phi, wall_s_kernel=res[None][1],
         wall_s_xla=res["xla"][1], rel_err_vs_xla=errs8, tol=STFT_TOL)
    check(coh > 0.9 and abs(phi) < 0.1, f"|Cxy| {coh}, phi {phi} at 97 kHz")
    check(finite, "non-finite fftanal outputs")
    for k, e in errs8.items():
        check(e <= STFT_TOL, f"two-signal {k}: kernel vs xla {e}")
    launches["stft"] = stft.LAUNCHES
    check(fir.LAUNCHES == 0 and welch.LAUNCHES == 0,
          "the STFT path launched kernel A or B")
    del res, a8, b8, o

    # ---- config 2's stft_segments, step by step (after the counts) ------- #
    plan7, win7, tt7, X7, p7 = seg7
    split, (tt_s, X_s, p_s) = stft_split(chirp2, t2, plan7, win7)
    check(np.array_equal(X_s, X7) and np.array_equal(p_s, p7)
          and np.array_equal(tt_s, tt7),
          "the timed steps differ from stft_segments")
    emit("config2_stft_segments_split", seconds=split,
         x_host_mb=X_s.nbytes / 1e6)

    del seg7, X7, X_s, p7, p_s
    torch.cuda.empty_cache()

    # ---- phase 9: kernel D against its plain version --------------------- #
    nt4 = 1 << 24
    am4, env4_true, _ = am_signal(nt4)
    rng = np.random.default_rng(SEED + 3)
    # resident blocks an SM for every row length the kernel takes
    occupancy = {M: hk.blocks_per_sm(M)
                 for M in (1 << e for e in range(4, 15))}
    emit("hilbert_occupancy", blocks_per_sm=occupancy,
         ptxas=ptxas_report("hilbert_kernel", named=True))
    check(occupancy[hk.ROW_DEFAULT] >= 2, f"kernel D holds "
          f"{occupancy[hk.ROW_DEFAULT]} blocks an SM at M = "
          f"{hk.ROW_DEFAULT}")
    # config 4 (the main path's split), an odd n1 at full size, a
    # non-power-of-two length, a one-row case, and config 4 split in rows
    # of 16384 (the other candidate for the default split)
    cases = (("a_config4", am4, None),
             ("b_odd_n1", rng.standard_normal(2047 << 13), None),
             ("c_9x2^20", rng.standard_normal(9 << 20), None),
             ("d_small", rng.standard_normal(1 << 12), None),
             ("e_config4_rows_16384", am4, hk.ROW_MAX))
    for name, sig, max_row in cases:
        x = torch.as_tensor(np.asarray(sig, dtype=np.float32), device=dev)
        nt = x.shape[0]
        split = hk.row_split(nt, max_row or hk.ROW_DEFAULT)
        A = torch.fft.fft(x.reshape(split), dim=0).contiguous()
        got = hk.hilbert_cuda(A)
        ref = hk.hilbert_plain(A)
        err_rows, scale = rel_err(got, ref)
        max_abs = err_rows * scale
        del got, ref
        err_z, _ = rel_err(_analytic_factored(x, split),
                           _analytic_factored(x, split, hk.hilbert_plain))
        runs = time_runs(lambda: hk.hilbert_cuda(A),
                         25 if name.startswith("a_") else 5)
        ms = statistics.median(runs)
        plain_ms = time_ms(lambda: hk.hilbert_plain(A))
        device_ms = trace_launches(lambda: hk.hilbert_cuda(A),
                                   "hilbert_kernel")[0]
        # the device chain: outer DFT, kernel D, inverse outer DFT; beside
        # it the same analytic signal through whole-length cuFFT
        chain_ms = time_ms(lambda: _analytic_factored(x, split))
        h = torch.zeros(nt, device=dev)
        h[0] = h[nt // 2] = 1.0
        h[1:(nt + 1) // 2] = 2.0
        err_fft, _ = rel_err(_analytic_factored(x, split),
                             fft_analytic(x.double(), h))
        fft_chain_ms = time_ms(lambda: fft_analytic(x, h))
        emit("hilbert_vs_plain", case=name, nt=nt, n1=split[0], M=split[1],
             rel_err_rows=err_rows, rel_err_analytic=err_z,
             rel_err_vs_fft64=err_fft, max_abs_err=max_abs, tol=HILB_TOL,
             ms=ms, ms_quartiles=statistics.quantiles(runs, n=4),
             plain_ms=plain_ms, kernel_device_ms=device_ms,
             chain_ms=chain_ms, fft_chain_ms=fft_chain_ms,
             chain_beats_fft=chain_ms < fft_chain_ms,
             blocks_per_sm=occupancy[split[1]], gb_moved=16 * nt / 1e9)
        check(err_rows <= HILB_TOL and err_z <= HILB_TOL
              and err_fft <= HILB_TOL,
              f"kernel D {name}: rel err {err_rows} (rows), {err_z} "
              f"(analytic signal), {err_fft} (against float64 cuFFT) > "
              f"{HILB_TOL}")
        if name.startswith("a_"):
            n1, M = split
            kernels["hilbert"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None, kernel_device_ms=device_ms,
                **bound(2 * profiling.fft_flops(M, batch=n1) + 14.0 * nt,
                        16.0 * nt))
        del A, x, h
    del cases, sig
    torch.cuda.empty_cache()

    # ---- third main path: counts from here on ---------------------------- #
    reset_counts()

    # ---- phase 10: config 4 through hilbert_mod.envelope_phase ---------- #
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env4, ph4 = pt.hilbert_mod.envelope_phase(am4)
    wall4 = time.perf_counter() - t0
    check(hk.LAUNCHES == 1, f"envelope_phase launched kernel D "
          f"{hk.LAUNCHES} times")
    launches["hilbert"] = hk.LAUNCHES
    check(fir.LAUNCHES == welch.LAUNCHES == stft.LAUNCHES == 0,
          "the Hilbert path launched kernel A, B or C")
    check(env4.shape == ph4.shape == (nt4,) and env4.dtype == np.float32
          and np.all(np.isfinite(env4)) and np.all(np.isfinite(ph4)),
          "envelope/phase shape, dtype or finiteness")
    core = slice(nt4 // 256, nt4 - nt4 // 256)
    env_dev = float(np.abs(env4[core] - env4_true[core]).max())
    finst = np.diff(np.unwrap(ph4.astype(np.float64))) * FS / (2 * np.pi)
    f_med = float(np.median(finst))
    # the plain route on the same device tensor: the chain with the plain
    # middle (launches nothing)
    xd = torch.as_tensor(am4, device=dev)
    zp = _analytic_factored(xd, rows=hk.hilbert_plain)
    env_p, ph_p = zp.abs().cpu().numpy(), zp.angle().cpu().numpy()
    del xd, zp
    env_err = float(np.abs(env4 - env_p).max() / np.abs(env_p).max())
    keep = env_p > 1e-2 * env_p.max()
    dphi = np.angle(np.exp(1j * (ph4.astype(np.float64) - ph_p)))
    ph_err = float(np.abs(dphi[keep]).max())
    emit("main_config4", nt=nt4, split=list(hk.row_split(nt4)),
         wall_s=wall4, envelope_max_dev_core=env_dev, env_tol=ENV_TOL,
         median_f_inst_hz=f_med, rel_err_env_vs_plain=env_err,
         phase_err_vs_plain_rad=ph_err, tol=HILB_TOL, phase_tol=PHASE_TOL)
    check(env_dev <= ENV_TOL, f"envelope off 1 + 0.5 sin by {env_dev}")
    check(abs(f_med - 50e3) <= 1.0, f"median f_inst {f_med} Hz")
    check(env_err <= HILB_TOL, f"envelope vs plain route {env_err}")
    check(ph_err <= PHASE_TOL, f"phase vs plain route {ph_err} rad")

    # ---- config 4's envelope_phase, step by step (after the counts) ------ #
    split4, (env_s, ph_s) = hilbert_split(am4)
    check(np.array_equal(env_s, env4) and np.array_equal(ph_s, ph4),
          "the timed steps differ from envelope_phase")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.hilbert_mod.envelope_phase(am4)
        walls.append(time.perf_counter() - t0)
    emit("config4_envelope_phase_split", seconds=split4,
         in_mb=am4.nbytes / 1e6, out_mb=(env_s.nbytes + ph_s.nbytes) / 1e6,
         wall_s_first_call=wall4, wall_s_next_calls=walls)
    del env4, ph4, env_p, ph_p, env_s, ph_s, dphi, keep, finst
    torch.cuda.empty_cache()

    # ---- the analysis tier on the card, against the CPU route ------------ #
    nt_a = 1 << 22
    rec = (np.sin(2 * np.pi * 3e3 * np.arange(nt_a) / FS)[:, None]
           + 0.3 * np.random.default_rng(SEED + 4).standard_normal(
               (nt_a, NCH)))
    wall_ds = []
    for _ in range(2):
        t0 = time.perf_counter()
        ds = pt.downsample_efficient(rec, FS, 1e5, device=dev)
        wall_ds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ds0 = pt.downsample_efficient(rec[:, 0], FS, 1e5, device="cpu")
    wall_ds_cpu = time.perf_counter() - t0
    ds_err = float(np.abs(ds[:, 0] - ds0).max() / np.abs(ds0).max())
    check(ds.shape == (len(ds0), NCH) and np.all(np.isfinite(ds)),
          f"downsample_efficient shape {ds.shape}")
    check(ds_err <= IIR_TOL, f"downsample_efficient card vs CPU {ds_err}")
    del rec, ds
    before = stft.LAUNCHES
    t0 = time.perf_counter()
    fd = pt.doppler.test_DopplerSignal(device=dev)
    wall_dop = time.perf_counter() - t0
    dop_launches = stft.LAUNCHES - before
    t0 = time.perf_counter()
    fd0 = pt.doppler.test_DopplerSignal(device="cpu")
    wall_dop_cpu = time.perf_counter() - t0
    # fftanal takes kernel C only inside its geometry; the chain's default
    # segments (33 samples) are outside it, so torch.fft runs
    want_c = int(stft.stft_applicable(fd.nwins, fd._plan().noverlap))
    check(dop_launches == want_c, f"the Doppler chain launched kernel C "
          f"{dop_launches} times, its gate says {want_c}")
    ipk = int(np.argmax(np.abs(np.asarray(fd.Lxx))))
    dop_err = rel_err(np.asarray(fd.Pxx), np.asarray(fd0.Pxx))[0]
    emit("analysis_tier", downsample_efficient=dict(
        nch=NCH, nt=nt_a, fs_new=1e5, wall_s_card=wall_ds,
        wall_s_cpu_one_channel=wall_ds_cpu, rel_err_vs_cpu=ds_err,
        tol=IIR_TOL), doppler=dict(
        navr=fd.Navr, nwins=fd.nwins, kernel_c_launches=dop_launches,
        peak_hz=float(fd.freq[ipk]), wall_s_card=wall_dop,
        wall_s_cpu=wall_dop_cpu, rel_err_Pxx_vs_cpu=dop_err,
        tol=DOPPLER_TOL))
    check(abs(fd.freq[ipk] - 10e3) <= 2 * abs(fd.freq[1] - fd.freq[0]),
          f"Doppler line at {fd.freq[ipk]} Hz")
    check(dop_err <= DOPPLER_TOL, f"Doppler Pxx card vs CPU {dop_err}")
    del fd, fd0
    torch.cuda.empty_cache()

    # ---- phase 11: kernel E against its plain version -------------------- #
    from pyfft_tpu_torch import heatpulse as php
    fs_hp = 40e3
    hp_data = php.synth_heatpulse_data(nch=32, fmod=33.0, fs=fs_hp, T=10.0,
                                       seed=0, tau_damp=TAU_DAMP)
    # the span fft_pwelch analyses (tbounds 0.25 .. 9.75 s)
    span = slice(int(0.25 * fs_hp), int(9.75 * fs_hp) + 1)
    x_hp = torch.as_tensor(hp_data["refsig"][span], dtype=torch.float32,
                           device=dev)
    y_hp = torch.as_tensor(np.ascontiguousarray(hp_data["sig"][span].T),
                           dtype=torch.float32, device=dev)
    x8, y8 = x0[:1 << 22], y0[:, :1 << 22]
    x16, y16 = x0[:1 << 16], y0[:, :1 << 16]
    rng = np.random.default_rng(SEED + 5)
    B11, n11 = 4096, 2047
    xfr = torch.as_tensor(rng.standard_normal((B11, n11)),
                          dtype=torch.float32, device=dev)
    yfr = torch.as_tensor(rng.standard_normal((4, B11, n11)),
                          dtype=torch.float32, device=dev)
    quiet = torch.tensor([1.0, 1e-1, 1e-2, 1e-3], device=dev)[:, None]
    # (a) the heat-pulse geometry, (b) linear detrend at a radix-2 nwins,
    # (c) the pre-framed entry (hop = nwins, no detrend) at an odd nwins,
    # (d) the heat-pulse geometry with four channels at 1:1 to 1:1000 of
    # their amplitude, each held to its own max, (e) nwins 3 (M = 16, 128
    # transforms a block)
    cases = (("a_heatpulse", x_hp, y_hp, 4871, 2435, 155, 1),
             ("b_linear_detrend_radix2", x8, y8, 4096, 2048,
              ((1 << 22) - 4096) // 2048 + 1, -1),
             ("c_preframed_odd", xfr.reshape(-1), yfr.reshape(4, -1), n11,
              n11, B11, 0),
             ("d_channels_1_to_1000", x_hp, y_hp[:4] * quiet, 4871, 2435,
              155, 1),
             ("e_nwins_3", x16, y16, 3, 1, (1 << 16) - 2, 0))
    for name, x, y, nwins, hop, navr, det in cases:
        win = np.hanning(nwins + 1)[:-1]
        nf = (nwins + 1) // 2 if nwins % 2 else nwins // 2
        kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=det)
        if name.startswith("c_"):
            norm = 1.0
            got = welch_v1.welch_power_pallas(xfr, yfr, win, nf)
        else:
            norm = 1.0 / navr
            got = welch_v1.welch_dft_cuda(x, y, win, nf, norm, **kw)
        ref = welch_v1.welch_dft_plain(x, y, win, nf, norm, **kw)
        errs = {"Pxx": rel_err(got[0], ref[0]),
                "Pyy": rel_err(got[1], ref[1]),
                "Pxy": rel_err(torch.complex(got[2], got[3]),
                               torch.complex(ref[2], ref[3]))}
        chan = channel_errs(got, ref) if name.startswith("d_") else None
        del got, ref

        def call():
            return welch_v1.welch_dft_cuda(x, y, win, nf, norm, **kw)
        runs = time_runs(call, 25 if name.startswith("a_") else 5)
        ms = statistics.median(runs)
        plain_ms = time_ms(lambda: welch_v1.welch_dft_plain(x, y, win, nf,
                                                            norm, **kw))
        max_abs = max(e * sc for e, sc in errs.values())
        nsig = 1 + y.shape[0]
        M = welch_v1.bluestein_size(nwins, nf)
        b11 = bound(profiling.welch_flops(navr, nwins, nsig - 1),
                    4.0 * nsig * (x.shape[0] + 3 * nf))
        # the three passes' device time a launch (one chunk: a launch of
        # each a call)
        extra = dict(kernel_device_ms={
            k: trace_launches(call, k)[0]
            for k in ("dft_spectra", "dft_sums", "dft_combine")})
        if name.startswith("a_"):
            # the transforms' floor (two M-point FFTs a segment and signal
            # at the float32 book rate), occupancy and ptxas' report of
            # every instantiation
            lib = _build.library()
            extra.update(
                ms_quartiles=statistics.quantiles(runs, n=4),
                bluestein_floor_ms=bound(
                    profiling.fft_flops(M, batch=2 * nsig * navr),
                    4.0 * nsig * (x.shape[0] + 3 * nf))["bound_ms"],
                blocks_per_sm={m: lib.pyfft_welch_dft_blocks_per_sm(m)
                               for m in (M, welch_v1.MAX_NWINS * 2)},
                ptxas={k: ptxas_report(k, named=True)
                       for k in ("dft_spectra", "dft_sums", "dft_combine")})
        emit("welch_dft_vs_plain", case=name, nsig=nsig, nt=x.shape[0],
             nwins=nwins, hop=hop, navr=navr, detrend_style=det,
             fft_points=M, rel_err={k: e for k, (e, _) in errs.items()},
             channel_rel_err=chan, max_abs_err=max_abs, tol=DFT_TOL, ms=ms,
             plain_ms=plain_ms, **extra, **b11)
        for k, (e, _) in errs.items():
            check(e <= DFT_TOL, f"kernel E {name} {k}: rel err {e} > "
                  f"{DFT_TOL}")
        for k, e in (chan or {}).items():
            check(max(e) <= DFT_TOL, f"kernel E {name} {k} per channel: "
                  f"{e} > {DFT_TOL}")
        if name.startswith("a_"):
            check(M == 8192, f"kernel E ran {M} points at the heat-pulse "
                  f"geometry")
            check(extra["blocks_per_sm"][M] >= 2, f"kernel E holds "
                  f"{extra['blocks_per_sm'][M]} blocks an SM at M = {M}")
            kernels["welch_dft"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None,
                kernel_device_ms=sum(extra["kernel_device_ms"].values()),
                **b11)
    del cases, x, y, xfr, yfr, x8, y8, x16, y16
    torch.cuda.empty_cache()

    # ---- fourth main path: counts from here on --------------------------- #
    reset_counts()

    # ---- phase 12: HeatPulseFFT at full size ------------------------------ #
    runs = {}
    for backend in ("pallas", "xla"):
        drv = php.HeatPulseFFT(dict(HP_RUNINFO), dict(hp_data))
        drv.PreCheck()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.run(fft_backend=backend)
        torch.cuda.synchronize()
        runs[backend] = (drv, time.perf_counter() - t0)
        if backend == "pallas":
            check(welch_v1.LAUNCHES == 1 and welch.LAUNCHES == 0,
                  f"the heat-pulse run launched kernel E "
                  f"{welch_v1.LAUNCHES} times and kernel B "
                  f"{welch.LAUNCHES} times")
            launches["welch_dft"] = welch_v1.LAUNCHES
    check(welch_v1.LAUNCHES == 1 and fir.LAUNCHES == welch.LAUNCHES
          == stft.LAUNCHES == hk.LAUNCHES == 0,
          "the 'xla' run launched a kernel")
    drv, wall_run = runs["pallas"]
    # fft_pwelch's plan, read from its bins (Nnyquist of them, fs/nwins
    # apart; the settings' own nwins rounds the periods otherwise)
    nwins_hp = int(round(fs_hp / float(drv.freq[1] - drv.freq[0])))
    noverlap_hp = seg.get_noverlap(nwins_hp, drv.overlap)
    check((nwins_hp, noverlap_hp, int(drv.Navr), drv.nf)
          == (4871, 2436, 155, 2436),
          f"fft_pwelch planned nwins {nwins_hp}, noverlap {noverlap_hp}, "
          f"Navr {drv.Navr}, Nnyquist {drv.nf}")
    amp1 = drv.Amp[:, 0]
    dlag = np.diff(np.unwrap(drv.Phase[:, 0]))
    lag_want = 2 * np.pi * 33.0 * 2.0e-3
    ref_drv = runs["xla"][0]
    errs12 = {f: float(np.abs(getattr(drv, f) - getattr(ref_drv, f)).max())
              for f in ("Amp", "Phase", "Coh")}
    check(np.all(np.isfinite(drv.Amp)) and np.all(np.isfinite(drv.Phase)),
          "non-finite heat-pulse results")
    check(np.all(np.diff(amp1) < 0), "fundamental amplitude does not decay")
    check(np.all(np.abs(dlag / lag_want - 1) <= 0.05),
          f"phase lag per channel {dlag} against {lag_want}")
    check(abs(drv.fmods[0] - 33.0) < 2.0, f"fmods[0] = {drv.fmods[0]}")
    check(drv.Coh[0, 0] > 0.95, f"Coh[0, 0] = {drv.Coh[0, 0]}")
    for f, e in errs12.items():
        check(e <= HP_TOL, f"heat-pulse {f}: kernel vs xla {e}")
    # one more kernel-route run under torch.profiler (after the counts).
    # The wall of run(), split by the ranges that heatpulse and fft_pwelch
    # mark (host clock): the Welch call = host -> device of the float64
    # inputs + the device core (float32 cast and transposed copy, kernel E
    # with its prologue, the small copies back, which synchronize) + the
    # host float64 finalization; the rest of run() is the host integration.
    # The device's busy time: its own kernel and copy events (CPU ops and
    # the ranges' device-side copies carry their kernels' time too and are
    # left out).
    stages = ("heatpulse.fft_pwelch", "fft_pwelch.h2d",
              "fft_pwelch.device_core")
    with tempfile.TemporaryDirectory() as logdir, \
            profiling.trace(logdir) as tr:
        drv = php.HeatPulseFFT(dict(HP_RUNINFO), dict(hp_data))
        drv.PreCheck()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.run(fft_backend="pallas")
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    cuda_t = torch.autograd.DeviceType.CUDA
    device_us, host = {}, {}
    for e in tr.key_averages():
        if e.key in stages and e.device_type != cuda_t:
            host[e.key] = (e.cpu_time_total / 1e6, e.count)
        elif e.device_type == cuda_t and e.key not in stages \
                and not getattr(e, "is_user_annotation", False):
            device_us[e.key] = e.self_device_time_total
    check(all(host.get(k, (0, 0))[1] == 1 for k in stages),
          f"profiler ranges {host}, want each of {stages} once")
    busy_s = sum(device_us.values()) / 1e6
    kernel_e_s = sum(v for k, v in device_us.items() if "dft_" in k) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    t_pw, t_h2d, t_core = (host[k][0] for k in stages)
    emit("main_heatpulse", nch=32, fs=fs_hp, T_s=10.0, tau_damp=TAU_DAMP,
         nwins=nwins_hp, navr=int(drv.Navr), noverlap=noverlap_hp,
         fmods=drv.fmods.tolist(), coh_00=float(drv.Coh[0, 0]),
         amp_fundamental=amp1.tolist(),
         dlag_rel_err_max=float(np.abs(dlag / lag_want - 1).max()),
         abs_err_vs_xla=errs12, tol=HP_TOL,
         wall_s_run_pallas=wall_run, wall_s_run_xla=runs["xla"][1])
    emit("heatpulse_profile", wall_s=wall_traced, device_busy_s=busy_s,
         device_idle_share=1 - busy_s / wall_traced,
         wall_s_split={
             "fft_pwelch": t_pw, "h2d": t_h2d, "device_core": t_core,
             "kernel_e_device": kernel_e_s,
             "host_finalization": t_pw - t_h2d - t_core,
             "host_integration": wall_traced - t_pw},
         top_device_ms={k: v / 1e3 for k, v in top})
    check(busy_s > 0 and kernel_e_s > 0, "the profiler saw no device time")
    del runs, drv, ref_drv, hp_data, x_hp, y_hp, tr
    torch.cuda.empty_cache()

    # ---- phase 13: kernels F and G, then measure_pipeline_overlap -------- #
    nrows, ncols, rows_blk, passes = 65536, 1152, 512, 12
    xp = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (nrows, ncols)), dtype=torch.float32, device=dev)
    Tp = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (probe.GROUP, probe.GROUP)) / 16.0, device=dev).to(torch.bfloat16)
    err, scale = rel_err(probe.colsum_cuda(xp, rows_blk),
                         probe.colsum_plain(xp, rows_blk))
    f_runs = time_runs(lambda: probe.colsum_cuda(xp, rows_blk), 25)
    ms = statistics.median(f_runs)
    plain_ms = time_ms(lambda: probe.colsum_plain(xp, rows_blk))
    lib_runs = time_runs(lambda: torch.sum(xp, 0, keepdim=True), 25)
    lib_ms = statistics.median(lib_runs)
    b13 = bound(float(nrows * ncols), 4.0 * (nrows + 1) * ncols)
    emit("probe_vs_plain", kernel="colsum", nrows=nrows, N=ncols,
         rows_blk=rows_blk, rel_err=err, max_abs_err=err * scale,
         tol=COLSUM_TOL, ms=ms, ms_quartiles=statistics.quantiles(f_runs, n=4),
         plain_ms=plain_ms, library_ms=lib_ms,
         library_ms_quartiles=statistics.quantiles(lib_runs, n=4), **b13)
    check(err <= COLSUM_TOL, f"kernel colsum: rel err {err} > {COLSUM_TOL}")
    kernels["colsum"] = dict(max_abs_err=err * scale, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, **b13)

    # kernel G: on the probe's inputs (dense T) at 12 passes and at one,
    # then on two-tap T, where the order of the float32 sums cannot matter
    def g_case(x, T, npass, resident, tol):
        got = probe.chain_cuda(x, T, rows_blk, npass, resident)
        ref = probe.chain_plain(x, T, rows_blk, npass, resident)
        e, sc = rel_err(got, ref)
        check(bool(torch.isfinite(got).all().item())
              and got.shape == (1, ncols), "kernel chain: bad output")
        check(e <= tol, f"kernel chain ({npass} passes, resident "
              f"{resident}): rel err {e} > {tol}")
        return e, sc, ref

    T2 = probe.two_tap_T(2, dev)
    cases = {}
    for label, T, npass, resident, tol in (
            ("dense", Tp, passes, False, CHAIN_ORDER_TOL),
            ("dense_resident", Tp, passes, True, CHAIN_ORDER_TOL),
            ("dense_1pass", Tp, 1, False, CHAIN_TOL),
            ("two_tap", T2, passes, False, CHAIN_TOL),
            ("two_tap_resident", T2, passes, True, CHAIN_TOL),
            ("two_tap_1pass", T2, 1, False, CHAIN_TOL)):
        e, sc, ref = g_case(xp, T, npass, resident, tol)
        ctl = None
        if not resident:   # the control: no bf16 re-rounding between passes
            ctl, _ = rel_err(chain_unrounded(xp, T, rows_blk, npass), ref)
        cases[label] = dict(rel_err=e, max_abs_err=e * sc, tol=tol,
                            control_rel_err=ctl)
        if label.startswith("two_tap") and ctl is not None:
            check(ctl > 10 * CHAIN_TOL, f"{label}: a chain without the bf16 "
                  f"re-rounding is within {ctl} of the plain version")
    check(cases["dense"]["control_rel_err"] > 10 * CHAIN_TOL,
          "dense: a chain without the bf16 re-rounding is within "
          f"{cases['dense']['control_rel_err']} of the plain version")
    emit("chain_control", cases=cases, tol=CHAIN_TOL,
         order_tol=CHAIN_ORDER_TOL,
         flip_share_1pass=chain_flip_share(Tp, 9216, 3))

    fl13 = 2.0 * nrows * passes * probe.GROUP * ncols
    b13 = bound(fl13, 4.0 * (nrows + 1) * ncols, "bf16")
    g_runs = time_runs(lambda: probe.chain_cuda(xp, Tp, rows_blk, passes), 25)
    ms = statistics.median(g_runs)
    ms_res = time_ms(lambda: probe.chain_cuda(xp, Tp, rows_blk, passes,
                                              True), 25)
    plain_ms = time_ms(lambda: probe.chain_plain(xp, Tp, rows_blk, passes))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cub_err, _ = rel_err(cublas_chain(xp, Tp, passes),
                         probe.chain_plain(xp, Tp, rows_blk, passes))
    cub_ms = time_ms(lambda: cublas_chain(xp, Tp, passes), 25)
    dms13, tr13 = trace_launches(
        lambda: probe.chain_cuda(xp, Tp, rows_blk, passes), "chain_kernel")
    peak_bf16 = profiling.peak_tflops("bf16", smi)
    emit("probe_vs_plain", kernel="chain", nrows=nrows, N=ncols,
         rows_blk=rows_blk, passes=passes, rel_err=cases["dense"]["rel_err"],
         max_abs_err=cases["dense"]["max_abs_err"], tol=CHAIN_ORDER_TOL,
         ms=ms, ms_quartiles=statistics.quantiles(g_runs, n=4),
         resident_ms=ms_res, plain_ms=plain_ms,
         cublas_chain_ms=cub_ms, cublas_chain_calls=passes,
         cublas_chain_rel_err=cub_err,
         tflops=fl13 / ms / 1e9, bf16_book_share=fl13 / ms / 1e9 / peak_bf16,
         kernel_device_ms=dms13, traced_launches=tr13["kernel_launches"],
         ptxas=ptxas_report("chain"),
         device_idle_share=tr13["device_idle_share"],
         top_device_ms=tr13["top_device_ms"], library_ms=None, **b13)
    check(tr13["kernel_ms"] > 0, "the profiler saw no kernel G time")
    kernels["chain"] = dict(max_abs_err=cases["dense"]["max_abs_err"], ms=ms,
                            plain_ms=plain_ms, library_ms=None, **b13)
    del xp, Tp, T2
    torch.cuda.empty_cache()

    # ---- fifth main path: counts from here on ---------------------------- #
    reset_counts()
    ov = profiling.measure_pipeline_overlap()
    launches["colsum"] = probe.LAUNCHES["colsum"]
    launches["chain"] = probe.LAUNCHES["chain"]
    check(fir.LAUNCHES == welch.LAUNCHES == stft.LAUNCHES == hk.LAUNCHES
          == welch_v1.LAUNCHES == 0,
          "measure_pipeline_overlap launched a Welch/STFT/Hilbert kernel")
    hbm_gbs = profiling.device_peaks(smi)[2]
    emit("main_pipeline_overlap", **ov, hbm_gbs_book=hbm_gbs,
         launches={"colsum": launches["colsum"], "chain": launches["chain"]})
    check(ov["read_gbs"] <= 1.05 * hbm_gbs,
          f"read {ov['read_gbs']} GB/s above 1.05 x the book's {hbm_gbs}")
    mxu_book = profiling.device_peaks(smi)[0]
    emit("pipeline_overlap_share", mxu_tflops_book=mxu_book,
         mxu_book_share=ov["mxu_tflops"] / mxu_book)
    check(ov["mxu_tflops"] <= 1.05 * mxu_book,
          f"{ov['mxu_tflops']} TFLOP/s above 1.05 x the book's {mxu_book}")
    check(all(np.isfinite(v) for v in ov.values()),
          "non-finite overlap measurement")

    torch.cuda.empty_cache()

    # ---- phase 14: config 1, kernel H against B at nch = 0 and plain ----- #
    nt1 = 1 << 24
    x1 = x0[:nt1]
    plan1 = seg.plan_segments(nt1, nwins=4096, windowoverlap=0.5)
    win1 = np.hanning(4097)[:-1]
    s1 = seg.get_s1(win1)
    norm1 = 1.0 / (s1 ** 2 * seg.get_enbw(FS, s1, seg.get_s2(win1))
                   * plan1.navr)
    check(welch_packed.packed_parts_geometry(plan1.navr, 4096, plan1.noverlap)
          is not None, "config 1 outside the packed entry's domain")
    none1 = x1.new_empty((0, nt1))
    for taps in (None, taps0):
        kw = dict(navr=plan1.navr, nwins=4096, noverlap=plan1.noverlap,
                  taps=taps, detrend_style=1)
        kwh = dict(kw, hop=plan1.hop)
        del kwh["noverlap"]

        def packed():
            return welch_packed.welch_auto_packed(x1, win1, plan1.nnyquist,
                                                  norm1, **kw)

        def plain():
            return welch.welch_plain(x1, none1, win1, plan1.nnyquist, norm1,
                                     **kwh)[0]

        def kernel_b():
            return welch.welch_fir_pallas_fused(x1, none1, win1,
                                                plan1.nnyquist, norm1, **kw)

        err, scale = rel_err(packed(), plain())
        err_b = rel_err(kernel_b()[0], plain())[0]
        # 25 runs each (5 in earlier rounds, where H and B moved by a
        # quarter between two calls), and the spread
        spread = {}
        for what, fn in (("ms", packed), ("plain_ms", plain),
                         ("kernel_b_nch0_ms", kernel_b)):
            spread[what] = time_runs(fn, 25)
        ms, plain_ms, b_ms = (statistics.median(spread[k]) for k in
                              ("ms", "plain_ms", "kernel_b_nch0_ms"))
        ntaps = 0 if taps is None else len(taps)
        b14 = bound((0 if taps is None else fir_ops(nt1, ntaps, 1))
                    + profiling.welch_packed_flops(plan1.navr, 4096),
                    4.0 * (nt1 + plan1.nnyquist))
        emit("welch_packed_vs_plain", config=1, nt=nt1, nwins=4096,
             navr=plan1.navr, ntaps=ntaps, rel_err=err,
             max_abs_err=err * scale, rel_err_kernel_b=err_b, tol=WELCH_TOL,
             ms=ms, plain_ms=plain_ms, kernel_b_nch0_ms=b_ms,
             quartiles_ms={k: statistics.quantiles(v, n=4)
                           for k, v in spread.items()},
             clocks=smi_query("clocks.sm,clocks.max.sm,power.draw,"
                              "temperature.gpu"), **b14)
        check(err <= WELCH_TOL, f"kernel H config 1 K={ntaps}: rel err {err}")
        check(err_b <= WELCH_TOL, f"kernel B nch=0 K={ntaps}: rel err {err_b}")
        # one traced call of each: its wall, the device's busy time by
        # kernel or copy, and the share of the wall the device was idle
        prof14 = {}
        for what, fn in (("kernel_h", packed), ("kernel_b_nch0", kernel_b),
                         ("plain", plain)):
            prof14[what] = trace_call(fn, "welch_pair_kernel")
            prof14[what]["welch_pair_kernel_ms"] = prof14[what].pop(
                "kernel_ms")
        emit("welch_packed_profile", config=1, ntaps=ntaps, **prof14)
        check(prof14["kernel_h"]["welch_pair_kernel_ms"] > 0
              and prof14["kernel_b_nch0"]["welch_pair_kernel_ms"] > 0,
              "the profiler saw no welch_pair_kernel")
        if taps is None:
            kernels["welch_packed"] = dict(
                max_abs_err=err * scale, ms=ms, plain_ms=plain_ms,
                library_ms=None,
                kernel_device_ms=prof14["kernel_h"]["welch_pair_kernel_ms"],
                **b14)
        check(prof14["kernel_h"]["h2d_pageable"] == 0,
              f"kernel H config 1: {prof14['kernel_h']['h2d_pageable']} "
              f"pageable host -> device copies in a call after the first")

    # ---- sixth main path: config 1 through welch_auto_packed ------------ #
    reset_counts()
    t0 = time.perf_counter()
    Pxx1 = welch_packed.welch_auto_packed(
        x1, win1, plan1.nnyquist, norm1, navr=plan1.navr, nwins=4096,
        noverlap=plan1.noverlap, detrend_style=1).cpu().numpy()
    wall1 = time.perf_counter() - t0
    check(welch.PACKED_LAUNCHES == 1 and welch.LAUNCHES == 0,
          f"config 1 launched kernel H {welch.PACKED_LAUNCHES} times and "
          f"kernel B {welch.LAUNCHES} times")
    launches["welch_packed"] = welch.PACKED_LAUNCHES
    psd1 = Pxx1 * np.where((np.arange(plan1.nnyquist) > 0)
                           & (np.arange(plan1.nnyquist) < 2048), 2.0, 1.0)
    df1 = FS / 4096
    f_pk1 = float(np.argmax(psd1) * df1)
    var1 = float(x1.double().var().item())
    parseval = float(psd1.sum() * df1 / var1)
    emit("main_config1", nt=nt1, nwins=4096, navr=plan1.navr,
         peak_hz=f_pk1, sum_psd_df_over_var=parseval, tol=PARSEVAL_TOL,
         wall_s=wall1)
    check(np.all(np.isfinite(psd1)), "non-finite config-1 PSD")
    check(abs(f_pk1 - 97e3) <= df1, f"config 1 peak at {f_pk1} Hz")
    check(abs(parseval - 1) <= PARSEVAL_TOL,
          f"config 1 sum(Pxx) df / var(x) = {parseval}")

    # ---- phase 15: the PYFFT_PACKED route on one real pair --------------- #
    import os
    from pyfft_tpu_torch.spectral import pallas_route
    xp15 = x0[:nt1 + LAG]
    x15 = xp15[LAG:].contiguous()
    y15 = xp15[:nt1] + 0.1 * torch.as_tensor(
        np.random.default_rng(SEED + 6).standard_normal(nt1),
        dtype=torch.float32, device=dev)
    hop15 = plan1.hop

    def pair_kernel():
        return welch.welch_cuda(x15, y15[None], win1, plan1.nnyquist, norm1,
                                navr=plan1.navr, nwins=4096, hop=hop15,
                                detrend_style=1, packed=True)

    def pair_plain():
        return welch.welch_plain(x15, y15[None], win1, plan1.nnyquist, norm1,
                                 navr=plan1.navr, nwins=4096, hop=hop15,
                                 detrend_style=1)

    def pair_b():
        return welch.welch_cuda(x15, y15[None], win1, plan1.nnyquist, norm1,
                                navr=plan1.navr, nwins=4096, hop=hop15,
                                detrend_style=1)

    got, ref = pair_kernel(), pair_plain()
    errs15 = {"Pxx": rel_err(got[0], ref[0]), "Pyy": rel_err(got[1], ref[1]),
              "Pxy": rel_err(torch.complex(got[2], got[3]),
                             torch.complex(ref[2], ref[3]))}
    del got, ref
    ms15, plain15, b15 = (time_ms(pair_kernel), time_ms(pair_plain),
                          time_ms(pair_b))
    emit("welch_packed_pair_vs_plain", nt=nt1, nwins=4096, navr=plan1.navr,
         rel_err={k: e for k, (e, _) in errs15.items()}, tol=WELCH_TOL,
         ms=ms15, plain_ms=plain15, kernel_b_nch1_ms=b15,
         **bound(profiling.welch_packed_flops(plan1.navr, 4096, pair=True),
                 8.0 * nt1 + 16.0 * plan1.nnyquist))
    for k, (e, _) in errs15.items():
        check(e <= WELCH_TOL, f"kernel H pair {k}: rel err {e}")

    # ---- seventh main path: welch_cross_spectra with PYFFT_PACKED=1 ------ #
    reset_counts()
    before_env = os.environ.get("PYFFT_PACKED")
    os.environ["PYFFT_PACKED"] = "1"
    try:
        route = pallas_route(nwins=4096, noverlap=plan1.noverlap,
                             navr=plan1.navr, nnyquist=plan1.nnyquist,
                             onesided=True, detrend_style=1, ntmodel=False,
                             is_cplx=False, nch=1)
        t0 = time.perf_counter()
        out15 = pt.welch_cross_spectra(x15, y15, win1, plan1, FS,
                                       fft_backend="pallas")
        wall_h = time.perf_counter() - t0
    finally:
        if before_env is None:
            del os.environ["PYFFT_PACKED"]
        else:
            os.environ["PYFFT_PACKED"] = before_env
    check(route == "H", f"pallas_route gave {route!r} with PYFFT_PACKED=1")
    check(welch.PACKED_LAUNCHES == 1 and welch.LAUNCHES == 0,
          f"the PYFFT_PACKED route launched kernel H {welch.PACKED_LAUNCHES}"
          f" times and kernel B {welch.LAUNCHES} times")
    launches["welch_packed"] += welch.PACKED_LAUNCHES
    t0 = time.perf_counter()
    ref15 = pt.welch_cross_spectra(x15, y15, win1, plan1, FS,
                                   fft_backend="pallas")
    wall_b = time.perf_counter() - t0
    check(welch.LAUNCHES == 1, "without PYFFT_PACKED the pair took no B")
    errs15r = {k: rel_err(out15[k], ref15[k])[0]
               for k in ("Pxx", "Pyy", "Pxy")}
    f15 = out15["freq"]
    ik = int(np.argmax(np.abs(out15["Pxy"][:, 0])))
    coh15 = float(np.abs(out15["Pxy"][ik, 0]) ** 2
                  / (np.abs(out15["Pxx"][ik]) * np.abs(out15["Pyy"][ik, 0])))
    phi15 = float(np.angle(out15["Pxy"][ik, 0]))
    phi_want = -2 * np.pi * 97e3 * LAG / FS
    dphi15 = float(abs(np.angle(np.exp(1j * (phi15 - phi_want)))))
    emit("main_pair_route", nt=nt1, nwins=4096, navr=plan1.navr, route=route,
         peak_hz=float(f15[ik]), coh2_at_peak=coh15, phase_at_peak=phi15,
         phase_want=phi_want, phase_tol=LAG_PHASE_TOL,
         rel_err_vs_kernel_b=errs15r, tol=WELCH_TOL, wall_s_route_h=wall_h,
         wall_s_route_b=wall_b)
    for k, e in errs15r.items():
        check(e <= WELCH_TOL, f"pair route {k}: H vs B {e}")
    check(abs(f15[ik] - 97e3) <= FS / 4096, f"pair peak at {f15[ik]} Hz")
    check(coh15 > 0.9, f"pair |Cxy|^2 at the line {coh15}")
    check(dphi15 <= LAG_PHASE_TOL, f"pair phase {phi15} vs {phi_want}")
    del x15, y15, xp15, out15, ref15, x1, none1
    torch.cuda.empty_cache()

    # ---- phase 16: kernel B at the JAX package's v2-only geometries ------ #
    # (its v2 gate holds at both, tests/test_torch_welch_v2.py; its v3 gate
    # fails, checked below)
    nt16a = 1 << 22
    cases16 = (("a_2048_every_128", x0[:nt16a], y0[:, :nt16a], 2048, 1920,
                taps0),
               ("b_16384_every_8192", x0[:nt1], y0[:, :nt1], 16384, 8192,
                None))
    for name, x, y, nwins, nov, taps in cases16:
        nt = x.shape[0]
        hop = nwins - nov
        navr = (nt - nwins) // hop + 1
        check(welch_packed._v3_geometry(nwins, nov, NCH) is None,
              f"{name} is a v3 geometry")
        win = np.hanning(nwins + 1)[:-1]
        nf = nwins // 2 + 1
        kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps,
                  detrend_style=1)
        got = welch.welch_cuda(x, y, win, nf, 1.0 / navr, **kw)
        ref = welch.welch_plain(x, y, win, nf, 1.0 / navr, **kw)
        errs = {"Pxx": rel_err(got[0], ref[0]),
                "Pyy": rel_err(got[1], ref[1]),
                "Pxy": rel_err(torch.complex(got[2], got[3]),
                               torch.complex(ref[2], ref[3]))}
        del got, ref
        ms = time_ms(lambda: welch.welch_cuda(x, y, win, nf, 1.0 / navr,
                                              **kw))
        plain_ms = time_ms(lambda: welch.welch_plain(x, y, win, nf,
                                                     1.0 / navr, **kw))
        max_abs = max(e * sc for e, sc in errs.values())
        nsig = 1 + y.shape[0]
        ntaps = 0 if taps is None else len(taps)
        b16 = bound((fir_ops(nt, ntaps, nsig) if ntaps else 0)
                    + profiling.welch_flops(navr, nwins, NCH),
                    4.0 * nsig * (nt + 3 * nf))
        emit("welch_v2_vs_plain", case=name, nch=NCH, nt=nt, nwins=nwins,
             noverlap=nov, navr=navr, ntaps=ntaps,
             rel_err={k: e for k, (e, _) in errs.items()},
             max_abs_err=max_abs, tol=WELCH_TOL, ms=ms, plain_ms=plain_ms,
             **b16)
        for k, (e, _) in errs.items():
            check(e <= WELCH_TOL, f"kernel B {name} {k}: rel err {e}")
        if name.startswith("a_"):
            prof16 = trace_call(lambda: welch.welch_cuda(
                x, y, win, nf, 1.0 / navr, **kw), "welch_pair_kernel")
            emit("welch_v2_profile", case=name, **prof16)
            check(prof16["kernel_ms"] > 0, "the profiler saw no "
                  "welch_pair_kernel at the v2 geometry")
            kernels["welch_v2"] = dict(max_abs_err=max_abs, ms=ms,
                                       plain_ms=plain_ms, library_ms=None,
                                       kernel_device_ms=prof16["kernel_ms"],
                                       **b16)
    del cases16, x, y
    torch.cuda.empty_cache()

    # ---- eighth main path: a v2 geometry through the fused chain --------- #
    reset_counts()
    plan16 = seg.plan_segments(nt16a, nwins=2048, windowoverlap=0.9375)
    check(plan16.noverlap == 1920, f"noverlap {plan16.noverlap}")
    win16 = np.hanning(2049)[:-1]
    t0 = time.perf_counter()
    out16 = pt.welch_filtered_cross_spectra(x0[:nt16a], y0[:, :nt16a], taps0,
                                            win16, plan16, FS)
    wall16 = time.perf_counter() - t0
    check(welch.LAUNCHES == 1 and fir.LAUNCHES == welch.X_PREFILTERS == 1
          and welch.MEANS_LAUNCHES == 1,
          f"the v2 geometry launched kernel B {welch.LAUNCHES} times, "
          f"kernel A {fir.LAUNCHES} times (x filtered ahead "
          f"{welch.X_PREFILTERS} times), the means kernel "
          f"{welch.MEANS_LAUNCHES} times")
    launches["welch_v2"] = welch.LAUNCHES
    ipk16 = np.argmax(np.abs(out16["Pyy"]), axis=0)
    fpk16 = out16["freq"][ipk16]
    coh16 = (np.abs(out16["Pxy"][ipk16, np.arange(NCH)]) ** 2
             / (np.abs(out16["Pxx"][ipk16])
                * np.abs(out16["Pyy"][ipk16, np.arange(NCH)])))
    emit("main_v2_geometry", nt=nt16a, nch=NCH, nwins=2048, noverlap=1920,
         navr=plan16.navr, ntaps=len(taps0), peak_hz=fpk16.tolist(),
         coh2_at_peak=coh16.tolist(), wall_s=wall16)
    check(np.all(np.isfinite(out16["Pyy"])) and np.all(np.isfinite(
        out16["Pxy"])), "non-finite v2-geometry spectra")
    check(np.all(np.abs(fpk16 - 97e3) <= FS / 2048), f"Pyy peaks at {fpk16}")
    check(np.all(coh16 > 0.9), f"|Cxy|^2 at the peak {coh16}")
    del out16

    # ---- phase 17: kernel I, the FIR-transpose feeder -------------------- #
    nrows17 = (1 << 18) + 512
    nr17 = nt0 // 128
    C17 = NCH + 1
    sub17 = welch._means(x0, y0, np.asarray(taps0, np.float64), 1,
                         False).repeat_interleave(128)[None]
    got = fir.fir_t_cuda(x0, y0, taps0, nrows17, sub17)
    ref = fir.fir_transpose_plain(x0, y0, taps0, nrows17, sub17)
    err17, scale17 = rel_err(got, ref)
    tail17 = int(torch.count_nonzero(got[nr17:]).item())
    del got, ref
    torch.cuda.empty_cache()
    runs17 = time_runs(
        lambda: fir.fir_t_cuda(x0, y0, taps0, nrows17, sub17), 25)
    ms17 = statistics.median(runs17)
    plain17 = time_ms(lambda: fir.fir_transpose_plain(x0, y0, taps0, nrows17,
                                                      sub17))
    b17 = bound(fir_ops(nt0, len(taps0), C17),
                4.0 * C17 * nt0 + 4.0 * nrows17 * C17 * 128)
    dms17, tr17 = trace_launches(
        lambda: fir.fir_t_cuda(x0, y0, taps0, nrows17, sub17), "fir_t_kernel")
    # kernels A and I run one loop on one staging plan: I without sub,
    # de-interleaved, is A bit for bit on the config-0 signals
    a17 = fir.fir_cuda(torch.cat([x0[None], y0]), taps0)
    i17 = fir.fir_t_cuda(x0, y0, taps0, nr17).reshape(
        nr17, C17, 128).permute(1, 0, 2).reshape(C17, nt0)
    same17 = bool(torch.equal(a17, i17))
    differ17 = int((a17 != i17).sum().item())
    del a17, i17
    emit("fir_t_vs_plain", nt=nt0, C=C17, K=len(taps0), nrows_out=nrows17,
         rel_err=err17, max_abs_err=err17 * scale17, tol=FIR_T_TOL,
         tail_nonzero=tail17, ms=ms17,
         ms_quartiles=statistics.quantiles(runs17, n=4), plain_ms=plain17,
         kernel_device_ms=dms17, traced_launches=tr17["kernel_launches"],
         ptxas=ptxas_report("fir_t_kernel"), a_equals_i=same17,
         a_i_differing=differ17, **b17)
    check(err17 <= FIR_T_TOL, f"kernel I: rel err {err17} > {FIR_T_TOL}")
    check(tail17 == 0, f"kernel I: {tail17} non-zero values past the signal")
    check(same17, f"kernels A and I differ at {differ17} outputs")
    kernels["fir_t"] = dict(max_abs_err=err17 * scale17, ms=ms17,
                            plain_ms=plain17, library_ms=None, **b17)

    # ---- ninth main path: fir_transpose_pallas --------------------------- #
    reset_counts()
    t0 = time.perf_counter()
    out17 = fir.fir_transpose_pallas(x0, y0, taps0, nrows17, sub_row=sub17)
    torch.cuda.synchronize()
    wall17 = time.perf_counter() - t0
    check(fir.FIR_T_LAUNCHES == 1 and fir.LAUNCHES == 0,
          f"fir_transpose_pallas launched kernel I {fir.FIR_T_LAUNCHES} "
          f"times and kernel A {fir.LAUNCHES} times")
    launches["fir_t"] = fir.FIR_T_LAUNCHES
    # each channel's signal rows average to 0 once the filtered means are
    # subtracted; the tail is exactly zero
    row_means = out17[:nr17].double().mean(0).reshape(C17, 128).mean(-1)
    mean_dev = float(row_means.abs().max().item())
    tail_main = int(torch.count_nonzero(out17[nr17:]).item())
    emit("main_fir_transpose", nt=nt0, C=C17, nrows_out=nrows17,
         max_abs_channel_mean=mean_dev, tail_nonzero=tail_main,
         finite=bool(torch.isfinite(out17).all().item()), wall_s=wall17)
    check(bool(torch.isfinite(out17).all().item()), "non-finite kernel I "
          "output")
    check(tail_main == 0 and mean_dev <= 1e-5,
          f"kernel I: tail {tail_main} non-zero, channel means {mean_dev}")
    del out17, sub17, x0, y0, x5, y5
    torch.cuda.empty_cache()

    # ---- phase 18: kernel B on complex signals against its plain version - #
    nt18 = 1 << 24
    xq, yq = iq_signals(nt18, dev)
    lib = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ18 = {f"{n}_K{K}": lib.pyfft_welch_resident(n, K) / sms
             for n in (2048, 4096) for K in (1, 129)}
    emit("welch_complex_occupancy", blocks_per_sm=occ18,
         ptxas={k: v for k, v in ptxas_report("welch_kernel",
                                               named=True).items()
                if "ILi11E" in k or "ILi12E" in k})
    check(min(occ18.values()) >= 1, f"kernel B complex occupancy {occ18}")
    # (a) config 5's IQ geometry, the main path's; (b) config 0's with its
    # band-pass
    for case, nwins, taps in (("a_config5_iq", 4096, None),
                              ("b_config0_iq_taps", 2048, taps0)):
        plan = seg.plan_segments(nt18, nwins=nwins, windowoverlap=0.5)
        win = np.hanning(nwins + 1)[:-1]
        norm = 1.0 / plan.navr
        kw = dict(navr=plan.navr, nwins=nwins, hop=plan.hop, taps=taps,
                  detrend_style=1)

        def cplx_kernel(y=yq):
            return welch.welch_cuda(xq, y, win, nwins, norm, **kw)

        def cplx_plain(y=yq):
            return welch.welch_plain(xq, y, win, nwins, norm, **kw)
        got, ref = cplx_kernel(), cplx_plain()
        errs = {"Pxx": rel_err(got[0], ref[0]),
                "Pyy": rel_err(got[1], ref[1]),
                "Pxy": rel_err(torch.complex(got[2], got[3]),
                               torch.complex(ref[2], ref[3]))}
        chan = {"1_to_1": channel_errs(got, ref)}
        del got, ref
        if case.startswith("a_"):
            # every channel 10 and 1000 times quieter than the reference
            for g in (10, 1000):
                yg = yq / g
                chan[f"1_to_{g}"] = channel_errs(cplx_kernel(yg),
                                                 cplx_plain(yg))
                del yg
        runs = {"ms": time_runs(cplx_kernel, 10),
                "plain_ms": time_runs(cplx_plain, 5)}
        ms, plain_ms = (statistics.median(runs[k]) for k in ("ms", "plain_ms"))
        max_abs = max(e * sc for e, sc in errs.values())
        prof18 = trace_call(cplx_kernel, "welch_kernel")
        b18 = bound((fir_ops(nt18, len(taps), 2 * (1 + NCH)) if taps is not
                     None else 0)
                    + profiling.welch_complex_flops(plan.navr, nwins, NCH),
                    8.0 * (1 + NCH) * nt18 + 12.0 * (1 + NCH) * nwins)
        emit("welch_complex_vs_plain", case=case, nch=NCH, nt=nt18,
             nwins=nwins, navr=plan.navr,
             ntaps=0 if taps is None else len(taps),
             rel_err={k: e for k, (e, _) in errs.items()},
             channel_rel_err=chan, max_abs_err=max_abs, tol=WELCH_TOL,
             ms=ms, plain_ms=plain_ms,
             quartiles_ms={k: statistics.quantiles(v, n=4)
                           for k, v in runs.items()},
             kernel_device_ms=prof18["kernel_ms"], profile=prof18, **b18)
        for name, (e, _) in errs.items():
            check(e <= WELCH_TOL, f"kernel B complex {case} {name}: rel err "
                  f"{e} > {WELCH_TOL}")
        for ratio, per in chan.items():
            for name, e in per.items():
                check(max(e) <= WELCH_TOL, f"kernel B complex {case} {ratio} "
                      f"{name} per channel: {e} > {WELCH_TOL}")
        check(prof18["kernel_ms"] > 0, "the profiler saw no welch_kernel")
        check(prof18["h2d_pageable"] == 0,
              f"kernel B complex {case}: {prof18['h2d_pageable']} pageable "
              f"host -> device copies in a call after the first")
        if case.startswith("a_"):
            kernels["welch_complex"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                library_ms=None, kernel_device_ms=prof18["kernel_ms"], **b18)

    # ---- tenth main path: fft_pwelch on the Doppler IQ signals ----------- #
    tvec18 = np.arange(nt18) / FS
    args19 = dict(tbounds=[tvec18[1], tvec18[-2]], tper=4096.5 / FS,
                  plotit=False)
    reset_counts()
    t0 = time.perf_counter()
    f19, Pxy19, Pxx19, Pyy19, _, _, info19 = pt.fft_pwelch(
        tvec18, xq, yq, fft_backend="pallas", **args19)
    wall19 = time.perf_counter() - t0
    check(welch.COMPLEX_LAUNCHES == 1 and welch.LAUNCHES == 0
          and stft.LAUNCHES == 0,
          f"fft_pwelch on IQ launched kernel B complex "
          f"{welch.COMPLEX_LAUNCHES} times, real {welch.LAUNCHES}, kernel C "
          f"{stft.LAUNCHES}")
    launches["welch_complex"] = welch.COMPLEX_LAUNCHES
    # where a call's time goes: one more call under torch.profiler, its
    # wall split by the ranges fft_pwelch marks (host clock): the host ->
    # device step, the device core (means, kernel B, the small copies
    # back, which synchronize), and the host float64 finalization after it
    stages19 = ("fft_pwelch.h2d", "fft_pwelch.device_core")
    with tempfile.TemporaryDirectory() as logdir, \
            profiling.trace(logdir) as tr19:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.fft_pwelch(tvec18, xq, yq, fft_backend="pallas", **args19)
        torch.cuda.synchronize()
        wall19t = time.perf_counter() - t0
    host19, dev19 = {}, {}
    for e in tr19.key_averages():
        if e.key in stages19 and e.device_type != cuda_t:
            host19[e.key] = e.cpu_time_total / 1e6
        elif e.device_type == cuda_t and e.key not in stages19 \
                and not getattr(e, "is_user_annotation", False):
            dev19[e.key] = e.self_device_time_total / 1e6
    check(set(host19) == set(stages19), f"profiler ranges {host19}")
    busy19 = sum(dev19.values())
    prof19 = dict(
        wall_s=wall19t, device_busy_s=busy19,
        device_idle_share=1 - busy19 / wall19t,
        wall_s_split={
            "h2d": host19[stages19[0]], "device_core": host19[stages19[1]],
            "kernel_b_complex_device": sum(
                v for k, v in dev19.items() if "welch_kernel" in k),
            "host_finalization": wall19t - sum(host19.values())},
        top_device_ms={k[:80]: v * 1e3 for k, v in sorted(
            dev19.items(), key=lambda kv: -kv[1])[:5]})
    t0 = time.perf_counter()
    _, Pxy19x, Pxx19x, Pyy19x, _, _, _ = pt.fft_pwelch(
        tvec18, xq, yq, fft_backend="xla", **args19)
    wall19x = time.perf_counter() - t0
    df19 = FS / info19.nwins
    ipk19 = np.argmax(np.abs(Pyy19), axis=0)               # per channel
    fpk19 = f19[ipk19]
    chans = np.arange(NCH)
    coh19 = (np.abs(Pxy19[ipk19, chans]) ** 2
             / (np.abs(Pxx19[ipk19]) * np.abs(Pyy19[ipk19, chans])))
    phi19 = np.angle(Pxy19[ipk19, chans])
    dphi19 = np.abs(np.angle(np.exp(1j * (phi19 + iq_phases()))))
    errs19 = {"Pxx": rel_err(Pxx19, Pxx19x)[0],
              "Pyy": rel_err(Pyy19, Pyy19x)[0],
              "Pxy": rel_err(Pxy19, Pxy19x)[0]}
    finite19 = all(np.all(np.isfinite(a)) for a in (Pxx19, Pyy19, Pxy19))
    emit("main_doppler_iq", nt=nt18, nch=NCH, nwins=info19.nwins,
         navr=info19.Navr, two_sided=bool(f19[0] < 0), peak_hz=fpk19.tolist(),
         coh2_at_peak=coh19.tolist(), phase_at_peak=phi19.tolist(),
         phase_want=(-iq_phases()).tolist(), phase_tol=LAG_PHASE_TOL,
         rel_err_vs_xla=errs19, tol=WELCH_TOL, finite=finite19,
         wall_s_pallas=wall19, wall_s_xla=wall19x, profile=prof19)
    check(f19[0] < 0 < f19[-1], "fft_pwelch on IQ is not two-sided")
    check(finite19, "non-finite fft_pwelch IQ outputs")
    check(np.all(np.abs(fpk19 - IQ_F0) <= df19), f"IQ Pyy peaks at {fpk19}")
    check(np.all(coh19 > 0.9), f"IQ |Cxy|^2 at the peak {coh19}")
    check(np.all(dphi19 <= LAG_PHASE_TOL),
          f"IQ phase at the peak {phi19} against {-iq_phases()}")
    for k, e in errs19.items():
        check(e <= WELCH_TOL, f"IQ fft_pwelch {k}: pallas vs xla {e}")
    # ---- eleventh main path: the Doppler IQ streamed (phase 20) ---------- #
    # StreamingWelch over the span phase 19 analyses (tbounds [t1, t-2]),
    # in blocks of 2**20: kernel B on complex signals once a push
    xs20, ys20 = xq[1:nt18 - 1], yq[:, 1:nt18 - 1]
    navrs20 = stream_navrs(xs20.shape[0], 1 << 20, 4096, 2048)
    reset_counts()
    t0 = time.perf_counter()
    sw20 = pt.StreamingWelch(nwins=4096, fs=FS, nch=NCH, windowoverlap=0.5,
                             onesided=False, fft_backend="pallas",
                             device=dev)
    for s0 in range(0, xs20.shape[0], 1 << 20):
        sw20.push(xs20[s0:s0 + (1 << 20)], ys20[:, s0:s0 + (1 << 20)])
    res20 = sw20.result()
    wall20 = time.perf_counter() - t0
    pushes20 = sum(n > 0 for n in navrs20)
    check(welch.COMPLEX_LAUNCHES == pushes20 and welch.LAUNCHES == 0
          and welch_v1.LAUNCHES == 0,
          f"the IQ stream launched kernel B complex {welch.COMPLEX_LAUNCHES}"
          f" times for {pushes20} pushes, real {welch.LAUNCHES}, E "
          f"{welch_v1.LAUNCHES}")
    launches["welch_complex"] += welch.COMPLEX_LAUNCHES
    errs20 = {"Pxx": rel_err(res20.Pxx, np.real(Pxx19))[0],
              "Pyy": rel_err(res20.Pyy, np.real(Pyy19).T)[0],
              "Pxy": rel_err(res20.Pxy, Pxy19.T)[0]}
    emit("stream_doppler_iq", nt=int(xs20.shape[0]), nch=NCH, nwins=4096,
         block=1 << 20, pushes=len(navrs20), launches=welch.COMPLEX_LAUNCHES,
         navr=res20.Navr, rel_err_vs_batch=errs20, tol=WELCH_TOL,
         wall_s=wall20, samples_per_s=(1 + NCH) * xs20.shape[0] / wall20)
    check(res20.Navr == info19.Navr, f"streamed IQ navr {res20.Navr} vs "
          f"batch {info19.Navr}")
    for k, e in errs20.items():
        check(e <= WELCH_TOL, f"streamed IQ {k}: vs batch {e}")
    del xq, yq, xs20, ys20
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        stream_phases(Path(tmp), dev, launches)
    multitaper_wavelet(dev)
    mesh_phases(dev, launches)
    mesh_fft_phases(dev, smi)
    entry_phases(dev, smi, launches)
    import torch.distributed as dist
    dist.destroy_process_group()

    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    source = {"fir": ("pyfft_tpu_torch/csrc/fir.cu",
                      "pyfft_tpu/ops/pallas_fir.py:150"),
              "welch": ("pyfft_tpu_torch/csrc/welch_pair.cu",
                        "pyfft_tpu/ops/pallas_welch3.py:455"),
              "welch_v2": ("pyfft_tpu_torch/csrc/welch_pair.cu",
                           "pyfft_tpu/ops/pallas_welch.py:447"),
              "welch_packed": ("pyfft_tpu_torch/csrc/welch_pair.cu",
                               "pyfft_tpu/ops/pallas_welch3.py:455"),
              "welch_complex": ("pyfft_tpu_torch/csrc/welch.cu",
                                "pyfft_tpu/ops/pallas_welch3.py:455"),
              "fir_t": ("pyfft_tpu_torch/csrc/fir.cu",
                        "pyfft_tpu/ops/pallas_fir.py:451"),
              "stft": ("pyfft_tpu_torch/csrc/stft.cu",
                       "pyfft_tpu/ops/pallas_welch3.py:1139"),
              "hilbert": ("pyfft_tpu_torch/csrc/hilbert.cu",
                          "pyfft_tpu/hilbert.py:223"),
              "welch_dft": ("pyfft_tpu_torch/csrc/welch_dft.cu",
                            "pyfft_tpu/ops/pallas_welch.py:147"),
              "colsum": ("pyfft_tpu_torch/csrc/probe.cu",
                         "pyfft_tpu/utils/profiling.py:222"),
              "chain": ("pyfft_tpu_torch/csrc/probe.cu",
                        "pyfft_tpu/utils/profiling.py:244")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name][0],
         "replaces": source[name][1], "launches": launches[name],
         **kernels[name]} for name in source]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
