"""Tracing, FLOP/byte accounting and rooflines on PyTorch.

Counterpart of :mod:`pyfft_tpu.utils.profiling`:

- :class:`stage`: a ``torch.profiler.record_function`` range while a
  profiler runs (and nothing otherwise), so pipeline stages show up named
  in profiler traces;
- :func:`trace`: a ``torch.profiler`` capture of a block (CPU, and CUDA
  where a card is present), written as a Chrome trace;
- FLOP models of the hot chains (:func:`fft_flops`, :func:`welch_flops`,
  :func:`fir_flops`, copies of the JAX package's), of the packed Welch
  (:func:`welch_packed_flops`), of the two-sided Welch of complex signals
  (:func:`welch_complex_flops`) and of the four-step analytic-signal chain
  (:func:`analytic_flops_bytes`);
- :func:`device_peaks` (book peaks of the card, keyed on its name as
  ``nvidia-smi`` or ``torch.cuda.get_device_name`` gives it, with the
  power limit checked against the rating the book peaks assume),
  :func:`bound_ms` (the least time the card could take for some bytes and
  operations) and :func:`roofline` (the achieved share of a peak);
- :func:`interconnect_peaks`: book link rates (NVLink a GPU, network a
  host) for the mesh tier's scaling projections;
- :func:`measure`: the wall time of a callable, synchronizing the CUDA
  stream after each call;
- :func:`measure_pipeline_overlap`: the memory, compute and streamed-
  compute probes, kernels F and G (:mod:`pyfft_tpu_torch.ops.probe`).

A number from a CPU run is never a device number: :func:`device_peaks`
raises for a card it has no book values for, and on the CPU it gives the
JAX package's nominal ``'cpu'`` entry.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

__all__ = ["stage", "trace", "fft_flops", "welch_flops",
           "welch_complex_flops", "welch_packed_flops", "fir_flops", "analytic_flops_bytes",
           "device_peaks", "peak_tflops", "bound_ms", "roofline", "measure", "report",
           "interconnect_peaks",
           "measure_pipeline_overlap"]


class stage:
    """Named pipeline stage, ``with stage(name): ...``: a
    ``record_function`` range (a ``user_annotation`` in a
    ``torch.profiler`` trace) while a profiler runs, and nothing (no range,
    no clock read) while none does.  A range that launches work ends when
    the launches are queued, not when the card finishes them.

    The range is entered as ``torch.profiler.record_function`` enters it,
    but without the two dispatched operators that class calls on entry and
    exit, which cost as much again and leave a gap of host time at each
    edge of a nested range that no range names."""

    __slots__ = ("name", "_handle")

    def __init__(self, name):
        self.name = name
        self._handle = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._handle = torch.autograd._record_function_with_args_enter(
                self.name)
        return self

    def __exit__(self, *exc):
        if self._handle is not None:
            torch.autograd._record_function_with_args_exit(self._handle)
            self._handle = None


@contextlib.contextmanager
def trace(logdir):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU
    activity, and CUDA activity where a card is present); yields the
    profiler (``key_averages()`` gives the sums by name) and writes
    ``<logdir>/trace.json`` (Chrome trace format) when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


# --------------------------------------------------------------------------- #
# FLOP models (complex FFT: 5 N log2 N, the standard radix-2 count)
# --------------------------------------------------------------------------- #

def fft_flops(n, batch=1, real=False):
    """FLOPs of one (batched) length-``n`` FFT; real transforms halve."""
    f = 5.0 * n * np.log2(max(n, 2))
    return batch * (f / 2.0 if real else f)


def welch_flops(navr, nwins, nch=1):
    """Welch chain: window multiply + rFFT + power + accumulate per segment
    for the reference channel and ``nch`` signal channels."""
    per_seg = (nwins                      # window multiply
               + fft_flops(nwins, real=True)
               + 4 * (nwins // 2 + 1))    # |X|^2 + cross-power terms
    return navr * per_seg * (1 + nch)


def welch_complex_flops(navr, nwins, nch=1):
    """Two-sided Welch of complex signals: window multiply of both parts +
    complex FFT + power + accumulate over all ``nwins`` bins per segment,
    for the reference and ``nch`` channels."""
    per_seg = 2 * nwins + fft_flops(nwins) + 4 * nwins
    return navr * per_seg * (1 + nch)


def welch_packed_flops(navr, nwins, pair=False):
    """Kernel H (``ops.welch_packed``): two real sequences per complex FFT,
    so ``ceil(navr/2)`` transforms of one signal's segments (auto) or
    ``navr`` of (x, y) pairs (pair), half the transforms of kernel B on the
    same signals; plus the window on every real segment and, per
    transform, the split and the sums of the ``nwins/2 + 1`` bins kept."""
    nfft = navr if pair else -(-navr // 2)
    nseq = 2 * navr if pair else navr
    per_bin = 16 if pair else 6
    return (nseq * nwins + fft_flops(nwins, batch=nfft)
            + nfft * (nwins // 2 + 1) * per_bin)


def fir_flops(nt, ntaps, nch=1, method="overlap-save"):
    """FIR filtering cost: direct is 2*nt*ntaps; overlap-save is the
    two-FFT-per-block form."""
    if method == "direct":
        return 2.0 * nt * ntaps * nch
    nfft = 2 ** int(np.ceil(np.log2(4 * ntaps)))
    hop = nfft - ntaps + 1
    nblocks = int(np.ceil(nt / hop))
    per_block = 2 * fft_flops(nfft) + 6 * nfft
    return nblocks * per_block * nch


def analytic_flops_bytes(nfft, split=None):
    """(FLOPs, device bytes) of ``hilbert.envelope_phase``'s four-step
    chain for a real signal of ``nfft`` samples split as ``(n1, M)``
    (default :func:`pyfft_tpu_torch.ops.hilbert.row_split`).

    FLOPs: the outer ``n1``-point DFT over the ``M`` columns and its inverse
    (``5 nfft log2 n1`` each); kernel D's two ``M``-point FFTs per row
    (``10 nfft log2 M``), its two twiddle products and the mask (``14
    nfft``); the envelope and phase (``4 nfft``).  Bytes: one float32 read
    of the signal, the complex64 write and read of each of the three
    stages, and the epilogue's two float32 outputs: ``60 nfft``.  Returns
    ``(None, None)`` for a length without a split.  (The JAX function counts
    the TPU's matmul DFT passes instead.)
    """
    if split is None:
        from ..ops.hilbert import row_split
        split = row_split(nfft)
    if split is None:
        return None, None
    n1, M = split
    nfft = n1 * M
    flops = (2 * fft_flops(n1, batch=M) + 2 * fft_flops(M, batch=n1)
             + 18.0 * nfft)
    return flops, 60.0 * nfft


# --------------------------------------------------------------------------- #
# Book peaks
# --------------------------------------------------------------------------- #

# (bf16 tensor-core TFLOP/s, float32 CUDA-core TFLOP/s, HBM GB/s, TF32
# tensor-core TFLOP/s, the power limit in W the rates assume), dense, from
# NVIDIA's data sheets; keys match the device name in lower case.  The
# 'cpu' entry is the JAX package's nominal one (no rating).
_PEAKS = {
    "h100 80gb hbm3": (989.0, 67.0, 3350.0, 495.0, 700.0),   # H100 SXM
    "cpu": (0.2, 0.1, 50.0, 0.2, None),
}

_UNITS = {"matmul": 0, "bf16": 0, "vector": 1, "fp32": 1, "tf32": 3}


def _entry(kind):
    """The ``_PEAKS`` entry of ``kind``: a device name, or an ``nvidia-smi
    --query-gpu=name,power.limit`` line; None means the current device
    (the first card, else the CPU)."""
    if kind is None:
        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
    name, _, limit = str(kind).partition(",")
    name = name.strip().lower()
    for key, entry in _PEAKS.items():
        if key in name:
            break
    else:
        raise ValueError(f"no book peaks for the device {kind!r}")
    watts = limit.strip().split(" ")[0]
    if watts and entry[4] is not None and float(watts) > entry[4]:
        raise ValueError(f"{kind!r}: a power limit above the {entry[4]} W "
                         f"that the book peaks assume")
    return entry


def device_peaks(kind=None):
    """(matmul TFLOP/s, vector TFLOP/s, HBM GB/s) of ``kind`` (see
    :func:`_entry`), the JAX function's triple: bf16 tensor-core and float32
    CUDA-core rates on a card.  A card set below its rated power runs
    slower under load than these; state its limit beside any share."""
    return _entry(kind)[:3]


# Link book values: (NVLink one-way GB/s a GPU, network GB/s a host).  The
# H100 SXM: NVLink 900 GB/s both ways a GPU (NVIDIA H100 Tensor Core GPU
# data sheet), and a DGX H100 host's eight ConnectX-7 ports at 400 Gb/s
# each, 3200 Gb/s (NVIDIA DGX H100 user guide).  The 'cpu' entry is the JAX
# package's nominal one.
_LINK_PEAKS = {
    "h100 80gb hbm3": (450.0, 400.0),
    "cpu": (10.0, 10.0),
}


def link_kind(kind=None):
    """``kind``, or where it is None the device a projection models: the
    first card's name, and on a world without a card the H100 (the mesh
    tier's target, as the JAX package's CPU meshes project a v5e)."""
    if kind is not None:
        return kind
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "NVIDIA H100 80GB HBM3"


def interconnect_peaks(kind=None):
    """(NVLink one-way GB/s a GPU, network GB/s a host) of ``kind`` (a
    device name or an ``nvidia-smi --query-gpu=name,power.limit`` line;
    None: :func:`link_kind`; ``'cpu'``: the nominal host entry).  Raises
    for a device without book figures."""
    kind = link_kind(kind)
    name = str(kind).partition(",")[0].strip().lower()
    for key, entry in _LINK_PEAKS.items():
        if key in name:
            return entry
    raise ValueError(f"no link figures for the device {kind!r}")


def peak_tflops(unit="fp32", kind=None):
    """The book rate of ``unit`` ('bf16'/'matmul', 'fp32'/'vector',
    'tf32') in TFLOP/s."""
    return _entry(kind)[_UNITS[unit]]


def bound_ms(flops, nbytes, unit="fp32", kind=None):
    """``(ms, 'bytes' | 'operations')``: the least time the card could
    take for ``nbytes`` of device memory traffic and ``flops`` operations
    of type ``unit``, the larger of the two times, and which it is."""
    bw = _entry(kind)[2]
    t_bytes = nbytes / (bw * 1e9) * 1e3
    t_ops = flops / (peak_tflops(unit, kind) * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline(flops, bytes_moved, wall_s, kind=None, unit="matmul"):
    """Achieved fraction of the device's compute/memory roofline.

    Returns a dict with achieved TFLOP/s, GB/s, the bound ('compute' or
    'memory') and ``fraction`` of the relevant peak.
    """
    bw = _entry(kind)[2]
    peak = peak_tflops(unit, kind)
    tflops = flops / wall_s / 1e12
    gbs = bytes_moved / wall_s / 1e9
    ai = flops / max(bytes_moved, 1)
    knee = peak * 1e12 / (bw * 1e9)
    bound = "compute" if ai >= knee else "memory"
    frac = (tflops / peak) if bound == "compute" else (gbs / bw)
    return {"achieved_tflops": tflops, "achieved_gbs": gbs,
            "bound": bound, "fraction": frac,
            "peak_tflops": peak, "peak_gbs": bw}


# --------------------------------------------------------------------------- #
# Timing
# --------------------------------------------------------------------------- #

def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, *args, iters=10, warmup=2):
    """Mean wall seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls, the CUDA stream synchronized before the clock starts
    and after each call."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        _sync()
    return (time.perf_counter() - t0) / iters


def measure_pipeline_overlap(nrows=65536, N=1152, rows_blk=512, passes=12,
                             iters=8, device=None):
    """Measure how far streaming a block from device memory overlaps
    computing on it (the JAX function's probe of the Pallas grid pipeline,
    SURVEY §2.3), over an ``(nrows, N)`` float32 array in row blocks of
    ``rows_blk``:

    - ``mem``   — kernel F streams every block and sums its columns (the
      achieved read bandwidth);
    - ``mxu``   — kernel G runs ``passes`` chained bf16 ``(128, 128)``
      products per 128-row group over row block 0 at every step (compute
      only; the name is the JAX function's);
    - ``fused`` — kernel G over the streamed blocks.

    ``device`` resolves as the entry points' does
    (:func:`pyfft_tpu_torch.config.resolve_device`: the card unless the CPU
    is asked for); on the CPU the plain versions run (for tests, at small
    sizes).  Returns the JAX
    function's fields: the three times, ``read_gbs``, ``mxu_tflops``,
    ``fused_vs_serial`` and ``overlap_fraction = (t_mem + t_mxu -
    t_fused) / min(t_mem, t_mxu)`` clipped to [0, 1].
    """
    from ..config import resolve_device
    from ..ops import probe
    if nrows % rows_blk or rows_blk % probe.GROUP:
        raise ValueError(f"nrows {nrows} must split into blocks of "
                         f"rows_blk {rows_blk}, a multiple of {probe.GROUP}")
    dev = resolve_device(device)
    nb = nrows // rows_blk
    groups = rows_blk // probe.GROUP
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((nrows, N)),
                        dtype=torch.float32, device=dev)
    T = torch.as_tensor(
        np.random.default_rng(1).standard_normal((probe.GROUP, probe.GROUP))
        / 16.0, device=dev).to(torch.bfloat16)
    t_mem = measure(probe.colsum, x, rows_blk, iters=iters)
    t_mxu = measure(probe.chain, x, T, rows_blk, passes, True, iters=iters)
    t_fused = measure(probe.chain, x, T, rows_blk, passes, False, iters=iters)
    bytes_read = 4 * nrows * N
    flops = 2.0 * nb * groups * passes * probe.GROUP * probe.GROUP * N
    overlap = (t_mem + t_mxu - t_fused) / max(min(t_mem, t_mxu), 1e-12)
    return {
        "t_mem_s": t_mem, "t_mxu_s": t_mxu, "t_fused_s": t_fused,
        "read_gbs": bytes_read / t_mem / 1e9,
        "mxu_tflops": flops / t_mxu / 1e12,
        "fused_vs_serial": t_fused / (t_mem + t_mxu),
        "overlap_fraction": float(np.clip(overlap, 0.0, 1.0)),
    }


def report(entries, path=None):
    """Write one-JSON-line perf records (samples/s, roofline fractions)."""
    lines = [json.dumps(e) for e in entries]
    if path is not None:
        with open(path, "a") as f:
            f.write("\n".join(lines) + "\n")
    return lines
