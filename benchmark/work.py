"""The yardstick of the roofline shares: the operations and bytes that a
configuration's work needs, counted from its shapes, and the published
peaks of the card.

The counts are frozen copies of the port's FLOP models (``fft_flops``,
``welch_flops`` and ``fir_flops`` of ``pyfft_tpu_torch.utils.profiling``),
so a later change to the program cannot move the yardstick.  A share reads
the same work whatever implements it: splitting, merging or replacing a
kernel changes the time it is divided by, not the least time.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def fft_flops(n, batch=1, real=False):
    """Operations of ``batch`` length-``n`` FFTs (5 n log2 n, halved for a
    real transform)."""
    f = 5.0 * n * math.log2(max(n, 2))
    return batch * (f / 2.0 if real else f)


def welch_flops(navr, nwins, nch=1):
    """Welch: window product, real FFT, powers and cross-powers of each
    segment, for the reference signal and ``nch`` channels."""
    per_seg = nwins + fft_flops(nwins, real=True) + 4 * (nwins // 2 + 1)
    return navr * per_seg * (1 + nch)


def fir_flops(nt, ntaps, nch=1, method="overlap-save"):
    """A causal FIR over ``nch`` signals of ``nt`` samples: the direct form
    (2 nt ntaps a signal) or overlap-save (two FFTs a block)."""
    if method == "direct":
        return 2.0 * nt * ntaps * nch
    nfft = 2 ** int(math.ceil(math.log2(4 * ntaps)))
    hop = nfft - ntaps + 1
    nblocks = int(math.ceil(nt / hop))
    return nblocks * (2 * fft_flops(nfft) + 6 * nfft) * nch


def fir_least_flops(nt, ntaps, nch=1):
    """The fewer of the direct form's and overlap-save's operations."""
    return min(fir_flops(nt, ntaps, nch, "direct"),
               fir_flops(nt, ntaps, nch, "overlap-save"))


def peaks(kind):
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name``): a dict with ``fp32_tflops``,
    ``hbm_gbps`` and the ``power_w`` they assume.  Raises for a card the
    table does not hold: no share is reported against a guess."""
    table = json.loads(PEAKS_FILE.read_text())
    name = str(kind).lower()
    for key, entry in table["cards"].items():
        if key in name:
            return entry
    raise ValueError(f"no published peaks for the card {kind!r}")


def least_ms(flops, nbytes, kind):
    """``(ms, bound)``: the least time the card could take for ``flops``
    float32 operations and ``nbytes`` of device memory traffic, the larger
    of the two times, and which of the two it is."""
    p = peaks(kind)
    t_ops = flops / (p["fp32_tflops"] * 1e12) * 1e3
    t_bytes = nbytes / (p["hbm_gbps"] * 1e9) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
