"""Time kernel B and kernel H of one pyfft_tpu_torch tree on a CUDA card,
and fingerprint what they compute.

    python3 scripts/torch_welch_ab.py TREE [--split] [--complex]

TREE is a directory that holds a ``pyfft_tpu_torch`` package (``.`` for
this checkout, or an unpacked ``git archive`` of another commit).  The
script builds that tree's kernels and times ``ops.welch.welch_cuda``.

Without ``--complex``, on real signals at bench configs 0 (8 × 2^25,
nwins 2048, hop 1024, 129 taps), 5 (8 × 2^24, nwins 4096, no taps), 1 (one
2^24 signal, nwins 4096, ``packed=True``) and the v2 geometry (8 × 2^22,
nwins 2048 every 128, 129 taps): per case the median of 10 calls by CUDA
events after a warm-up, in ms, and ``<case>_sha256``, a fingerprint of
the output bytes; at config 0 also ``config0_device``, from one
``torch.profiler`` trace of 5 calls: the device ms a call of
``welch_pair_kernel`` (kernel B) and ``fir_kernel`` (kernel A, which
filters x ahead where the tree does), of all device operations, and the
device operations a call.  With ``--split`` it also times the means prologue
(``welch._means``) by CUDA events and the host's enqueue time of the call
and of the prologue (host clock from a synchronized card to the return,
median of 10).

With ``--complex``, on chip_smoke.py's Doppler IQ signals (a complex
reference and 8 complex channels of 2^24 samples, ``iq_signals``) at
phase 18's shapes: ``a_config5_iq`` (nwins 4096, hop 2048, no taps) and
``b_config0_iq_taps`` (nwins 2048, hop 1024, the 129-tap band-pass), and
``c_config0_iq`` (b without taps).  Per
case: the median and quartiles of 10 calls (``ms``, ``q``), the median
of 5 of the means prologue (``means_ms``) and of the plain version
(``plain_ms``), the device time a launch of the
kernels whose names hold ``welch_kernel`` from one ``torch.profiler``
trace of five calls (``device_ms``), max |kernel - plain| / max |plain|
over the outputs (``rel_err``) and the fingerprint (``sha256``); then the
tree's blocks an SM at nwins 2048 and 4096 where the tree reports them,
and ptxas' report of its ``welch_kernel`` instantiations.

It prints one JSON line, with the card's ``nvidia-smi`` name and power
limit.  To compare two commits, run both trees in one call on one card,
in turns: parent, change, change, parent.
"""
import hashlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch


def fingerprint(outputs):
    """First 16 hex digits of the sha256 of the outputs' bytes."""
    h = hashlib.sha256()
    for o in outputs:
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_split(fn, calls=5):
    """Device ms a call of kernels B and A, of every device operation, and
    the device operations a call, over ``calls`` calls of ``fn`` traced
    under ``torch.profiler`` after a warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict(welch_pair_kernel=0.0, fir_kernel=0.0, all=0.0, ops=0)
    cuda_t = torch.autograd.DeviceType.CUDA
    for e in prof.key_averages():
        if e.device_type != cuda_t or getattr(e, "is_user_annotation", False):
            continue
        ms = e.self_device_time_total / 1e3 / calls
        out["all"] += ms
        out["ops"] += e.count / calls
        for k in ("welch_pair_kernel", "fir_kernel"):
            if k in e.key:
                out[k] += ms
    return out


def real_cases(res, pt, welch, split):
    dev = torch.device("cuda")
    nt = 1 << 25
    rng = np.random.default_rng(0)
    t = (np.arange(nt) / 1e6).astype(np.float32)
    x = torch.from_numpy((np.sin(2 * np.pi * 97e3 * t)
                          + 0.3 * rng.standard_normal(nt))
                         .astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    y = x[None].repeat(8, 1) + 0.1 * torch.randn(8, nt, device=dev,
                                                 generator=gen)
    taps = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)

    def events_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def enqueue_ms(fn, reps=10):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(out)

    for name, n, nch, nwins, hop, tp, packed in (
            ("config0", nt, 8, 2048, 1024, taps, False),
            ("v2", 1 << 22, 8, 2048, 128, taps, False),
            ("config5", 1 << 24, 8, 4096, 2048, None, False),
            ("config1", 1 << 24, 0, 4096, 2048, None, True)):
        xs, ys = x[:n], y[:nch, :n]
        navr = (n - nwins) // hop + 1
        win = np.hanning(nwins + 1)[:-1]
        kw = dict(navr=navr, nwins=nwins, hop=hop, taps=tp, detrend_style=1,
                  packed=packed)

        def call():
            return welch.welch_cuda(xs, ys, win, nwins // 2 + 1, 1.0 / navr,
                                    **kw)
        res[name] = events_ms(call)
        res[name + "_sha256"] = fingerprint(call())
        if name == "config0":
            res["config0_device"] = device_split(call)
        if split:
            taps64 = np.ones(1) if tp is None else np.asarray(tp, np.float64)

            def means():
                return welch._means(xs, ys, taps64, 1, False)
            res[name + "_means"] = events_ms(means)
            res[name + "_enqueue"] = enqueue_ms(call)
            res[name + "_means_enqueue"] = enqueue_ms(means)


def complex_cases(res, pt, welch, _build, smoke):
    dev = torch.device("cuda")
    nt = 1 << 24
    x, y = smoke.iq_signals(nt, dev)
    taps = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    for name, nwins, tp in (("a_config5_iq", 4096, None),
                            ("b_config0_iq_taps", 2048, taps),
                            ("c_config0_iq", 2048, None)):
        hop = nwins // 2
        navr = (nt - nwins) // hop + 1
        win = np.hanning(nwins + 1)[:-1]
        kw = dict(navr=navr, nwins=nwins, hop=hop, taps=tp, detrend_style=1)

        def call():
            return welch.welch_cuda(x, y, win, nwins, 1.0 / navr, **kw)

        def plain():
            return welch.welch_plain(x, y, win, nwins, 1.0 / navr, **kw)
        got, ref = call(), plain()
        err = max(smoke.rel_err(torch.complex(got[2], got[3]),
                                torch.complex(ref[2], ref[3]))[0],
                  *(smoke.rel_err(g, r)[0] for g, r in zip(got[:2], ref[:2])))
        del ref
        runs = smoke.time_runs(call, 10)
        taps64 = np.ones(1) if tp is None else np.asarray(tp, np.float64)
        res[name] = dict(
            navr=navr, ms=statistics.median(runs),
            q=statistics.quantiles(runs, n=4),
            means_ms=smoke.time_ms(lambda: welch._means(x, y, taps64, 1,
                                                        True)),
            plain_ms=smoke.time_ms(plain),
            device_ms=smoke.trace_launches(call, "welch_kernel")[0],
            rel_err=err, sha256=fingerprint(got))
        del got
        torch.cuda.empty_cache()
    lib = _build.library()
    resident = getattr(lib, "pyfft_welch_resident", None)
    if resident is not None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        res["blocks_per_sm"] = {n: resident(n, 1) / sms for n in (2048, 4096)}
    res["ptxas"] = smoke.ptxas_report("welch_kernel", named=True)


def main():
    tree = os.path.abspath(sys.argv[1])
    flags = sys.argv[2:]
    sys.path.insert(0, tree)
    # chip_smoke.py's helpers, from this checkout whatever TREE is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch.ops import _build, welch
    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"pyfft_tpu_torch imported from {pt.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    _build.library()
    res = {"tree": sys.argv[1], "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smoke.smi_query("name,power.limit")}
    if "--complex" in flags:
        complex_cases(res, pt, welch, _build, smoke)
    else:
        real_cases(res, pt, welch, "--split" in flags)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
