"""Time kernel B and kernel H of one pyfft_tpu_torch tree on a CUDA card.

    python3 scripts/torch_welch_ab.py TREE [--split]

TREE is a directory that holds a ``pyfft_tpu_torch`` package (``.`` for
this checkout, or an unpacked ``git archive`` of another commit).  The
script builds that tree's kernels and times ``ops.welch.welch_cuda`` at
bench configs 0 (8 × 2^25, nwins 2048, hop 1024, 129 taps), 5 (8 × 2^24,
nwins 4096, no taps), 1 (one 2^24 signal, nwins 4096, ``packed=True``) and
the v2 geometry (8 × 2^22, nwins 2048 every 128, 129 taps): the median of
10 calls by CUDA events after a warm-up, in ms.  With ``--split`` it also
times the means prologue (``welch._means``) by CUDA events and the host's
enqueue time of the call and of the prologue (host clock from a
synchronized card to the return, median of 10).  It prints one JSON line.

To compare two commits, run both trees in one call on one card, in turns:
parent, change, change, parent.
"""
import json
import os
import statistics
import sys
import time

import numpy as np
import torch


def main():
    tree = os.path.abspath(sys.argv[1])
    split = "--split" in sys.argv[2:]
    sys.path.insert(0, tree)
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch.ops import _build, welch
    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"pyfft_tpu_torch imported from {pt.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    _build.library()
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

    res = {"tree": sys.argv[1], "device": torch.cuda.get_device_name(0)}
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
        if split:
            taps64 = np.ones(1) if tp is None else np.asarray(tp, np.float64)

            def means():
                return welch._means(xs, ys, taps64, 1, False)
            res[name + "_means"] = events_ms(means)
            res[name + "_enqueue"] = enqueue_ms(call)
            res[name + "_means_enqueue"] = enqueue_ms(means)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
