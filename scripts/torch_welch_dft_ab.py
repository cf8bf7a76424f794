"""Time kernel E (Welch cross-powers at any segment length) of one
pyfft_tpu_torch tree on a CUDA card, and fingerprint what it computes.

    python3 scripts/torch_welch_dft_ab.py TREE

TREE is a directory that holds a ``pyfft_tpu_torch`` package (``.`` for
this checkout, or an unpacked ``git archive`` of another commit).  The
script builds that tree's kernels and runs ``ops.welch_v1.welch_dft_cuda``
at chip_smoke.py's phase-11 cases a to c:

- ``a_heatpulse``: the heat-pulse reference and 32 ECE channels
  (``heatpulse.synth_heatpulse_data(nch=32, fmod=33, fs=40e3, T=10,
  seed=0, tau_damp=0.05)`` over tbounds 0.25 .. 9.75 s: 380,001 samples),
  nwins 4871, hop 2435, navr 155, global-mean detrend;
- ``b_linear_detrend_radix2``: ``chip_smoke.signals(2**22)`` (a 97 kHz
  sine in noise and 8 noisy copies), nwins 4096, hop 2048, linear
  detrend;
- ``c_preframed_odd``: 4096 seeded frames of 2047 samples of x and of 4
  channels, hop = nwins, no detrend (``welch_power_pallas``'s geometry).

It prints one JSON line with, per case: the median and quartiles of the
call (``ms``, ``q``; 25 calls at case a, 10 otherwise, by CUDA events
after a warm-up), the plain version's median of 5 (``plain_ms``), the
device time a call of the kernels whose names hold ``dft_`` or
``sum_partials`` from one ``torch.profiler`` trace of five calls
(``device_ms``), max |kernel - plain| / max |plain| over Pxx, Pyy and
the complex Pxy (``rel_err``), the FFT size the tree runs (``fft_points``) and a
fingerprint of the output bytes (``sha256``); then ptxas' report of the
tree's ``dft_`` kernels and the card's ``nvidia-smi`` name and power
limit.

To compare two commits, run both trees in one call on one card, in turns:
parent, change, change, parent.
"""
import hashlib
import importlib.util
import inspect
import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np
import torch


def main():
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    # chip_smoke.py's helpers, from this checkout whatever TREE is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import heatpulse as php
    from pyfft_tpu_torch.ops import _build
    from pyfft_tpu_torch.ops import welch_v1 as pv
    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"pyfft_tpu_torch imported from {pt.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    _build.library()
    dev = torch.device("cuda")
    fs = 40e3
    hp = php.synth_heatpulse_data(nch=32, fmod=33.0, fs=fs, T=10.0, seed=0,
                                  tau_damp=smoke.TAU_DAMP)
    span = slice(int(0.25 * fs), int(9.75 * fs) + 1)
    x_hp = torch.as_tensor(hp["refsig"][span], dtype=torch.float32,
                           device=dev)
    y_hp = torch.as_tensor(np.ascontiguousarray(hp["sig"][span].T),
                           dtype=torch.float32, device=dev)
    x0, y0 = smoke.signals(1 << 22, dev)
    rng = np.random.default_rng(smoke.SEED + 5)
    nfr, n11 = 4096, 2047
    xfr = torch.as_tensor(rng.standard_normal((nfr, n11)),
                          dtype=torch.float32, device=dev)
    yfr = torch.as_tensor(rng.standard_normal((4, nfr, n11)),
                          dtype=torch.float32, device=dev)
    cases = (("a_heatpulse", x_hp, y_hp, 4871, 2435, 155, 1),
             ("b_linear_detrend_radix2", x0, y0, 4096, 2048,
              ((1 << 22) - 4096) // 2048 + 1, -1),
             ("c_preframed_odd", xfr.reshape(-1), yfr.reshape(4, -1), n11,
              n11, nfr, 0))
    reduced = "nfreq" in inspect.signature(pv.bluestein_size).parameters

    def fingerprint(out):
        h = hashlib.sha256()
        for t in out:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    res = {"tree": sys.argv[1],
           "nvidia_smi": smoke.smi_query("name,power.limit")}
    for name, x, y, nwins, hop, navr, det in cases:
        win = np.hanning(nwins + 1)[:-1]
        nf = (nwins + 1) // 2 if nwins % 2 else nwins // 2
        norm = 1.0 / navr
        kw = dict(navr=navr, nwins=nwins, hop=hop, detrend_style=det)

        def call():
            return pv.welch_dft_cuda(x, y, win, nf, norm, **kw)
        got = call()
        ref = pv.welch_dft_plain(x, y, win, nf, norm, **kw)
        err = max(smoke.rel_err(g, r)[0] for g, r in (
            (got[0], ref[0]), (got[1], ref[1]),
            (torch.complex(got[2], got[3]), torch.complex(ref[2], ref[3]))))
        runs = smoke.time_runs(call, 25 if name.startswith("a_") else 10)
        dev_ms = sum(smoke.trace_launches(call, k)[1]["kernel_ms"] / 5
                     for k in ("dft_", "sum_partials"))
        res[name] = dict(
            ms=statistics.median(runs), q=statistics.quantiles(runs, n=4),
            plain_ms=smoke.time_ms(lambda: pv.welch_dft_plain(
                x, y, win, nf, norm, **kw)),
            device_ms=dev_ms, rel_err=err,
            fft_points=(pv.bluestein_size(nwins, nf) if reduced
                        else pv.bluestein_size(nwins)),
            sha256=fingerprint(got))
        del got, ref
    res["ptxas"] = smoke.ptxas_report("dft_", named=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
