"""Time kernel D (the rows' section of the factored analytic signal) of one
pyfft_tpu_torch tree on a CUDA card, and fingerprint what it computes.

    python3 scripts/torch_hilbert_ab.py TREE

TREE is a directory that holds a ``pyfft_tpu_torch`` package (``.`` for
this checkout, or an unpacked ``git archive`` of another commit).  The
script builds that tree's kernels and runs ``ops.hilbert.hilbert_cuda`` on
the outer spectrum's rows at chip_smoke.py's phase-9 cases:

- ``a_config4``: bench config 4's AM signal (``chip_smoke.am_signal(2**24)``),
  rows of 8192 (n1 = 2048);
- ``b_odd_n1``: 2047 * 8192 seeded normal samples (n1 = 2047);
- ``c_9x2^20``: 9 * 2**20 seeded normal samples (n1 = 1152);
- ``d_small``: 4096 samples, one row;
- ``e_config4_rows_16384``: case a's signal in rows of 16384 (n1 = 1024).

It prints one JSON line with, per case: the median and quartiles of the
kernel's call (``ms``, ``q``; 25 calls at case a, 10 otherwise, by CUDA
events after a warm-up), the plain version's median of 5 (``plain_ms``),
the device time a launch of the kernels whose names hold
``hilbert_kernel`` from one ``torch.profiler`` trace of five calls
(``device_ms``), the chain's median of 5 (outer DFT, kernel D, inverse
outer DFT: ``chain_ms``), max |kernel - plain| / max |plain| on the rows
(``rel_err``) and a fingerprint of the output bytes (``sha256``); then the
tree's occupancy for every row length (``blocks_per_sm``), ptxas' report
of its ``hilbert`` kernels and the card's ``nvidia-smi`` name and power
limit.

To compare two commits, run both trees in one call on one card, in turns:
parent, change, change, parent.
"""
import hashlib
import importlib.util
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
    from pyfft_tpu_torch.hilbert import _analytic_factored
    from pyfft_tpu_torch.ops import _build
    from pyfft_tpu_torch.ops import hilbert as hk
    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"pyfft_tpu_torch imported from {pt.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    _build.library()
    dev = torch.device("cuda")
    am4, _, _ = smoke.am_signal(1 << 24)
    rng = np.random.default_rng(smoke.SEED + 3)
    cases = (("a_config4", am4, None),
             ("b_odd_n1", rng.standard_normal(2047 << 13), None),
             ("c_9x2^20", rng.standard_normal(9 << 20), None),
             ("d_small", rng.standard_normal(1 << 12), None),
             ("e_config4_rows_16384", am4, hk.ROW_MAX))

    res = {"tree": sys.argv[1],
           "nvidia_smi": smoke.smi_query("name,power.limit")}
    for name, sig, max_row in cases:
        x = torch.as_tensor(np.asarray(sig, dtype=np.float32), device=dev)
        split = hk.row_split(x.shape[0], max_row or hk.ROW_DEFAULT)
        A = torch.fft.fft(x.reshape(split), dim=0).contiguous()

        def call():
            return hk.hilbert_cuda(A)
        got = call()
        err = smoke.rel_err(got, hk.hilbert_plain(A))[0]
        runs = smoke.time_runs(call, 25 if name.startswith("a_") else 10)
        res[name] = dict(
            n1=split[0], M=split[1],
            ms=statistics.median(runs), q=statistics.quantiles(runs, n=4),
            plain_ms=smoke.time_ms(lambda: hk.hilbert_plain(A)),
            device_ms=smoke.trace_launches(call, "hilbert_kernel")[0],
            chain_ms=smoke.time_ms(lambda: _analytic_factored(x, split)),
            rel_err=err,
            sha256=hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest()[:16])
        del got, A, x
        torch.cuda.empty_cache()
    res["blocks_per_sm"] = {1 << e: hk.blocks_per_sm(1 << e)
                            for e in range(4, 15)}
    res["ptxas"] = smoke.ptxas_report("hilbert", named=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
