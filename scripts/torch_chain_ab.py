"""Time kernel G (the chained bf16 matmul probe) of one pyfft_tpu_torch
tree on a CUDA card.

    python3 scripts/torch_chain_ab.py TREE

TREE is a directory that holds a ``pyfft_tpu_torch`` package (``.`` for
this checkout, or an unpacked ``git archive`` of another commit).  The
script builds that tree's kernels and, at the probe's default size (x
65536 x 1152 float32 in row blocks of 512, 12 passes, T from
``measure_pipeline_overlap``'s seeds), prints one JSON line with:

- ``ms`` and ``resident_ms``: ``ops.probe.chain_cuda`` streamed and
  resident, the median of 25 calls by CUDA events after a warm-up;
- ``kernel_device_ms``: ``chain_kernel``'s device time a launch, from one
  ``torch.profiler`` trace of 10 calls (``traced_launches`` it recorded);
- ``cublas_chain_ms``: the same chain as 12 bf16 ``torch.matmul`` calls
  (cuBLAS, float32 accumulation, no reduced-precision reduction), the cast
  and the column sums, timed as ``ms``; ``plain_ms``: ``chain_plain``;
- ``rel_err``: against ``chain_plain`` on the dense T, and on
  ``probe.two_tap_T`` where no order of sums can move the chain;
- ``overlap``: ``utils.profiling.measure_pipeline_overlap()``'s fields;
- ``ptxas``: ptxas' report of ``chain_kernel`` from the build's log;
- ``nvidia_smi``: the card's name and power limit.

To compare two commits, run both trees in one call on one card, in turns:
parent, change, change, parent.
"""
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np
import torch


def events_ms(fn, reps=25):
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


def main():
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    # chip_smoke.py's helpers, from this checkout whatever TREE is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch.ops import _build, probe
    from pyfft_tpu_torch.utils import profiling
    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"pyfft_tpu_torch imported from {pt.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.library()
    dev = torch.device("cuda")
    nrows, N, rows_blk, passes = 65536, 1152, 512, 12
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((nrows, N)),
                        dtype=torch.float32, device=dev)
    T = torch.as_tensor(np.random.default_rng(1).standard_normal((128, 128))
                        / 16.0, device=dev).to(torch.bfloat16)

    def err(got, ref):
        return ((got - ref).abs().max() / ref.abs().max()).item()

    res = {"tree": sys.argv[1],
           "nvidia_smi": smoke.smi_query("name,power.limit")}
    res["ms"] = events_ms(lambda: probe.chain_cuda(x, T, rows_blk, passes))
    res["resident_ms"] = events_ms(
        lambda: probe.chain_cuda(x, T, rows_blk, passes, True))
    res["cublas_chain_ms"] = events_ms(
        lambda: smoke.cublas_chain(x, T, passes))
    res["plain_ms"] = events_ms(
        lambda: probe.chain_plain(x, T, rows_blk, passes), 5)
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.zeros(1, device=dev).add_(1.0)
        for _ in range(10):
            probe.chain_cuda(x, T, rows_blk, passes).sum()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "chain_kernel" in e.key]
    # per recorded launch: the profiler may miss the first of its window
    res["kernel_device_ms"] = (sum(e.self_device_time_total for e in ev)
                               / 1e3 / max(sum(e.count for e in ev), 1))
    res["traced_launches"] = sum(e.count for e in ev)
    ref = probe.chain_plain(x, T, rows_blk, passes)
    T2 = probe.two_tap_T(2, dev)
    res["rel_err"] = {
        "dense": err(probe.chain_cuda(x, T, rows_blk, passes), ref),
        "cublas_chain": err(smoke.cublas_chain(x, T, passes), ref),
        "two_tap": err(probe.chain_cuda(x, T2, rows_blk, passes),
                       probe.chain_plain(x, T2, rows_blk, passes))}
    del x, ref
    torch.cuda.empty_cache()
    res["overlap"] = profiling.measure_pipeline_overlap()
    res["ptxas"] = smoke.ptxas_report("chain")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
