"""Time kernels A and I (the causal FIR and the FIR-transpose feeder) of
one pyfft_tpu_torch tree on a CUDA card, and fingerprint what kernels A,
I, B and H compute there.

    python3 scripts/torch_fir_ab.py TREE

TREE is a directory that holds a ``pyfft_tpu_torch`` package (``.`` for
this checkout, or an unpacked ``git archive`` of another commit).  The
script builds that tree's kernels and, on bench config 0's signals
(``chip_smoke.signals``: x and 8 channels of 2^25 float32 samples), prints
one JSON line with:

- ``fir_129``, ``fir_1024``: ``ops.fir.fir_cuda`` on the 9 signals with
  the 129-tap band-pass and with chip_smoke.py's seeded 1024 taps;
  ``fir_t``: ``ops.fir.fir_t_cuda`` into the ``(2^18 + 512, 9 * 128)``
  layout without ``sub``; ``conv1d_129``: ``torch.nn.functional.conv1d``
  on the same signals and taps.  Each the median and quartiles (``ms``,
  ``q``) of 25 calls (10 at 1024 taps) by CUDA events after a warm-up;
- ``kernel_device_ms``: ``fir_kernel``'s and ``fir_t_kernel``'s device
  time a launch at 129 taps, from one ``torch.profiler`` trace of five
  calls each (``traced_launches``: the launches it recorded);
- ``sha256``: a fingerprint of the bytes of each output above and of
  kernel B's (``welch.welch_cuda`` at config 0: nwins 2048, hop 1024, the
  band-pass) and kernel H's (``packed=True`` at config 1: 2^24 samples,
  nwins 4096, hop 2048), so two trees' lines show whether a change moved
  a bit;
- ``ptxas``: ptxas' report of both FIR kernels from the build's log;
- ``sass_loop``: for each FIR kernel, the instructions of its loop with
  the most FFMAs (``cuobjdump -sass`` of the built library; the body
  between a branch's target and the branch back to it), counted by
  opcode;
- ``nvidia_smi``: the card's name and power limit.

To compare two commits, run both trees in one call on one card, in turns:
parent, change, change, parent.
"""
import hashlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def sass_loop(lib, kernel):
    """Opcode counts of the loop of ``kernel`` with the most FFMAs (the
    shortest of those) in ``cuobjdump -sass`` of ``lib``, or the error
    that stopped the count."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)[:200]}
    body, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = kernel in line
        elif keep:
            body.append(line)
    ops, best = [], None
    for line in body:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                     r"(.*?);", line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(3)
        ops.append((addr, op))
        # cuobjdump gives a branch's target as an address: back is a loop
        t = re.match(r"\s*(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", m.group(4))
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            counts = {}
            for a, o in ops:
                if a >= int(t.group(1), 16):
                    counts[o] = counts.get(o, 0) + 1
            ffma = sum(v for k, v in counts.items() if k.startswith("FFMA"))
            n = sum(counts.values())
            if ffma and (best is None or (ffma, -n) > best[:2]):
                best = (ffma, -n, counts)
    if best is None:
        return {"error": "no loop with an FFMA found"}
    return {"instructions": -best[1], "ffma": best[0], "ops": best[2]}


def main():
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    # chip_smoke.py's helpers, from this checkout whatever TREE is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch.ops import _build, fir, welch
    if not pt.__file__.startswith(tree):
        raise RuntimeError(f"pyfft_tpu_torch imported from {pt.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda")
    nt = 1 << 25
    x, y = smoke.signals(nt, dev)
    sig = torch.cat([x[None], y])
    taps = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    long_taps = np.random.default_rng(smoke.SEED + 1).standard_normal(
        1024) / 32
    nrows = (1 << 18) + 512
    wflip = torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                            dtype=torch.float32, device=dev).view(1, 1, -1)

    def fingerprint(out):
        h = hashlib.sha256()
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    res = {"tree": sys.argv[1],
           "nvidia_smi": smoke.smi_query("name,power.limit")}
    calls = {
        "fir_129": (lambda: fir.fir_cuda(sig, taps), 25),
        "fir_1024": (lambda: fir.fir_cuda(sig, long_taps), 10),
        "fir_t": (lambda: fir.fir_t_cuda(x, y, taps, nrows), 25),
        "conv1d_129": (lambda: torch.nn.functional.conv1d(
            sig.view(-1, 1, nt), wflip, padding=len(taps) - 1), 25),
    }
    for name, (fn, reps) in calls.items():
        runs = smoke.time_runs(fn, reps)
        res[name] = dict(ms=statistics.median(runs),
                         q=statistics.quantiles(runs, n=4))
    res["kernel_device_ms"], res["traced_launches"] = {}, {}
    for kernel, fn in (("fir_kernel", calls["fir_129"][0]),
                       ("fir_t_kernel", calls["fir_t"][0])):
        ms, tr = smoke.trace_launches(fn, kernel)
        res["kernel_device_ms"][kernel] = ms
        res["traced_launches"][kernel] = tr["kernel_launches"]
    res["sha256"] = {name: fingerprint(calls[name][0]())
                     for name in ("fir_129", "fir_1024", "fir_t")}
    for name, n, nch, nwins, hop, tp, packed in (
            ("welch_config0", nt, 8, 2048, 1024, taps, False),
            ("packed_config1", 1 << 24, 0, 4096, 2048, None, True)):
        navr = (n - nwins) // hop + 1
        win = np.hanning(nwins + 1)[:-1]
        res["sha256"][name] = fingerprint(welch.welch_cuda(
            x[:n], y[:nch, :n], win, nwins // 2 + 1, 1.0 / navr, navr=navr,
            nwins=nwins, hop=hop, taps=tp, detrend_style=1, packed=packed))
    res["ptxas"] = {k: smoke.ptxas_report(k)
                    for k in ("fir_kernel", "fir_t_kernel")}
    res["sass_loop"] = {k: sass_loop(_build.build(), k)
                        for k in ("fir_kernel", "fir_t_kernel")}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
