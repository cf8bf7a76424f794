"""The port's profiler ranges on the CPU, and the benchmark's readers of
them.

- ``utils.profiling.stage`` opens a ``record_function`` range only while a
  profiler runs; without one it only runs its block (and the whole
  ``welch_filtered_cross_spectra`` call opens none).
- ``welch_filtered_cross_spectra`` marks the call, its arguments and, on
  the kernel path, its finalization, nested; CPU tensors are never copied,
  so no ``copy.d2h`` range appears.  (The card's ranges, kernel B's
  ``welch_cuda.prologue`` and ``welch_cuda.launch`` and the one copy
  back, are held in ``tests/test_torch_cuda.py``.)
- The readers ``enqueue_ms``, ``host_syncs_per_call``,
  ``return_exposed_ms`` and ``finalize_ms`` on a hand-built trace of two
  calls, and None on a trace of a program without the ranges.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.tracing import Trace

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import segmentation as pseg
from pyfft_tpu_torch.utils import profiling as prof

OUTER = "welch_filtered_cross_spectra"


def _counting_ranges(monkeypatch):
    """Patch the entry of a ``record_function`` range (as ``stage`` enters
    it) to note each name it opens; returns the list of names."""
    names = []
    real = torch.autograd._record_function_with_args_enter

    def counting(name, *args):
        names.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        counting)
    return names


def _annotations(p, tmp_path):
    """``[(name, start, end), ...]`` of the trace's user annotations."""
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _chain(backend):
    """The FIR + Welch chain on 2 channels of 2^13 samples on the CPU."""
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal(1 << 13), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal((2, 1 << 13)),
                        dtype=torch.float32)
    plan = pseg.plan_segments(1 << 13, nwins=256, windowoverlap=0.5)
    return pt.welch_filtered_cross_spectra(
        x, y, np.hanning(17) / np.hanning(17).sum(), np.hanning(256), plan,
        1e3, fft_backend=backend, device="cpu")


def test_stage_opens_no_range_without_a_profiler(monkeypatch):
    names = _counting_ranges(monkeypatch)
    with prof.stage("unit.off"):
        out = torch.ones(4).sum()
    assert out.item() == 4 and names == []
    _chain("pallas")
    assert names == []


def test_stage_records_a_user_annotation_under_a_profiler(monkeypatch,
                                                          tmp_path):
    names = _counting_ranges(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.stage("unit.on"):
            torch.ones(4).sum()
    assert names == ["unit.on"]
    assert [a[0] for a in _annotations(p, tmp_path)] == ["unit.on"]


@pytest.mark.parametrize("backend,children", [
    ("pallas", [f"{OUTER}.args", f"{OUTER}.finalize"]),
    ("xla", [f"{OUTER}.args"]),          # the filter-first route
])
def test_welch_filtered_cross_spectra_marks_its_stages(tmp_path, backend,
                                                       children):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = _chain(backend)
    assert out["Pxy"].shape == (out["freq"].size, 2)
    spans = _annotations(p, tmp_path)
    outer = [s for s in spans if s[0] == OUTER]
    assert len(outer) == 1
    _, lo, hi = outer[0]
    inner = sorted((s for s in spans if s[0] != OUTER), key=lambda s: s[1])
    assert [s[0] for s in inner] == children
    assert all(lo <= s <= e <= hi for _, s, e in inner)
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


# --------------------------------------------------------------------------- #
# The readers, on a hand-built trace of two calls (times in us)
# --------------------------------------------------------------------------- #

def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def span(name, s, e):
    return ev("user_annotation", name, s, e - s)


def device(cat, name, s, e):
    return ev(cat, name, s, e - s)


def program_calls():
    """Call 1 (0-1000): kernel B 200-700 after a prologue kernel 100-140;
    four copies back, the first waiting for B.  Call 2 (2000-3000): two
    copies back.  A copy outside both calls counts for neither."""
    return [span("bench.call", 0, 1000), span("bench.call", 2000, 3000),
           span(OUTER, 10, 950), span(f"{OUTER}.args", 10, 60),
           span("welch_cuda.prologue", 65, 120),
           span("welch_cuda.launch", 120, 200),
           span(f"{OUTER}.finalize", 205, 940),
           span("copy.d2h", 205, 710), span("copy.d2h", 720, 730),
           span("copy.d2h", 740, 750), span("copy.d2h", 760, 770),
           device("kernel", "reduce_kernel", 100, 140),
           device("kernel", "welch_pair_kernel", 200, 700),
           device("gpu_memcpy", "Memcpy DtoH", 700, 705),
           device("gpu_memcpy", "Memcpy DtoH", 722, 724),
           device("gpu_memcpy", "Memcpy DtoH", 742, 744),
           device("gpu_memcpy", "Memcpy DtoH", 762, 764),
           span(OUTER, 2010, 2900), span(f"{OUTER}.args", 2010, 2050),
           span("welch_cuda.prologue", 2050, 2100),
           span("welch_cuda.launch", 2100, 2300),
           span(f"{OUTER}.finalize", 2300, 2890),
           span("copy.d2h", 2310, 2810), span("copy.d2h", 2820, 2830),
           device("kernel", "welch_pair_kernel", 2300, 2800),
           device("gpu_memcpy", "Memcpy DtoH", 2800, 2802),
           device("gpu_memcpy", "Memcpy DtoH", 2822, 2826),
           span("copy.d2h", 1500, 1510)]


def read(name, events):
    c = harness.Context(trace=Trace(events), work={}, card=None)
    return harness.load_module("metrics", name).read(c)


def test_program_span_readers():
    evs = program_calls()
    # launch ends 200 and 2300, the call starts 10 and 2010
    assert read("enqueue_ms", evs) == pytest.approx((190 + 290) / 2 / 1e3)
    assert read("host_syncs_per_call", evs) == 3.0
    # idle in the copies: call 1 5 + 8 + 8 + 8, call 2 8 + 6
    assert read("return_exposed_ms", evs) == pytest.approx(
        (29 + 14) / 2 / 1e3)
    # finalize less its copies: 735 - 535 and 590 - 510
    assert read("finalize_ms", evs) == pytest.approx((200 + 80) / 2 / 1e3)


@pytest.mark.parametrize("name", ["enqueue_ms", "host_syncs_per_call",
                                  "return_exposed_ms", "finalize_ms"])
def test_program_span_readers_read_nothing_without_the_ranges(name):
    evs = [e for e in program_calls()
           if e["cat"] != "user_annotation" or e["name"] == "bench.call"]
    assert read(name, evs) is None
