"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the metrics.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the sizes, the source, the guarantees and the
  limits of the comparison; ``configs/<config>.py``: the inputs made from
  the seed, the plain reference, the control, the comparison and the work
  a call needs (imports nothing of the program);
- ``programs/<config>.py``: the system under test, ``prepare(cfg, inputs,
  device)`` once and ``call(state, record)`` per call, results as NumPy;
- ``traffic/<traffic>.json``: the parameters :mod:`benchmark.traffic`
  reads;
- ``metrics/<metric>.py``: ``read(ctx)``, the metric's value or None where
  the run holds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark import traffic

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CALL_SPAN = "bench.call"
FORBIDDEN = ("jax", "jaxlib", "flax", "pyfft_tpu")


class NoCard(RuntimeError):
    """The cell asks for more cards than this machine shows."""


def load_spec() -> dict:
    """BENCHMARK.json, from the root of the checkout."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by file (a name
    may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(spec: dict, workload: str) -> dict:
    """The cell ``workload`` with its configuration entry and the metrics
    it reports: the end-to-end metrics that list it (or list no cells), and
    the per-layer metrics that list it (or, listing no cells, move one of
    its end-to-end metrics)."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return dict(cell=cell, config=config, end_to_end=e2e, per_layer=layer)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``pyfft_tpu_torch`` is not ``pyfft_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info(device: str, chips: int) -> dict:
    """The card the run measures: its name, the count the cell uses and the
    power limit ``nvidia-smi`` reads.  Refuses where the cell's cards are
    not there: a run never falls back to the CPU."""
    import torch
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1, power_limit_w=None)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"the cell asks for {chips} CUDA card(s); this machine "
                     f"shows {n}")
    power = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True)
        power = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, power_limit_w=power)


class Context:
    """What a metric's reader gets.  Every run: ``setup_s``, ``calls_s``
    (each call's wall in the window), ``window_s`` and
    ``samples_per_call``.  A ``--trace 1`` run also: ``trace``
    (:class:`benchmark.tracing.Trace` of the traced stretch), ``work``
    (``{core: (operations, bytes)}`` a call needs) and ``card``; a reader
    records how it read (a roofline's bound) in ``notes``."""

    def __init__(self, **kw):
        self.trace = None
        self.work = {}
        self.card = None
        self.notes = {}
        self.__dict__.update(kw)


def _sync(device):
    import torch
    if device != "cpu":
        torch.cuda.synchronize()


def _window(call, state, pool, mix, seconds, first, rng, traced):
    """The closed loop: call after call on the pool's records in turn, until
    ``seconds`` have passed.  Returns each call's wall, the window's
    length and a sample, drawn from ``rng``, of ``(call, record,
    outputs)`` (reservoir sampling: each call is equally likely)."""
    import torch
    k = mix["sample_calls"]
    times, sample = [], []
    n = 0
    w0 = t = time.perf_counter()
    while t - w0 < seconds:
        idx = traffic.record_index(mix, first + n)
        t1 = time.perf_counter()
        if traced:
            with torch.profiler.record_function(CALL_SPAN):
                out = call(state, pool[idx])
        else:
            out = call(state, pool[idx])
        t = time.perf_counter()
        times.append(t - t1)
        if n < k:
            sample.append((n, idx, out))
        else:
            j = rng.randrange(n + 1)
            if j < k:
                sample[j] = (n, idx, out)
        n += 1
    return times, t - w0, sample


def _traced_window(call, state, pool, mix, seconds, first, rng, device):
    """The window under ``torch.profiler``; returns the window's results
    and the parsed trace."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.tracing import Trace
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            res = _window(call, state, pool, mix, seconds, first, rng, True)
            _sync(device)
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        events = json.loads(path.read_text())["traceEvents"]
    return res, Trace(events)


def check(inputs, cfg, pool, sample, device) -> tuple:
    """Compare each sampled call's outputs with the reference of its record
    (worked out once a record).  Returns ``(worst readings, calls over a
    limit)``."""
    limits = cfg["limits"]
    refs, worst, failed = {}, {}, 0
    for _, idx, out in sample:
        if idx not in refs:
            refs[idx] = inputs.reference(cfg, pool[idx], device)
        nums = inputs.compare(cfg, out, refs[idx])
        bad = False
        for name, v in nums.items():
            v = float(v)
            worst[name] = max(worst.get(name, v), v) if math.isfinite(v) \
                else math.inf
            if not (v <= limits[name]):
                bad = True
        failed += bad
    return worst, failed


def run_cell(workload, seed, seconds, trace, *, device="cuda", t0=None,
             cfg_override=None, call_wrapper=None):
    """One run.  Returns ``(result line dict, check lines)``.

    ``cfg_override`` and ``call_wrapper`` are for the tests only: a smaller
    configuration for the CPU, and the program's call with a fault
    planted."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    marks = [("torch", time.perf_counter())]
    cs = cell_spec(load_spec(), workload)
    card = card_info(device, cs["cell"]["chips"])
    marks.append(("card", time.perf_counter()))
    cfg = json.loads((ROOT / cs["config"]["file"]).read_text())
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    inputs = load_module("configs", cs["config"]["name"])
    program = load_module("programs", cs["config"]["name"])
    mix = traffic.load(cs["cell"]["traffic"])
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in (cs["per_layer"] if trace else cs["end_to_end"])}

    torch.manual_seed(traffic.seed_of(seed))
    pool = traffic.make_pool(mix, cfg, inputs, seed, device)
    _sync(device)
    marks.append(("pool", time.perf_counter()))
    state = program.prepare(cfg, inputs, device)
    marks.append(("program", time.perf_counter()))
    call = program.call if call_wrapper is None else call_wrapper(program.call)
    for i in range(mix["warm_calls"]):
        call(state, pool[traffic.record_index(mix, i)])
    _sync(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    rng = random.Random(traffic.seed_of(seed))
    first = mix["warm_calls"]
    tr = None
    if trace:
        (times, window_s, sample), tr = _traced_window(
            call, state, pool, mix, min(seconds, mix["trace_seconds"]),
            first, rng, device)
    else:
        times, window_s, sample = _window(call, state, pool, mix, seconds,
                                          first, rng, False)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del state, call
    if device != "cpu":
        torch.cuda.empty_cache()

    worst, failed = check(inputs, cfg, pool, sample, device)
    limits = cfg["limits"]
    correct = (bool(times) and bool(sample) and failed == 0
               and set(worst) == set(limits))

    ctx = Context(setup_s=setup_s, calls_s=times, window_s=window_s,
                  samples_per_call=inputs.samples(cfg), trace=tr,
                  work=inputs.work_counts(cfg), card=card["kind"])
    metrics = {}
    for m in (cs["per_layer"] if trace else cs["end_to_end"]):
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = dict(platform=card["platform"], kind=card["kind"],
               count=card["count"], memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=len(times), failed=failed,
                  metrics=metrics, device=dev)
    if tr is not None:
        dev["busy_s"] = tr.busy_us() / 1e6
        dev["window_s"] = tr.window_us / 1e6
        result["breakdown"] = dict(device_ops=tr.top_device_ops(),
                                   idle_gaps=tr.idle_gaps())
    dev["power_limit_w"] = card["power_limit_w"]
    q = np.percentile(np.asarray(times) * 1e3, [0, 25, 50, 75, 100])
    result["call_ms"] = dict(zip(("min", "q1", "median", "q3", "max"),
                                 q.tolist()))
    result["setup_split_s"] = {k: t - t_prev for (k, t), (_, t_prev)
                               in zip(marks, [("start", t0)] + marks[:-1])}
    if ctx.notes:
        result["roofline_bounds"] = ctx.notes
    result["checks"] = {k: {"value": worst.get(k), "limit": lim}
                        for k, lim in limits.items()}
    lines = [f"check {k} {worst.get(k)!r} limit {lim!r} "
             f"{'ok' if worst.get(k, math.inf) <= lim else 'FAIL'}"
             for k, lim in limits.items()]
    lines.append(f"correct {correct}: {len(sample)} of {len(times)} calls "
                 f"compared, {failed} over a limit")
    return result, lines
