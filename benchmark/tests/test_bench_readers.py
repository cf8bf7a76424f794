"""The metric readers on a hand-built trace of two calls."""
import math

import pytest

from benchmark import harness
from benchmark.tracing import Trace, short_name, union

H100 = "NVIDIA H100 80GB HBM3"


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def two_calls():
    """Two calls of 100 us.  Call 1: h2d copy 10-30, kernel 30-50, d2h
    60-62.  Call 2 (200-300): kernel 220-260.  The program's spans inside
    each call."""
    return [
        ev("user_annotation", "bench.call", 0, 100),
        ev("user_annotation", "bench.call", 200, 100),
        ev("user_annotation", "program.call", 5, 80),
        ev("user_annotation", "fft_pwelch.h2d", 5, 30),
        ev("user_annotation", "fft_pwelch.device_core", 35, 30),
        ev("user_annotation", "program.call", 205, 80),
        ev("user_annotation", "fft_pwelch.h2d", 205, 10),
        ev("user_annotation", "fft_pwelch.device_core", 215, 50),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 20),
        ev("kernel", "void (anonymous namespace)::k<3>(float const*)", 30, 20),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 60, 2),
        ev("kernel", "void (anonymous namespace)::k<3>(float const*)", 220, 40),
        ev("cpu_op", "aten::sum", 62, 30),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]


def ctx(work=None):
    return harness.Context(trace=Trace(two_calls()), work=work or {},
                           card=H100)


def read(name, c):
    return harness.load_module("metrics", name).read(c)


def test_trace_geometry():
    tr = Trace(two_calls())
    assert tr.ncalls == 2 and tr.window == (0.0, 300.0)
    assert tr.busy_us() == 20 + 20 + 2 + 40
    assert tr.busy_us(0, 100) == 42
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_readers():
    c = ctx()
    assert read("copy_ms", c) == pytest.approx(22 / 2 / 1e3)
    assert read("device_ops_per_call", c) == 2.0
    assert read("device_idle_share", c) == pytest.approx(100 * (1 - 82 / 300))
    assert read("host_exposed_ms", c) == pytest.approx(
        ((100 - 42) + (100 - 40)) / 2 / 1e3)


def test_readers_read_nothing_where_the_trace_holds_nothing():
    evs = [e for e in two_calls() if e["cat"] != "gpu_memcpy"]
    c = harness.Context(trace=Trace(evs), work={}, card=H100)
    assert read("copy_ms", c) is None
    evs = [e for e in evs if e["cat"] != "kernel"]
    c = harness.Context(trace=Trace(evs), work={}, card=H100)
    assert read("device_ops_per_call", c) is None


def test_roofline_shares_read_their_own_work_only():
    # 6.7e6 operations: 1e-4 ms, against 60 us of kernels over 2 calls
    assert read("welch_core_roofline", ctx({"other_core": (1.0, 1.0)})) \
        is None
    c = ctx({"welch_core": (6.7e6, 1.0)})
    share = read("welch_core_roofline", c)
    assert share == pytest.approx(100 * 1e-4 / 0.030)
    assert c.notes["welch_core_roofline"]["bound"] == "operations"
    assert 0 < share <= 100


def test_breakdown():
    tr = Trace(two_calls())
    ops = dict(tr.top_device_ops())
    assert ops["void (anon)::k<3>"] == pytest.approx(60e-6)
    gaps = dict(tr.idle_gaps())
    assert math.isclose(sum(gaps.values()), (300 - 82) / 1e6)
    # the gaps 0..10, 50..60, 62..220 (cut at 100 and 200) and 260..300,
    # each piece named by the innermost span over its middle
    assert gaps == pytest.approx({"fft_pwelch.h2d": 30e-6,
                                  "fft_pwelch.device_core": 10e-6,
                                  "aten::sum": 38e-6,
                                  "between calls": 100e-6,
                                  "program.call": 40e-6})
    assert short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_end_to_end_readers():
    c = harness.Context(setup_s=3.5, calls_s=[0.01] * 19 + [0.03],
                        window_s=0.2, samples_per_call=100)
    assert read("samples_per_s", c) == pytest.approx(20 * 100 / 0.2)
    assert read("setup_s", c) == 3.5
    assert 10 < read("call_ms_p95", c) <= 30
