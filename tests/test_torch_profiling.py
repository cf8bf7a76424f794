"""utils.profiling, ops.probe and utils.workunits of pyfft_tpu_torch
against the JAX package on the CPU.

- The FLOP models and the 'cpu' peaks are copies: equal.
- ``measure_pipeline_overlap`` on the CPU runs the probes' plain versions
  at a small size and returns the JAX function's fields.
- The plain version of kernel G against the JAX probe's ``work`` math
  (bf16 rounding between passes, float32 accumulation): 5e-3 * max|ref|.
  Summation order alone moves a result by about 1.4e-3 of max|ref| at 12
  passes (float32 against float64 accumulation, measured here), because a
  changed float32 sum can round to the neighbouring bf16 value.
- Kernel F's plain version: float32 column sums, 1e-5 * max|ref|.
- The card holds kernel G to its plain version at 1e-4 * max|ref| on
  ``probe.two_tap_T``, whose chain no order of sums can move
  (``tests/test_torch_cuda.py``, ``chip_smoke.py``,
  ``tests/test_torch_chain_plan.py``); here, at the card test's inputs
  with the dense T, a chain that leaves out the bf16 re-rounding between
  passes misses the plain version by more than ten times that.
- ``fft_pwelch`` and ``HeatPulseFFT.run`` mark their stages as ranges in
  a ``torch.profiler`` trace.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu.utils import profiling as jprof
from pyfft_tpu.utils import workunits as jwu

import pyfft_tpu_torch as pt
from pyfft_tpu_torch.ops import probe
from pyfft_tpu_torch.utils import profiling as prof
from pyfft_tpu_torch.utils import workunits as pwu
from pyfft_tpu_torch.config import default_device

SMALL = dict(nrows=512, N=128, rows_blk=256, passes=3, iters=1)


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


@pytest.mark.parametrize("n,batch,real", [(1, 1, False), (2048, 7, True),
                                          (4871, 155, True),
                                          (16384, 1, False)])
def test_fft_flops_match_jax(n, batch, real):
    assert prof.fft_flops(n, batch, real) == jprof.fft_flops(n, batch, real)


@pytest.mark.parametrize("navr,nwins,nch", [(32767, 2048, 8), (155, 4871, 32),
                                            (1, 16, 0)])
def test_welch_flops_match_jax(navr, nwins, nch):
    assert prof.welch_flops(navr, nwins, nch) == jprof.welch_flops(
        navr, nwins, nch)


@pytest.mark.parametrize("navr,nwins,nch", [(8191, 4096, 8), (3, 16, 0)])
def test_welch_complex_flops_count_every_bin(navr, nwins, nch):
    """The two-sided count: per signal and segment the window on both
    parts, the unhalved complex FFT and 4 flops a bin over all nwins bins;
    the one-sided real count's FFT is half of it."""
    fft = prof.fft_flops(nwins)
    assert prof.welch_complex_flops(navr, nwins, nch) == \
        navr * (1 + nch) * (6 * nwins + fft)
    assert fft == 2 * prof.fft_flops(nwins, real=True)


@pytest.mark.parametrize("method", ["direct", "overlap-save"])
@pytest.mark.parametrize("nt,ntaps,nch", [(1 << 25, 129, 9), (1000, 1024, 1)])
def test_fir_flops_match_jax(method, nt, ntaps, nch):
    assert prof.fir_flops(nt, ntaps, nch, method) == jprof.fir_flops(
        nt, ntaps, nch, method)


def test_cpu_peaks_and_roofline_match_jax():
    assert prof.device_peaks("cpu") == jprof.device_peaks("cpu")
    for unit in ("matmul", "vector"):
        assert prof.roofline(3e9, 2e9, 0.5, kind="cpu", unit=unit) == \
            jprof.roofline(3e9, 2e9, 0.5, kind="cpu", unit=unit)


def test_card_peaks_are_keyed_on_name_and_power_limit():
    smi = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert prof.device_peaks(smi) == (989.0, 67.0, 3350.0)
    assert prof.device_peaks("NVIDIA H100 80GB HBM3, 500.00 W") == \
        prof.device_peaks("NVIDIA H100 80GB HBM3")
    assert prof.peak_tflops("tf32", smi) == 495.0
    for bad in ("NVIDIA A100-SXM4-80GB", "Tesla V100", "NVIDIA H200",
                "NVIDIA H100 80GB HBM3, 800.00 W"):
        with pytest.raises(ValueError):
            prof.device_peaks(bad)


def test_bound_ms_takes_the_larger_time():
    smi = "NVIDIA H100 80GB HBM3, 700.00 W"
    ms, by = prof.bound_ms(1e9, 3.35e9, kind=smi)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = prof.bound_ms(67e9, 1.0, kind=smi)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = prof.bound_ms(989e9, 1.0, unit="bf16", kind=smi)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_analytic_flops_bytes_of_the_four_step_chain():
    nfft = 1 << 24
    flops, nbytes = prof.analytic_flops_bytes(nfft)
    n1, M = 2048, 8192
    assert nbytes == 60.0 * nfft
    assert flops == pytest.approx(5 * nfft * (2 * 11 + 2 * 13) + 18 * nfft)
    assert prof.analytic_flops_bytes(nfft, (1024, 16384))[1] == nbytes
    assert prof.analytic_flops_bytes(4095) == (None, None)
    assert n1 * M == nfft


def test_measure_pipeline_overlap_returns_the_jax_fields():
    j = jprof.measure_pipeline_overlap(**SMALL)
    p = prof.measure_pipeline_overlap(device="cpu", **SMALL)
    assert sorted(p) == sorted(j)
    assert all(np.isfinite(v) and v >= 0 for v in p.values())
    assert 0.0 <= p["overlap_fraction"] <= 1.0
    with pytest.raises(ValueError):
        prof.measure_pipeline_overlap(nrows=500, N=8, rows_blk=256,
                                      device="cpu")


def _jax_work(blk, T, passes):
    """The JAX probe's per-block math (utils/profiling.py:234-242)."""
    acc = jnp.zeros((128, blk.shape[1]), jnp.float32)
    for g in range(blk.shape[0] // 128):
        y = blk[g * 128:(g + 1) * 128].astype(jnp.bfloat16)
        for _ in range(passes):
            y = jnp.dot(T, y, preferred_element_type=jnp.float32
                        ).astype(jnp.bfloat16)
        acc = acc + y.astype(jnp.float32)
    return jnp.sum(acc, axis=0, keepdims=True)


def _probe_inputs(nrows, N):
    x = np.random.default_rng(0).standard_normal((nrows, N)).astype(
        np.float32)
    T = np.random.default_rng(1).standard_normal((128, 128)) / 16.0
    return x, T


@pytest.mark.parametrize("passes,resident", [(0, False), (1, False),
                                             (12, False), (4, True)])
def test_chain_plain_matches_jax_work(passes, resident):
    x, T = _probe_inputs(512, 96)
    Tj = jnp.asarray(T, jnp.bfloat16)
    Tt = torch.as_tensor(T).to(torch.bfloat16)
    np.testing.assert_array_equal(Tt.float().numpy(),
                                  np.asarray(Tj.astype(jnp.float32)))
    blocks = [x[:256]] * 2 if resident else [x[:256], x[256:]]
    ref = sum(np.asarray(_jax_work(jnp.asarray(b), Tj, passes))
              for b in blocks)
    got = probe.chain(torch.from_numpy(x), Tt, 256, passes, resident)
    assert got.shape == (1, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=5e-3 * np.abs(ref).max())


CHAIN_TOL = 1e-4   # kernel G against chain_plain on the card


def _chain_unrounded(x, T, rows_blk, passes, resident):
    """The chain without the bf16 re-rounding between passes: the control
    that ``CHAIN_TOL`` must fail."""
    blocks = x.reshape(-1, rows_blk, x.shape[1])
    nb = blocks.shape[0]
    y = blocks[:1] if resident else blocks
    y = y.reshape(-1, 128, x.shape[1]).to(torch.bfloat16).float()
    for _ in range(passes):
        y = torch.matmul(T.float(), y)
    out = y.sum(dim=(0, 1)).reshape(1, -1)
    return out * nb if resident else out


@pytest.mark.parametrize("passes,resident", [(12, False), (3, True)])
@pytest.mark.parametrize("nrows,N,rows_blk", [(4096, 1152, 512),
                                              (1024, 100, 256),
                                              (2048, 4, 1024)])
def test_chain_tolerance_fails_without_rerounding(nrows, N, rows_blk, passes,
                                                  resident):
    rng = np.random.default_rng(N)          # the card test's inputs
    x = torch.as_tensor(rng.standard_normal((nrows, N)), dtype=torch.float32)
    T = torch.as_tensor(rng.standard_normal((128, 128)) / 16.0).to(
        torch.bfloat16)
    ref = probe.chain_plain(x, T, rows_blk, passes, resident)
    ctl = _chain_unrounded(x, T, rows_blk, passes, resident)
    err = ((ctl - ref).abs().max() / ref.abs().max()).item()
    assert err > 10 * CHAIN_TOL


def test_colsum_plain_matches_jax_sum():
    x, _ = _probe_inputs(1024, 72)
    got = probe.colsum(torch.from_numpy(x), 256)
    ref = np.asarray(jnp.sum(jnp.asarray(x), axis=0, keepdims=True))
    assert got.shape == (1, 72)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())


def test_probe_kernels_refuse_cpu_tensors():
    x = torch.zeros(256, 8)
    T = torch.zeros(128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        probe.colsum_cuda(x, 128)
    with pytest.raises(ValueError):
        probe.chain_cuda(x, T, 128, 1)


def test_stage_log_and_measure():
    # a stage keeps no log of its own (its range in a trace is the
    # record) and runs its block with no profiler running
    assert not hasattr(prof, "stage_log")
    with prof.stage("unit.stage"):
        total = torch.ones(10).sum()
    assert total.item() == 10
    assert prof.measure(torch.ones, 100, iters=2, warmup=1) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(tmp_path / "tr") as p:
        with prof.stage("unit.traced"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    names = {e.key for e in p.key_averages()}
    assert "unit.traced" in names
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "unit.traced"
               for e in events["traceEvents"])


def test_fft_pwelch_and_heatpulse_mark_their_stages(tmp_path):
    fs, nt = 16e3, 1 << 14
    t = np.arange(nt) / fs
    x = np.sin(2 * np.pi * 150.0 * t)
    y = np.stack([x, 0.5 * x])
    with prof.trace(tmp_path / "welch") as p:
        pt.fft_pwelch(t, x, y, tbounds=[t[1], t[-2]], Navr=8, plotit=False,
                      device="cpu")
    counts = {e.key: e.count for e in p.key_averages()}
    assert counts["fft_pwelch.h2d"] == counts["fft_pwelch.device_core"] == 1
    data = pt.heatpulse.synth_heatpulse_data(nch=4, fmod=33.0, fs=8e3, T=2.0)
    hp = pt.HeatPulseFFT({"fmod": 33.0, "harms": [1, 2], "intno2per": 2,
                          "overlap": 0.5, "fwid": 8.0,
                          "tbounds": [0.25, 1.75], "DutyCycle": 0.5,
                          "device": "cpu"}, data)
    hp.PreCheck()
    with prof.trace(tmp_path / "hp") as p:
        hp.run()
    counts = {e.key: e.count for e in p.key_averages()}
    assert counts["heatpulse.fft_pwelch"] == 1
    assert counts["fft_pwelch.device_core"] == 1


def test_report_writes_json_lines(tmp_path):
    path = tmp_path / "perf.jsonl"
    lines = prof.report([{"a": 1}, {"b": 2.5}], path)
    assert lines == jprof.report([{"a": 1}, {"b": 2.5}])
    assert path.read_text().splitlines() == lines


def test_utils_exports_profiling():
    assert pt.utils.profiling is prof


@pytest.mark.parametrize("mod", [pwu, jwu])
def test_workqueue_retries_and_resumes(tmp_path, mod):
    """Per-item retry and failure isolation, then a re-run that skips the
    done items; the port's copy writes the same manifest as the JAX one."""
    calls = []
    flaky = {"b": 1}

    def fn(item):
        calls.append(item)
        if item == "c":
            raise RuntimeError("always")
        if flaky.get(item, 0):
            flaky[item] -= 1
            raise RuntimeError("once")
        return item.upper()

    q = mod.WorkQueue(tmp_path / "m.jsonl", retries=2)
    seen = []
    out = q.run(["a", "b", "c"], fn, on_result=lambda k, v: seen.append(k))
    assert out == {"a": "A", "b": "B"} and seen == ["a", "b"]
    assert calls == ["a", "b", "b", "c", "c", "c"]
    assert q.failed() == {"c"}
    calls.clear()
    out = q.run(["a", "b", "c", "d"], fn)
    assert out == {"d": "D"} and calls == ["c", "c", "c", "d"]
    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(r["key"], r["status"], r["attempt"]) for r in recs][:4] == [
        ("a", "done", 0), ("b", "failed", 0), ("b", "done", 1),
        ("c", "failed", 0)]
