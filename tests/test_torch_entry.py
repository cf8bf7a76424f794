"""The port's top-level entry points (``pyfft_tpu_torch.entry``) against the
JAX package's root ``__graft_entry__.py``, loaded by path as it stands.

- ``entry``: the example inputs equal the JAX ones bit for bit; the
  forward step (kernel B's plain version on the CPU) is within 2e-5 of the
  largest value of the JAX forward step (the matmul DFT) for each output.
- ``dryrun_multichip``: in-process on one gloo rank, and over worlds of 4
  and 8 gloo processes on the CPU, whose OK lines carry the JAX run's mesh,
  ``nch``, ``nt``, ``navr`` and ``nfreq`` (``MULTICHIP_r05.json`` at 8);
  ``checks`` lists only the stages that ran.  A stage whose mesh output is
  off by 1e-3 raises ``AssertionError`` naming the stage; a world of the
  wrong size, too few cards, a rank that fails and a world that outlives
  its time limit raise.  Each world has its own limit (240 s here, 60 s a
  collective inside).
"""
import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import pyfft_tpu_torch.parallel as par
from pyfft_tpu_torch import entry as pe
from pyfft_tpu_torch import spectral as psp
from pyfft_tpu_torch.config import default_device

REPO = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 60
FWD_TOL = 2e-5      # forward vs the JAX forward, share of each output's max

_spec = importlib.util.spec_from_file_location(
    "graft_entry", REPO / "__graft_entry__.py")
jentry = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jentry)

# the JAX run's full list of checks (__graft_entry__.py:234-237)
JAX_CHECKS = ("fir/welch(det=1,-1)/reflect-api/sharded-segfill/odd-nwins/"
              "stft/complex-iq/fft4step/bluestein/hilbert")


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _fields(line):
    """The OK line's ``key=value`` fields as strings."""
    head, checks = line.split(", checks=")
    return dict(re.findall(r"(\w+)=(\([^)]*\)|[^,\s]+)", head),
                checks=checks)


def test_entry_args_equal_the_jax_entry_bit_for_bit():
    _, (jx, jy) = jentry.entry()
    _, (x, y) = pe.entry(device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.float32
    for got, want in ((x, jx), (y, jy)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entry_forward_matches_the_jax_forward():
    jfwd, jargs = jentry.entry()
    want = [np.asarray(a, dtype=np.float64) for a in jfwd(*jargs)]
    fwd, args = pe.entry(device="cpu")
    got = fwd(*args)
    assert len(got) == 4
    for g, w, name in zip(got, want, ("Pxx", "Pyy", "Pxy_re", "Pxy_im")):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert tuple(g.shape) == w.shape, name
        err = np.abs(g.double().numpy() - w).max() / np.abs(w).max()
        assert err <= FWD_TOL, (name, err)


def test_entry_forward_takes_kernel_b_route():
    plan, _, _ = pe.flagship_geometry()
    assert (plan.nwins, plan.navr, plan.nnyquist) == (1024, 63, 512)
    assert psp.pallas_route(
        nwins=plan.nwins, noverlap=plan.noverlap, navr=plan.navr,
        nnyquist=plan.nnyquist, onesided=True, detrend_style=1,
        ntmodel=False, is_cplx=False, nch=4) == "B"


def test_entry_forward_raises_where_no_kernel_gate_holds(monkeypatch):
    fwd, args = pe.entry(device="cpu")
    monkeypatch.setattr(psp, "pallas_route", lambda **kw: None)
    with pytest.raises(RuntimeError, match="no kernel"):
        fwd(*args)


def test_dryrun_one_rank_runs_in_process(monkeypatch, capsys):
    def no_world(*a, **kw):
        raise AssertionError("n_devices=1 started rank processes")
    monkeypatch.setattr(pe, "_run_world", no_world)
    line = pe.dryrun_multichip(1, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    f = _fields(line)
    assert line.startswith("dryrun_multichip OK:")
    assert (f["mesh"], f["nch"], f["nt"], f["navr"], f["nfreq"]) == (
        "(1x1)", "2", "4096", "31", "128")
    # the FFT stage needs two ranks: it is not listed
    assert f["checks"] == ("fir/welch(det=1,-1)/reflect-api/"
                           "sharded-segfill/odd-nwins/stft/complex-iq")
    assert not dist.is_initialized()     # the group it started is gone


@pytest.fixture(scope="module")
def world_lines():
    """The OK lines of gloo worlds of 4 and 8 ranks, each world with its
    own time limit."""
    return {n: pe.dryrun_multichip(n, device="cpu", timeout=WORLD_TIMEOUT_S,
                                   collective_timeout=COLLECTIVE_TIMEOUT_S)
            for n in (4, 8)}


def _jax_recorded_fields():
    rec = json.loads((REPO / "MULTICHIP_r05.json").read_text())
    assert rec["n_devices"] == 8 and rec["ok"]
    return _fields(rec["tail"].strip())


@pytest.mark.parametrize("n,want", [
    (4, dict(mesh="(2x2)", nch="4", nt="8192", navr="63", nfreq="128")),
    (8, dict(mesh="(2x4)", nch="4", nt="16384", navr="127", nfreq="128")),
])
def test_dryrun_gloo_world_has_the_jax_fields(world_lines, n, want):
    f = _fields(world_lines[n])
    assert {k: f[k] for k in want} == want
    if n == 8:
        jax_f = _jax_recorded_fields()
        assert {k: jax_f[k] for k in want} == want


def test_dryrun_checks_list_only_the_stages_that_ran(world_lines):
    # at 8 ranks every stage runs (800 % 64 != 0): the JAX run's list
    assert _fields(world_lines[8])["checks"] == JAX_CHECKS
    assert _fields(world_lines[8])["checks"] == \
        _jax_recorded_fields()["checks"]
    # at 4, 16 divides 400: Bluestein does not run and is not listed
    assert _fields(world_lines[4])["checks"] == \
        JAX_CHECKS.replace("/bluestein", "")


def _scaled(fn, pick):
    """``fn`` with its output (or the output ``pick`` of a tuple) scaled
    by 1 + 1e-3."""
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if pick is None:
            return out * (1 + 1e-3)
        out = list(out)
        out[pick] = out[pick] * (1 + 1e-3)
        return tuple(out)
    return wrapped


@pytest.mark.parametrize("name,pick,stage", [
    ("welch_psd_sharded", 1, "stage 2"),      # Pxx
    ("fir_filter_sharded", None, "stage 1"),
    ("stft_sharded", 2, "stage 4b"),          # Xfft
])
def test_dryrun_assertions_bite(monkeypatch, name, pick, stage):
    monkeypatch.setattr(par, name, _scaled(getattr(par, name), pick))
    with pytest.raises(AssertionError, match=stage):
        pe.dryrun_multichip(1, device="cpu")
    assert not dist.is_initialized()


def test_dryrun_in_a_group_of_another_size_raises():
    par.init_distributed(device="cpu")
    try:
        with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\) in a "
                           r"process group of 1 ranks"):
            pe.dryrun_multichip(2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_dryrun_in_an_existing_group_runs_there():
    par.init_distributed(device="cpu")
    try:
        line = pe.dryrun_multichip(1, device="cpu")
        assert dist.is_initialized()      # the caller's group stays
    finally:
        dist.destroy_process_group()
    assert _fields(line)["mesh"] == "(1x1)"


def test_dryrun_more_ranks_than_cards_raises():
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pe.dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")


def test_dryrun_world_raises_with_a_failed_rank_output(monkeypatch):
    false = shutil.which("false")
    if false is None:
        pytest.skip("no `false` program on this host")
    monkeypatch.setattr(sys, "executable", false)
    with pytest.raises(RuntimeError, match=r"rank \d exited with code 1"):
        pe.dryrun_multichip(2, device="cpu", timeout=WORLD_TIMEOUT_S)


def test_dryrun_world_past_its_time_limit_raises():
    with pytest.raises(RuntimeError, match=r"still running after 0\.2 s"):
        pe.dryrun_multichip(2, device="cpu", timeout=0.2)
