"""The mesh tier of pyfft_tpu_torch (``parallel``: welch, fir, stft,
runtime, and ``fft_pwelch(mesh=...)``) against the JAX package's sharded
functions on its 8-device virtual CPU mesh (x64) and against the port's
own single-device functions, on the CPU.

The port's side runs in worlds of 2 and 4 gloo processes
(``tests/torch_mesh_worker.py``, started once for the file): every rank
takes the same NumPy inputs, and each checks that its results equal rank
0's bit for bit.  The JAX side runs on ``jax.devices()[:ch*t]`` with the
same ``(ch, t)``.  Tolerances are tests/test_parallel.py's: rtol 1e-8,
atol 1e-12 on spectra and the power segments, 1e-9 of max on the
per-segment transforms, rtol 1e-7 / atol 1e-9 on the FIR, 1e-9 / 1e-12 on
the STFT and 1e-8 / 1e-10 of max on the spectrogram.  Every world has its
own time limit (60 s a collective inside, 300 s in all here), so a hang
fails the tests instead of stalling the suite.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import jax

from pyfft_tpu import parallel as jpar
from pyfft_tpu import segmentation as jseg
from pyfft_tpu.spectral import fft_pwelch as jax_pwelch

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import parallel as par
from pyfft_tpu_torch import segmentation as seg
from pyfft_tpu_torch.config import default_device

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_mesh_worker.py"
WORLD_TIMEOUT_S = 300

_spec = importlib.util.spec_from_file_location("torch_mesh_worker", WORKER)
mw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mw)


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run at once: ``{world: (return codes, logs, outputs)}``;
    a world still running after ``WORLD_TIMEOUT_S`` is killed."""
    return mw.run_worlds("welch", tmp_path_factory, WORLD_TIMEOUT_S)


def _world_of(name):
    return next(w for w, cases in mw.CASES.items() if name in cases)


def _result(worlds, name):
    """The outputs of case ``name``; fails with the world's logs if the
    world failed."""
    rcs, logs, data = worlds[_world_of(name)]
    assert rcs == [0] * len(rcs), "\n".join(logs)[-4000:]
    prefix = name + "/"
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def _jmesh(shape):
    ch, t = shape
    return jpar.make_mesh(ch=ch, t=t, devices=jax.devices()[:ch * t])


def _jplan(plan):
    return jseg.SegmentPlan(nsig=plan.nsig, nwins=plan.nwins,
                            noverlap=plan.noverlap, navr=plan.navr,
                            nfft=plan.nfft, nnyquist=plan.nnyquist)


def _close(got, want, rtol=1e-8, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _cases(kind, world=None):
    return [name for w, cases in mw.CASES.items() if world in (None, w)
            for name, case in cases.items() if case["kind"] == kind]


# --------------------------------------------------------------------------- #
# The worlds themselves
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("world", sorted(mw.CASES))
def test_world_runs_and_ranks_agree(worlds, world):
    """Every rank exits 0, which it does only if each of its outputs equals
    rank 0's bit for bit; rank 0 wrote every case."""
    rcs, logs, data = worlds[world]
    assert rcs == [0] * world, "\n".join(logs)[-4000:]
    written = {k.split("/")[0] for k in data if "/" in k}
    assert written == set(mw.CASES[world])


# --------------------------------------------------------------------------- #
# welch_psd_sharded
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", _cases("welch"))
def test_welch_sharded_matches_jax_and_single_device(worlds, name):
    """Against the JAX package's sharded Welch on the same mesh shape and
    the port's single-device ``welch_cross_spectra``.  A ``'pallas'`` case
    runs kernel B's plain version on the ranks' float64 blocks; both
    references take ``torch.fft``/``jnp.fft`` (the JAX mesh path has no
    Pallas kernel)."""
    case = mw.CASES[_world_of(name)][name]
    got = _result(worlds, name)
    x, y, win, plan = mw.welch_inputs(case)
    onesided = case.get("onesided", True)
    kw = dict(onesided=onesided, detrend_style=case["detrend"])
    jf, jPxx, jPyy, jPxy = jpar.welch_psd_sharded(
        x, y, win, _jplan(plan), mw.FS, _jmesh(case["mesh"]),
        fft_backend="xla", **kw)
    ref = pt.welch_cross_spectra(x, y, win, plan, mw.FS, fft_backend="xla",
                                 **kw)
    _close(got["freq"], jf)
    for key, j, single in (("Pxx", jPxx, ref["Pxx"].real),
                           ("Pyy", jPyy, ref["Pyy"].real.T),
                           ("Pxy", jPxy, ref["Pxy"].T)):
        assert got[key].shape == np.shape(j), key
        _close(got[key], j)
        _close(got[key], single)


def test_welch_rank_without_segments():
    """The ownership rule at the geometry of the ``welch_m1x4_idle``
    cases: the last two ranks own no segment (they launch nothing and
    still take part in every collective)."""
    from pyfft_tpu_torch.parallel.welch import owned_segments
    plan = seg.SegmentPlan(nsig=4096, nwins=512, noverlap=256, navr=5,
                           nfft=512, nnyquist=257)
    B, M = par.plan_shard_segments(4096, plan.nwins, plan.hop, plan.navr, 4)
    owned = [owned_segments(d, B, plan.hop, plan.navr) for d in range(4)]
    assert owned == [(0, 4), (4, 1), (8, 0), (12, 0)]
    assert M == 4


@pytest.mark.parametrize("nt,nwins,hop,navr,shards", [
    (4096, 128, 64, 63, 4), (4099, 256, 100, 36, 4), (5000, 512, 512, 8, 2),
    (4096, 1024, 1, 3000, 4), (6000, 64, 64, 10, 8), (8192, 16, 8, 1000, 8)])
def test_owned_segments_partition_the_plan(nt, nwins, hop, navr, shards):
    """Each global segment is owned by exactly one rank, the one whose
    block holds its start, as ``plan_shard_segments`` counts them."""
    from pyfft_tpu_torch.parallel.welch import owned_segments
    L = -(-nt // shards) * shards
    B, M = par.plan_shard_segments(L, nwins, hop, navr, shards)
    got = []
    for d in range(shards):
        g0, m = owned_segments(d, B, hop, navr)
        got += list(range(g0, g0 + m))
        assert all(d * B <= g * hop < (d + 1) * B for g in range(g0, g0 + m))
        assert m <= M
        if m:
            # what the rank reads stays inside its block and halo
            assert (g0 * hop - d * B) + (m - 1) * hop + nwins <= B + nwins - 1
    assert got == list(range(navr))
    assert (B, M) == jpar.plan_shard_segments(L, nwins, hop, navr, shards)


def test_plan_shard_segments_covers_all():
    plan = seg.plan_segments(4096, navr=64, windowoverlap=0.5)
    B, M = par.plan_shard_segments(4096, plan.nwins, plan.hop, plan.navr, 8)
    assert B == 512
    assert (B, M) == jpar.plan_shard_segments(4096, plan.nwins, plan.hop,
                                              plan.navr, 8)


@pytest.mark.parametrize("args,match", [
    ((4096, 1639, 1639, 2, 8), "halo"),
    ((4095, 16, 8, 10, 8), "divisible")])
def test_shard_errors(args, match):
    with pytest.raises(ValueError, match=match):
        par.plan_shard_segments(*args)
    with pytest.raises(ValueError, match=match):
        jpar.plan_shard_segments(*args)


# --------------------------------------------------------------------------- #
# fir_filter_sharded
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", _cases("fir"))
def test_fir_sharded_matches_jax_and_single_device(worlds, name):
    case = mw.CASES[_world_of(name)][name]
    got = _result(worlds, name)["y"]
    x, taps = mw.fir_inputs(case)
    want = jpar.fir_filter_sharded(x, taps, _jmesh(case["mesh"]))
    assert got.shape == x.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got, pt.filters.fir_filter(x, taps),
                               rtol=1e-7, atol=1e-9)


# --------------------------------------------------------------------------- #
# stft_sharded, specgram_sharded
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", _cases("stft"))
def test_stft_sharded_matches_jax_and_single_device(worlds, name):
    case = mw.CASES[_world_of(name)][name]
    got = _result(worlds, name)
    x, t, win, plan = mw.stft_inputs(case)
    kw = dict(onesided=case.get("onesided", True),
              detrend_style=case["detrend"])
    power = case.get("power", False)
    jtt, jf, jX = jpar.stft_sharded(x, t, win, _jplan(plan), mw.FS,
                                    _jmesh(case["mesh"]), power=power, **kw)
    tt1, f1, X1, _ = pt.stft_segments(x, t, win, plan, mw.FS,
                                      fft_backend="xla", **kw)
    X1 = np.abs(X1) ** 2 if power else X1
    assert got["X"].shape == (plan.navr, len(jf))
    assert np.iscomplexobj(got["X"]) != power
    _close(got["freq"], jf, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got["tt"], jtt, rtol=1e-12)
    np.testing.assert_allclose(got["tt"], tt1, rtol=1e-12)
    sc = np.abs(X1).max()
    for want in (jX, X1):
        np.testing.assert_allclose(got["X"], want, rtol=1e-9,
                                   atol=1e-12 * sc)


@pytest.mark.parametrize("name", _cases("specgram"))
def test_specgram_sharded_matches_jax_and_single_device(worlds, name):
    case = mw.CASES[_world_of(name)][name]
    got = _result(worlds, name)
    t, s = mw.specgram_inputs()
    jt, jf, jP = jpar.specgram_sharded(t, s, _jmesh(case["mesh"]), wl=256,
                                       **case["kwargs"])
    tm1, f1, P1 = pt.specgram(t, s, wl=256, **case["kwargs"])
    for want_t, want_f, want_P in ((jt, jf, jP), (tm1, f1, P1)):
        np.testing.assert_allclose(got["fAxis"], want_f, atol=1e-12)
        np.testing.assert_allclose(got["time"], want_t, rtol=1e-12)
        np.testing.assert_allclose(got["P"], np.asarray(want_P), rtol=1e-8,
                                   atol=1e-10 * np.max(want_P))


# --------------------------------------------------------------------------- #
# fft_pwelch(mesh=...)
# --------------------------------------------------------------------------- #

def _pwelch_refs(name):
    """The JAX package's ``fft_pwelch(mesh=...)`` and the port's single-
    device ``fft_pwelch`` on the case's inputs (both with ``jnp.fft`` /
    ``torch.fft``: on the CPU the port's single-device ``'pallas'`` runs
    in float32, and the JAX mesh path has no Pallas kernel)."""
    case = mw.CASES[_world_of(name)][name]
    t, x, y, kw = mw.pwelch_inputs(case)
    kw.pop("fft_backend", None)
    return (jax_pwelch(t, x, y, mesh=_jmesh(case["mesh"]), **kw),
            pt.fft_pwelch(t, x, y, **kw))


_PWELCH = _cases("pwelch")


@pytest.mark.parametrize("name", _PWELCH)
def test_fft_pwelch_mesh_matches_jax_and_single_device(worlds, name):
    got = _result(worlds, name)
    for ref in _pwelch_refs(name):
        _close(got["freq"], ref[0])
        _close(got["Pxx"], ref[2])
        _close(got["Pyy"], ref[3])
        _close(got["Pxy"], ref[1])
        np.testing.assert_allclose(got["phi"], ref[5], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", _PWELCH)
def test_fft_pwelch_mesh_lazy_segment_fill(worlds, name):
    """The per-segment arrays are absent until first touched, then filled
    by the sharded raw STFT (the nT-model's by the single-device core), in
    complex128, and match the JAX package's mesh fill and the port's
    single-device arrays."""
    got = _result(worlds, name)
    assert bool(got["lazy"])
    for ref in _pwelch_refs(name):
        info = ref[6]
        for k in ("Pxx_seg", "Pyy_seg", "Pxy_seg"):
            want = np.asarray(getattr(info, k))
            assert got[k].dtype == np.complex128 and got[k].shape == want.shape
            _close(got[k], want)
        for k in ("Xfft_seg", "Yfft_seg"):
            want = np.asarray(getattr(info, k))
            assert got[k].dtype == np.complex128 and got[k].shape == want.shape
            np.testing.assert_allclose(got[k], want,
                                       atol=1e-9 * np.abs(want).max())


def test_fft_pwelch_one_rank_mesh_in_process():
    """``mesh='auto'`` in a single process: a one-rank gloo group, the same
    result as without a mesh, the lazy fill included."""
    import torch.distributed as dist
    t, x, y = mw.sigs(nt=2000, nch=3)
    kw = dict(Navr=8, plotit=False)
    assert not dist.is_initialized()
    try:
        r2 = pt.fft_pwelch(t, x, y, mesh="auto", **kw)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        X2 = r2[6].Xfft_seg          # the fill is collective: inside the group
    finally:
        dist.destroy_process_group()
    r1 = pt.fft_pwelch(t, x, y, **kw)
    for i in (0, 1, 2, 3):
        _close(r2[i], r1[i])
    np.testing.assert_allclose(X2, r1[6].Xfft_seg,
                               atol=1e-9 * np.abs(r1[6].Xfft_seg).max())


# --------------------------------------------------------------------------- #
# runtime
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("world", sorted(mw.CASES))
def test_audit_collectives_sees_the_design(worlds, world):
    """The sharded Welch issues, on every rank and in one order, the
    moments' all-reduce, one halo exchange, the sums' all-reduce and the
    gather over ``'ch'``; on a rank with a right neighbour the halo carries
    ``(nwins - 1) x (1 + nch_l) x 8`` bytes (float64)."""
    rcs, logs, data = worlds[world]
    assert rcs == [0] * world, "\n".join(logs)[-4000:]
    audits = json.loads(str(data["audit"]))
    nwins = json.loads(str(data["plan"]))[0]
    nch_l = 4
    ops = [[r["op"] for r in rows] for rows in audits]
    assert ops == [["all-reduce", "collective-permute", "all-reduce",
                    "all-gather"]] * world
    for rank, rows in enumerate(audits[:-1]):
        halo = rows[1]
        assert halo["bytes"] == (nwins - 1) * (1 + nch_l) * 8, rank
        assert halo["shapes"] == [f"f64[{1 + nch_l},{nwins - 1}]"]
    assert audits[0][0]["bytes"] == (1 + nch_l) * 8          # the means
    assert all(r["bytes"] > 0 for rows in audits for r in rows)


@pytest.mark.parametrize("world", sorted(mw.CASES))
def test_scaling_report_and_host_mesh(worlds, world):
    rcs, logs, data = worlds[world]
    assert rcs == [0] * world, "\n".join(logs)[-4000:]
    rep = json.loads(str(data["report"]))
    assert rep["axes"] == {"ch": 1, "t": world}
    assert rep["devices"] == world
    assert "gloo" in rep["collectives"]["all_reduce(welch average)"]
    assert "'t'" in rep["collectives"]["isend/irecv(segment/FIR halo)"]
    host = json.loads(str(data["host"]))
    assert host["names"] == ["host", "ch", "t"]
    assert host["shape"] == [1, 2, world // 2]
    assert host["raised"]


@pytest.mark.parametrize("world", sorted(mw.CASES))
def test_measure_scaling(worlds, world):
    """One row per power-of-two time split up to the world size, the
    smallest at efficiency 1, every rate positive."""
    rcs, logs, data = worlds[world]
    assert rcs == [0] * world, "\n".join(logs)[-4000:]
    rows = json.loads(str(data["scaling"]))
    assert [r["t_shards"] for r in rows] == [d for d in (1, 2, 4)
                                             if d <= world]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["samples_per_s"] > 0 and r["wall_s"] > 0 for r in rows)


def test_make_mesh_needs_a_card_or_the_cpu(monkeypatch):
    """The device rule: with no card, no ``device=`` and no package
    default, ``make_mesh`` raises before it starts any process group."""
    import torch
    import torch.distributed as dist
    from pyfft_tpu_torch import config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = config.set_default_device(None)
    try:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            par.make_mesh()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            par.init_distributed()
    finally:
        config.set_default_device(prev)
    assert not dist.is_initialized()


def test_device_counts_without_a_group():
    import torch
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert par.device_counts() == torch.cuda.device_count()
    assert par.Mesh is torch.distributed.device_mesh.DeviceMesh


def test_make_mesh_returns_the_same_mesh_in_one_world():
    """The same arguments in one world give the same mesh (no new process
    groups); another shape a new one; a new world new meshes."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        m = par.make_mesh(1, 1)
        assert par.make_mesh(1, 1) is m
        assert par.make_mesh(1, 1, devices=[0]) is m
        assert par.make_mesh(1) is m
    finally:
        dist.destroy_process_group()
    try:
        m2 = par.make_mesh(1, 1)
        assert m2 is not m and tuple(m2.get_coordinate()) == (0, 0)
    finally:
        dist.destroy_process_group()
