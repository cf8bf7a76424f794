"""The mesh tier's FFT half of pyfft_tpu_torch (``parallel.fft``: the
four-step and Bluestein FFT over all-to-all, ``axis_swap``,
``hilbert_sharded``, ``envelope_phase(mesh=...)``; ``runtime``'s scaling
projections; ``utils.profiling.interconnect_peaks``) against the JAX
package's sharded functions on its virtual CPU mesh (x64), NumPy and SciPy.

The port's side runs in worlds of 2 and 4 gloo processes
(``tests/torch_mesh_worker.py``'s ``fft`` suite, started once for the
file): every rank takes the same NumPy inputs, its blocks are joined over
the ranks, each rank's block must equal its slice of the join bit for bit
and every rank's outputs rank 0's.  The JAX side runs on
``jax.devices()[:ch*t]`` with the same ``(ch, t)``.  At each world size one
length takes the four-step (``d^2 | N``) and one Bluestein.  Tolerances are
tests/test_parallel_fft.py's: rtol 1e-9 with atol 1e-7 (Bluestein: 1e-8 of
max) on transforms, 1e-8 of max on the analytic signal, 2e-5 of max on the
envelope and 1e-4 rad modulo 2 pi on the phase.  Every world has its own
time limit (60 s a collective inside, 300 s in all here).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import jax
import torch
from scipy.signal import hilbert as sp_hilbert

from pyfft_tpu import parallel as jpar
from pyfft_tpu.hilbert import envelope_phase as jax_envelope_phase

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import parallel as par
from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.parallel import fft as pfft
from pyfft_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent
WORLD_TIMEOUT_S = 300

_spec = importlib.util.spec_from_file_location(
    "torch_mesh_worker", HERE / "torch_mesh_worker.py")
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
    return mw.run_worlds("fft", tmp_path_factory, WORLD_TIMEOUT_S)


def _world_of(name):
    return next(w for w, cases in mw.FFT_CASES.items() if name in cases)


def _case(name):
    return mw.FFT_CASES[_world_of(name)][name]


def _data(worlds, world):
    rcs, logs, data = worlds[world]
    assert rcs == [0] * len(rcs), "\n".join(logs)[-4000:]
    return data


def _result(worlds, name):
    """The outputs of case ``name``; fails with the world's logs if the
    world failed."""
    data = _data(worlds, _world_of(name))
    prefix = name + "/"
    return {k[len(prefix):]: v for k, v in data.items()
            if k.startswith(prefix)}


def _jmesh(shape):
    ch, t = shape
    return jpar.make_mesh(ch=ch, t=t, devices=jax.devices()[:ch * t])


def _join(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _transform_close(got, want, case):
    """tests/test_parallel_fft.py's bounds: atol 1e-7 on the four-step,
    1e-8 of max on Bluestein."""
    d = case["mesh"][1]
    atol = 1e-7 if case["n"] % (d * d) == 0 else 1e-8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=atol)


def _cases(*kinds):
    return [name for cases in mw.FFT_CASES.values()
            for name, case in cases.items() if case["kind"] in kinds]


# --------------------------------------------------------------------------- #
# The worlds themselves
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("world", sorted(mw.FFT_CASES))
def test_world_runs_and_ranks_agree(worlds, world):
    """Every rank exits 0, which it does only if each of its blocks equals
    its slice of the joined result and each of its outputs rank 0's, bit
    for bit; rank 0 wrote every case."""
    data = _data(worlds, world)
    written = {k.split("/")[0] for k in data if "/" in k}
    assert written == set(mw.FFT_CASES[world])


def test_both_routes_at_both_world_sizes():
    for world, cases in mw.FFT_CASES.items():
        ns = {c["n"] for c in cases.values() if c["kind"] == "fft"
              and c["mesh"] == (1, world)}
        assert {n % (world * world) == 0 for n in ns} == {True, False}
        assert all(n % world == 0 for n in ns)


# --------------------------------------------------------------------------- #
# fft_sharded, ifft_sharded, rfft_sharded, irfft_sharded
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", _cases("fft", "ifft"))
def test_fft_sharded_matches_jax_and_numpy(worlds, name):
    case = _case(name)
    got = _result(worlds, name)["X"]
    x = mw.fft_input(case)
    want = _join(jpar.fft_sharded(x, _jmesh(case["mesh"])))
    assert got.shape == x.shape and got.dtype == np.complex128
    _transform_close(got, want, case)
    _transform_close(got, np.fft.fft(x, axis=-1), case)


@pytest.mark.parametrize("name", _cases("ifft"))
def test_ifft_sharded_round_trip(worlds, name):
    case = _case(name)
    got = _result(worlds, name)["back"]
    x = mw.fft_input(case)
    want = _join(jpar.ifft_sharded(np.fft.fft(x), _jmesh(case["mesh"])))
    np.testing.assert_allclose(got, x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", _cases("rfft"))
def test_rfft_irfft_sharded(worlds, name):
    """The half spectrum, the round trip and the truncated spectrum's
    zero-padded inverse (``numpy.fft.irfft``'s contract), on every rank."""
    case = _case(name)
    got = _result(worlds, name)
    x, n = mw.fft_input(case), case["n"]
    jmesh = _jmesh(case["mesh"])
    ref = np.fft.rfft(x)
    jre, jim = jpar.rfft_sharded(x, jmesh)
    for want in (ref, jre + 1j * jim):
        np.testing.assert_allclose(got["re"] + 1j * got["im"], want,
                                   rtol=1e-9, atol=1e-8 * np.abs(ref).max())
    np.testing.assert_allclose(got["back"], x, atol=1e-9)
    short = np.fft.irfft(ref[..., :n // 4], n=n)
    np.testing.assert_allclose(got["short"], short, atol=1e-9)
    np.testing.assert_allclose(
        got["short"], jpar.irfft_sharded(jre[..., :n // 4], jim[..., :n // 4],
                                         n, jmesh), atol=1e-9)


# --------------------------------------------------------------------------- #
# hilbert_sharded, envelope_phase(mesh=...)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", _cases("hilbert"))
def test_hilbert_sharded_matches_jax_and_scipy(worlds, name):
    case = _case(name)
    got = _result(worlds, name)["z"]
    x = mw.fft_input(case)
    want = sp_hilbert(x, axis=-1)
    scl = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-8 * scl)
    np.testing.assert_allclose(
        got, _join(jpar.hilbert_sharded(x, _jmesh(case["mesh"]))),
        atol=1e-8 * scl)


@pytest.mark.parametrize("name", _cases("envelope"))
def test_envelope_phase_mesh_matches_jax_and_single_device(worlds, name):
    case = _case(name)
    got = _result(worlds, name)
    x = mw.fft_input(case)
    refs = (jax_envelope_phase(x, mesh=_jmesh(case["mesh"])),
            pt.hilbert_mod.envelope_phase(x))
    for env, ph in refs:
        assert got["env"].shape == env.shape == x.shape
        assert got["env"].dtype == got["ph"].dtype == np.float32
        np.testing.assert_allclose(got["env"], env,
                                   atol=2e-5 * np.abs(env).max())
        dphi = np.angle(np.exp(1j * (got["ph"].astype(np.float64)
                                     - np.asarray(ph, np.float64))))
        np.testing.assert_allclose(dphi, 0.0, atol=1e-4)


# --------------------------------------------------------------------------- #
# axis_swap and the errors
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("world", sorted(mw.FFT_CASES))
def test_axis_swap_values_and_blocks(worlds, world):
    got = _result(worlds, f"axis_swap_m1x{world}")
    x = np.random.default_rng(3).standard_normal((16, 24)).astype(np.float32)
    np.testing.assert_array_equal(got["y"], x)
    assert got["shape"].tolist() == [16, 24 // world]


@pytest.mark.parametrize("world", sorted(mw.FFT_CASES))
def test_errors_where_jax_raises(worlds, world):
    """A length that does not divide by the ranks, axes that do not split,
    and a transform axis other than the last raise ``ValueError`` in both
    packages."""
    name = f"errors_m1x{world}"
    got = {k: str(v) for k, v in _result(worlds, name).items()}
    assert "not divisible" in got["fft"] and "not divisible" in got["hilbert"]
    assert "divide by" in got["axis_swap"]
    assert "LAST axis" in got["envelope_axis"]
    jmesh = _jmesh((1, world))
    rng = np.random.default_rng(4)
    with pytest.raises(ValueError):
        jpar.fft_sharded(rng.standard_normal(_case(name)["n"]), jmesh)
    with pytest.raises(ValueError):
        jpar.axis_swap(rng.standard_normal((16, 7)), jmesh, "t", 0, 1)
    with pytest.raises(ValueError, match="LAST axis"):
        jax_envelope_phase(np.ones((4, 64)), axes=0, mesh=jmesh)


@pytest.mark.parametrize("n,d", [(n, d) for n in (1, 4, 16, 64, 100, 1000,
                                                  1002, 1024, 1152, 3600,
                                                  4096, 1 << 20)
                                 for d in (1, 2, 3, 4, 8)])
def test_four_step_factor_matches_jax(n, d):
    from pyfft_tpu.parallel.fft import four_step_factor as jfactor
    try:
        want = jfactor(n, d)
    except ValueError:
        with pytest.raises(ValueError):
            par.four_step_factor(n, d)
        return
    assert par.four_step_factor(n, d) == want


# --------------------------------------------------------------------------- #
# The collectives of a transform
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("block", [1, 7, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_twiddle_table_exact_in_blocks(monkeypatch, block, dtype):
    """The twiddle table, built in row blocks of any size, is W_N^(k1*n2)
    from the exact integer product in float64, rounded once; a second
    call returns the cached table."""
    n, n1, d = 4096, 64, 4
    cols = n // n1 // d
    monkeypatch.setattr(pfft, "_TWIDDLE_BLOCK", block)
    pfft._twiddle.cache_clear()
    np_dt = np.complex64 if dtype == torch.complex64 else np.complex128
    for r in range(d):
        got = pfft._twiddle(n, n1, cols, r, torch.device("cpu"), dtype)
        k1n2 = np.arange(n1)[:, None] * (np.arange(cols) + r * cols)
        want = np.exp(-2j * np.pi * k1n2.astype(np.float64) / n).astype(np_dt)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * np.finfo(np_dt).eps)
    assert pfft._twiddle(n, n1, cols, d - 1, torch.device("cpu"),
                         dtype) is got
    pfft._twiddle.cache_clear()


@pytest.mark.parametrize("name", _cases("audit"))
def test_audit_all_to_alls(worlds, name):
    """A four-step transform issues three all-to-alls on every rank, each
    of ``n/d`` complex128 elements; Bluestein two four-steps of ``M/d``
    and the two re-blockings around them, the second of ``n/d``."""
    case = _case(name)
    n, d = case["n"], case["mesh"][1]
    audits = json.loads(str(_result(worlds, name)["rows"]))
    assert len(audits) == d
    for rows in audits:
        assert all(r["shapes"][0].startswith("c128[") for r in rows)
        if n % (d * d) == 0:
            assert [r["op"] for r in rows] == ["all-to-all"] * 3
            assert [r["bytes"] for r in rows] == [n // d * 16] * 3
        else:
            M = pfft.bluestein_size(n, d)
            assert [r["op"] for r in rows] == ["all-to-all"] * 8
            assert [r["bytes"] for r in rows[1:7]] == [M // d * 16] * 6
            assert rows[7]["bytes"] == n // d * 16


# --------------------------------------------------------------------------- #
# The scaling projections and the link peaks
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_projections():
    """The JAX functions at the worker's shapes, on 4 of its 8 devices."""
    chain = jpar.project_scaling(**mw.PROJECTION)
    paths = jpar.project_scaling_paths(**mw.PATHS)
    return chain, paths


def _keys(d):
    """The nested keys of a projection, lists of rows left out."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_project_scaling_matches_jax_and_the_model(worlds, jax_projections):
    proj = json.loads(str(_data(worlds, 4)["projection"]))
    r, small = proj["chain"], proj["small"]
    jchain, _ = jax_projections
    assert _keys(r) == _keys(jchain)
    w = r["workload"]
    assert r["bytes"]["halo_ppermute"] >= (w["nwins"] - 1) * (1 + w["nch"]) * 4
    assert r["bytes"]["psum_allreduce"] > 0
    ops = {c["op"] for c in r["collectives"]}
    assert {"collective-permute", "all-reduce"} <= ops
    assert 0 < r["efficiency"]["no_overlap"] <= r["efficiency"]["overlapped"]
    band = r["dcn_sensitivity"]
    assert band["dcn_x0.5"] <= band["dcn_x1"] <= band["dcn_x2"]
    assert small["efficiency"]["no_overlap"] < r["efficiency"]["no_overlap"]
    assert r["link_gbs"]["kind"] == "NVIDIA H100 80GB HBM3"
    assert (r["link_gbs"]["ici_per_link"], r["link_gbs"]["dcn_per_host"]) \
        == (450.0, 400.0)
    assert r["mesh"] == {"hosts": 2, "chips_per_host": 2, "t_shards": 4}


def test_project_scaling_paths_matches_jax(worlds, jax_projections):
    paths = json.loads(str(_data(worlds, 4)["projection"]))["paths"]
    _, jpaths = jax_projections
    assert _keys(paths) == _keys(jpaths)
    for path, row in paths.items():
        assert 0 < row["efficiency"]["no_overlap"] <= 1, path
        band = row["dcn_sensitivity"]
        assert band["dcn_x0.5"] <= band["dcn_x1"] <= band["dcn_x2"], path
    a2a = [c for c in paths["fft4step"]["collectives"]
           if c["op"] == "all-to-all"]
    assert len(a2a) >= 3 and all(c["bytes"] > 0 for c in a2a)
    assert paths["stft"]["bytes"]["result_gather"] > 0
    assert paths["stft"]["per_chip_samples_per_s"] == \
        par.runtime.H100_CONFIG2_SAMPLES_PER_S


def test_project_scaling_needs_enough_ranks(worlds):
    raised = json.loads(str(_data(worlds, 2)["projection"]))["raised"]
    assert "needs 4 ranks" in raised


def test_interconnect_peaks():
    assert profiling.interconnect_peaks(
        "NVIDIA H100 80GB HBM3, 700.00 W") == (450.0, 400.0)
    assert profiling.interconnect_peaks("cpu") == (10.0, 10.0)
    with pytest.raises(ValueError, match="no link figures"):
        profiling.interconnect_peaks("TPU v5 lite")
    if not torch.cuda.is_available():       # a world without a card: H100
        assert profiling.interconnect_peaks() == (450.0, 400.0)


# --------------------------------------------------------------------------- #
# One rank in this process: the card's shape of the mesh
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = par.make_mesh(1, 1, device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("n", [7, 1000, 1002])
def test_bluestein_on_one_rank(one_rank_mesh, n):
    """With one rank ``d^2 | N`` always holds, so the public route never
    takes Bluestein there: the card drives it directly, as here."""
    rng = np.random.default_rng(n)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = pfft._bluestein_sharded(torch.as_tensor(z), one_rank_mesh)
    want = np.fft.fft(z)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-8 * np.abs(want).max())


def test_float32_runs_in_complex64(one_rank_mesh):
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    yr, yi = par.fft_sharded(x, one_rank_mesh)
    assert yr.dtype == torch.float32
    want = np.fft.fft(x.astype(np.float64))
    np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), want,
                               atol=2e-5 * np.abs(want).max())


def test_twiddles_from_exact_products():
    """The twiddle of the largest product ``k1*n2 < N`` at ``N = 2^24``,
    rounded once from float64, against the exact angle."""
    n, n1 = 1 << 24, 4096
    tw = pfft._twiddle(n, n1, n1, 0, torch.device("cpu"), torch.complex64)
    k = (n1 - 1) * (n1 - 1)
    want = np.exp(-2j * np.pi * k / n)
    assert abs(complex(tw[-1, -1]) - want) < 6e-8
