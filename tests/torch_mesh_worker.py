"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py
and tests/test_torch_parallel_fft.py.

    python tests/torch_mesh_worker.py RANK WORLD INIT_URL OUT.npz [SUITE]

Every rank runs every case of the suite's table at ``WORLD`` (SUITE
``welch``, the default: ``CASES``; ``fft``: ``FFT_CASES``) through the
mesh tier of ``pyfft_tpu_torch.parallel`` with the same global inputs,
made here from seeds with NumPy (the test files import this module for the
same inputs), and checks that its outputs equal rank 0's bit for bit; an
FFT function's blocks are joined over the ranks first, and each rank's
block must equal its slice of the join bit for bit.  Rank 0 writes the
outputs to ``OUT.npz`` under ``<case>/<output>``, with each rank's
collective audit and the runtime reports as JSON.  A failure prints its
traceback and exits with code 1.  Imports torch and the port only;
:func:`run_worlds` starts the worlds for the test files.
"""
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FS = 1e3
TIMEOUT_S = 60      # every collective of a world


def sigs(nt=4096, nch=4, seed=0):
    """tests/test_parallel.py's signals: a 97 Hz line, channel c lagging by
    0.5 rad at amplitude c + 1, 0.1 noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) / FS
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(nt)
    y = (np.sin(2 * np.pi * 97.0 * t - 0.5)[None, :]
         * (1.0 + np.arange(nch))[:, None]
         + 0.1 * rng.standard_normal((nch, nt)))
    return t, x, y


def iq_sigs(nt=4096, nch=2, seed=9):
    """Complex IQ signals (the Doppler configuration), as
    tests/test_parallel.py makes them."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) / FS
    z = (np.exp(1j * 2 * np.pi * 83.0 * t)
         + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    y = (np.exp(1j * (2 * np.pi * 83.0 * t - 0.4))[None, :]
         * (1.0 + np.arange(nch))[:, None]
         + 0.1 * (rng.standard_normal((nch, nt))
                  + 1j * rng.standard_normal((nch, nt))))
    return t, z, y


def welch_inputs(case):
    """``(x, y, win, plan)`` of a welch case."""
    from pyfft_tpu_torch import segmentation as seg
    make = iq_sigs if case.get("cplx") else sigs
    _, x, y = make(nt=case.get("nt", 4096))
    x = x + 0.25 * np.linspace(0, 3.0, x.shape[0])      # a trend
    nw = case.get("nwins")
    if nw:
        # segments over the start of the span only: the last ranks own none
        plan = seg.SegmentPlan(nsig=x.shape[0], nwins=nw, noverlap=nw // 2,
                               navr=case["navr"], nfft=nw,
                               nnyquist=nw // 2 + 1)
    else:
        plan = seg.plan_segments(x.shape[0], navr=case["navr"],
                                 windowoverlap=0.5)
    return x, y, np.hanning(plan.nwins + 1)[:-1], plan


def fir_inputs(case):
    from pyfft_tpu_torch import filters
    rng = np.random.default_rng(1)
    return (rng.standard_normal((case["nch"], case["nt"])),
            filters.firwin(case["ntaps"], 0.2))


def stft_inputs(case):
    """``(x, t, win, plan)``: a 100 Hz line with an offset and noise (IQ for
    complex cases)."""
    from pyfft_tpu_torch import segmentation as seg
    rng = np.random.default_rng(8)
    nt = case["nt"]
    t = np.arange(nt) / FS
    if case.get("cplx"):
        x = (np.exp(1j * 2 * np.pi * 83.0 * t)
             + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    else:
        x = (np.sin(2 * np.pi * 100 * t) + 0.3
             + 0.1 * rng.standard_normal(nt))
    plan = seg.plan_segments(nt, nwins=case["nwins"], windowoverlap=0.5)
    return x, t, np.hanning(case["nwins"] + 1)[:-1], plan


def specgram_inputs():
    rng = np.random.default_rng(6)
    t = np.arange(6000) / FS
    return t, np.sin(2 * np.pi * 120.0 * t) + 0.1 * rng.standard_normal(6000)


def pwelch_inputs(case):
    """``(t, x, y, kwargs)`` of an ``fft_pwelch`` case."""
    nt = case["nt"]
    if case.get("ntmodel"):
        rng = np.random.default_rng(5)
        t = np.arange(nt) / FS
        x = np.sin(2 * np.pi * 97.0 * t[:512])
        y = np.sin(2 * np.pi * 97.0 * t - 0.3) + 0.1 * rng.standard_normal(nt)
    else:
        t, x, y = (iq_sigs if case.get("cplx") else sigs)(nt=nt)
        if case.get("trend"):
            x = x + 0.25 * np.linspace(0, 3.0, nt)
    kw = dict(plotit=False, verbose=False)
    if "tb" in case:
        i0, i1 = case["tb"]
        kw["tbounds"] = [t[i0], t[i1]]
    for k in ("Navr", "detrend_style", "windowoverlap", "fft_backend"):
        if k in case:
            kw[k] = case[k]
    return t, x, y, kw


_W2 = {"welch_m1x2_d0": dict(kind="welch", mesh=(1, 2), detrend=0, navr=64),
       "welch_m1x2_d1": dict(kind="welch", mesh=(1, 2), detrend=1, navr=64),
       "welch_m1x2_dlin": dict(kind="welch", mesh=(1, 2), detrend=-1,
                               navr=64),
       "welch_m1x2_iq": dict(kind="welch", mesh=(1, 2), detrend=1, navr=48,
                             cplx=True, onesided=False),
       "welch_m1x2_odd": dict(kind="welch", mesh=(1, 2), detrend=1, navr=40,
                              nt=4999),
       "fir_m1x2": dict(kind="fir", mesh=(1, 2), nch=4, nt=4096, ntaps=101),
       "stft_m1x2": dict(kind="stft", mesh=(1, 2), nt=4096, nwins=256,
                         detrend=1),
       "pwelch_m1x2": dict(kind="pwelch", mesh=(1, 2), nt=5000, Navr=16),
       "pwelch_m1x2_pallas": dict(kind="pwelch", mesh=(1, 2), nt=4096,
                                  Navr=12, tb=(7, -9),
                                  fft_backend="pallas")}
_W4 = {}
for _m in ((1, 4), (2, 2), (4, 1)):
    _tag = f"m{_m[0]}x{_m[1]}"
    for _d, _dn in ((0, "d0"), (1, "d1"), (-1, "dlin")):
        _W4[f"welch_{_tag}_{_dn}"] = dict(kind="welch", mesh=_m, detrend=_d,
                                          navr=64)
    _W4[f"fir_{_tag}"] = dict(kind="fir", mesh=_m, nch=4, nt=4096,
                              ntaps=101)
_W4.update({
    "welch_m2x2_twosided": dict(kind="welch", mesh=(2, 2), detrend=1,
                                navr=48, onesided=False),
    "welch_m1x4_iq": dict(kind="welch", mesh=(1, 4), detrend=1, navr=48,
                          cplx=True, onesided=False),
    "welch_m2x2_iq": dict(kind="welch", mesh=(2, 2), detrend=0, navr=48,
                          cplx=True, onesided=False),
    "welch_m1x4_pallas": dict(kind="welch", mesh=(1, 4), detrend=1, navr=64,
                              backend="pallas"),
    "welch_m2x2_pallas_iq": dict(kind="welch", mesh=(2, 2), detrend=1,
                                 navr=48, cplx=True, onesided=False,
                                 backend="pallas"),
    "welch_m1x4_idle": dict(kind="welch", mesh=(1, 4), detrend=1, navr=5,
                            nwins=512),
    "welch_m1x4_idle_pallas": dict(kind="welch", mesh=(1, 4), detrend=-1,
                                   navr=5, nwins=512, backend="pallas"),
    "welch_m1x4_odd": dict(kind="welch", mesh=(1, 4), detrend=-1, navr=40,
                           nt=4999),
    "stft_m1x4": dict(kind="stft", mesh=(1, 4), nt=4096, nwins=256,
                      detrend=1),
    "stft_m2x2": dict(kind="stft", mesh=(2, 2), nt=4096, nwins=256,
                      detrend=0),
    "stft_m1x4_iq": dict(kind="stft", mesh=(1, 4), nt=4096, nwins=256,
                         detrend=1, cplx=True, onesided=False),
    "stft_m1x4_power": dict(kind="stft", mesh=(1, 4), nt=4096, nwins=256,
                            detrend=1, power=True),
    "stft_m1x4_odd_d1": dict(kind="stft", mesh=(1, 4), nt=4999, nwins=256,
                             detrend=1),
    "stft_m1x4_odd_dlin": dict(kind="stft", mesh=(1, 4), nt=4999,
                               nwins=256, detrend=-1),
    "stft_m1x4_pallas": dict(kind="stft", mesh=(1, 4), nt=4096, nwins=256,
                             detrend=1, backend="pallas"),
    "pwelch_m1x4": dict(kind="pwelch", mesh=(1, 4), nt=5000, Navr=16),
    "pwelch_m2x2_lin_subspan": dict(kind="pwelch", mesh=(2, 2), nt=4096,
                                    Navr=12, tb=(7, -9), detrend_style=-1,
                                    trend=True),
    "pwelch_m1x4_ntmodel": dict(kind="pwelch", mesh=(1, 4), nt=4096,
                                ntmodel=True, tb=(1, -2),
                                windowoverlap=0.5),
    "pwelch_m2x2_iq": dict(kind="pwelch", mesh=(2, 2), nt=5000, Navr=16,
                           cplx=True),
    "pwelch_m1x4_nondivisible": dict(kind="pwelch", mesh=(1, 4), nt=4996,
                                     Navr=16, tb=(3, -5)),
})
for _i, _kw in enumerate([{}, {"hanning": False}, {"overlap": False},
                          {"windowAverage": 3}]):
    _W4[f"specgram_m1x4_{_i}"] = dict(kind="specgram", mesh=(1, 4),
                                      kwargs=_kw)
CASES = {2: _W2, 4: _W4}


def fft_input(case):
    """The global input of an FFT case: complex ``(n,)`` or real ``(3,
    n)`` noise, or for envelope cases ``nch`` AM signals (as
    tests/test_parallel_fft.py makes them) in float32."""
    n = case["n"]
    rng = np.random.default_rng(n + 7 * case.get("nch", 0))
    if case["kind"] == "envelope":
        t = np.linspace(0, 6 * np.pi, n, endpoint=False)
        x = np.stack([(1 + 0.4 * np.sin(t)) * np.sin(60 * t),
                      (1 + 0.2 * np.sin(2 * t)) * np.sin(80 * t)])
        return x[:case["nch"]].squeeze().astype(np.float32)
    if case.get("cplx"):
        return rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return rng.standard_normal((3, n))


def _fft_world(d, four, blue, odd):
    """The FFT cases of a world whose widest ``'t'`` line has ``d`` ranks:
    ``four`` takes the four-step, ``blue`` Bluestein, ``odd`` does not
    divide by ``d``; every name ends in the mesh's tag."""
    m = (1, d)
    cases = {}
    for n in (four, blue):
        cases[f"fft_c_{n}"] = dict(kind="fft", mesh=m, n=n, cplx=True)
        cases[f"fft_r3_{n}"] = dict(kind="fft", mesh=m, n=n)
        cases[f"ifft_{n}"] = dict(kind="ifft", mesh=m, n=n, cplx=True)
        cases[f"rfft_{n}"] = dict(kind="rfft", mesh=m, n=n)
        cases[f"hilbert_{n}"] = dict(kind="hilbert", mesh=m, n=n)
    cases["envelope_1ch"] = dict(kind="envelope", mesh=m, n=4 * four, nch=1)
    cases["envelope_2ch"] = dict(kind="envelope", mesh=m, n=blue, nch=2)
    cases["axis_swap"] = dict(kind="axis_swap", mesh=m)
    cases["errors"] = dict(kind="errors", mesh=m, n=odd)
    cases["audit_four"] = dict(kind="audit", mesh=m, n=four)
    cases["audit_blue"] = dict(kind="audit", mesh=m, n=blue)
    return {f"{k}_m1x{d}": v for k, v in cases.items()}


_F4 = _fft_world(4, 1024, 1000, 1002)
_F4.update({"fft_c_1024_m2x2": dict(kind="fft", mesh=(2, 2), n=1024,
                                    cplx=True),
            "hilbert_1002_m2x2": dict(kind="hilbert", mesh=(2, 2),
                                      n=1002)})
FFT_CASES = {2: _fft_world(2, 1024, 1002, 1001), 4: _F4}
# the scaling projections: hosts x chips_per_host = the 4-rank world
PROJECTION = dict(nt=1 << 16, nch=4, nwins=1024, ntaps=33, hosts=2,
                  chips_per_host=2, per_chip_samples_per_s=1.0e10)
PROJECTION_SMALL = dict(PROJECTION, nt=1 << 13, nch=2, nwins=256)
PATHS = dict(nt=1 << 16, nch=2, nwins=1024, ntaps=33, hosts=2,
             chips_per_host=2, stft_nwins=512, fft_n=1 << 16)
SEGMENT_FIELDS = ("Pxx_seg", "Pyy_seg", "Pxy_seg", "Xfft_seg", "Yfft_seg")


def run_case(case, meshes):
    """The outputs of one case on this rank, as NumPy arrays."""
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import parallel as par
    if case["mesh"] not in meshes:
        meshes[case["mesh"]] = par.make_mesh(*case["mesh"])
    mesh = meshes[case["mesh"]]
    kind = case["kind"]
    if kind == "welch":
        x, y, win, plan = welch_inputs(case)
        f, Pxx, Pyy, Pxy = par.welch_psd_sharded(
            x, y, win, plan, FS, mesh, onesided=case.get("onesided", True),
            detrend_style=case["detrend"], fft_backend=case.get("backend"))
        return dict(freq=f, Pxx=Pxx, Pyy=Pyy, Pxy=Pxy)
    if kind == "fir":
        x, taps = fir_inputs(case)
        return dict(y=par.fir_filter_sharded(x, taps, mesh))
    if kind == "stft":
        x, t, win, plan = stft_inputs(case)
        tt, f, X = par.stft_sharded(
            x, t, win, plan, FS, mesh, onesided=case.get("onesided", True),
            detrend_style=case["detrend"], fft_backend=case.get("backend"),
            power=case.get("power", False))
        return dict(tt=tt, freq=f, X=X)
    if kind == "specgram":
        t, s = specgram_inputs()
        tm, f, P = par.specgram_sharded(t, s, mesh, wl=256, **case["kwargs"])
        return dict(time=tm, fAxis=f, P=P)
    t, x, y, kw = pwelch_inputs(case)
    f, Pxy, Pxx, Pyy, _, phi, info = pt.fft_pwelch(t, x, y, mesh=mesh, **kw)
    out = dict(freq=f, Pxy=Pxy, Pxx=Pxx, Pyy=Pyy, phi=phi,
               lazy=np.asarray("Pxx_seg" not in info.__dict__))
    out.update({k: np.asarray(getattr(info, k)) for k in SEGMENT_FIELDS})
    return out


def _joined(z, mesh):
    """The whole output axis from every rank's block ``z`` (a tensor):
    the blocks of the ranks at ``'ch'`` 0 in ``'t'`` order, checked
    against every rank's own block bit for bit."""
    import torch.distributed as dist
    z = z.numpy()
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (mesh.get_coordinate(), z))
    row = sorted((c[1], b) for c, b in got if c[0] == 0)
    full = np.concatenate([b for _, b in row], axis=-1)
    nb = z.shape[-1]
    for c, b in got:
        if not np.array_equal(b, full[..., c[1] * nb:(c[1] + 1) * nb]):
            raise AssertionError(f"the block of mesh coordinate {c} is not "
                                 "its slice of the joined result")
    return full


def _raises(fn, *args, **kw):
    """The message of the ``ValueError`` ``fn`` raises ('' if none)."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return ""


def run_fft_case(case, meshes):
    """The outputs of one FFT case on this rank, as NumPy arrays."""
    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import parallel as par
    if case["mesh"] not in meshes:
        meshes[case["mesh"]] = par.make_mesh(*case["mesh"])
    mesh = meshes[case["mesh"]]
    kind = case["kind"]
    if kind == "axis_swap":
        x = np.random.default_rng(3).standard_normal((16, 24)).astype(
            np.float32)
        y = par.axis_swap(x, mesh, "t", sharded_axis=0, target_axis=1)
        return dict(y=_joined(y, mesh), shape=np.asarray(y.shape))
    if kind == "errors":
        rng = np.random.default_rng(4)
        x = rng.standard_normal(case["n"])
        env = pt.hilbert_mod.envelope_phase
        return dict(
            fft=np.asarray(_raises(par.fft_sharded, x, mesh)),
            hilbert=np.asarray(_raises(par.hilbert_sharded, x, mesh)),
            axis_swap=np.asarray(_raises(par.axis_swap,
                                         rng.standard_normal((16, 7)), mesh,
                                         "t", 0, 1)),
            envelope_axis=np.asarray(_raises(env, np.ones((4, 64)), axes=0,
                                             mesh=mesh)))
    if kind == "audit":
        import torch.distributed as dist
        x = np.random.default_rng(5).standard_normal(case["n"])
        rows = par.audit_collectives(par.fft_sharded, x, mesh)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, rows)
        return dict(rows=np.asarray(json.dumps(got)))
    x = fft_input(case)
    if kind == "envelope":
        env, ph = pt.hilbert_mod.envelope_phase(x, mesh=mesh)
        return dict(env=env, ph=ph)
    if kind == "rfft":
        n = case["n"]
        re, im = par.rfft_sharded(x, mesh)
        return dict(re=re, im=im, back=par.irfft_sharded(re, im, n, mesh),
                    short=par.irfft_sharded(re[..., :n // 4],
                                            im[..., :n // 4], n, mesh))
    if kind == "hilbert":
        zr, zi = par.hilbert_sharded(x, mesh)
        return dict(z=_joined(zr + 1j * zi, mesh))
    yr, yi = par.fft_sharded(x, mesh)
    out = dict(X=_joined(yr + 1j * yi, mesh))
    if kind == "ifft":
        br, bi = par.ifft_sharded(out["X"], mesh)
        out["back"] = _joined(br + 1j * bi, mesh)
    return out


def main_fft(rank, world, out_path):
    """The ``fft`` suite: every case of ``FFT_CASES[world]`` (the audit
    cases gather each rank's collectives of a transform), then the scaling
    projections (in the 4-rank world; the 2-rank world is too small for
    them and must raise)."""
    import torch.distributed as dist
    from pyfft_tpu_torch import parallel as par
    meshes, results = {}, {}
    for name, case in FFT_CASES[world].items():
        outs = run_fft_case(case, meshes)
        box = [outs]
        dist.broadcast_object_list(box, src=0)
        for k, v in outs.items():
            if not np.array_equal(v, box[0][k],
                                  equal_nan=v.dtype.kind in "fc"):
                raise AssertionError(f"rank {rank}: {name}/{k} differs from "
                                     "rank 0's")
            results[f"{name}/{k}"] = v
    proj = {}
    if world >= PROJECTION["hosts"] * PROJECTION["chips_per_host"]:
        proj["chain"] = par.project_scaling(**PROJECTION)
        proj["small"] = par.project_scaling(**PROJECTION_SMALL)
        proj["paths"] = par.project_scaling_paths(**PATHS)
    else:
        try:
            par.project_scaling(**PROJECTION)
            proj["raised"] = ""
        except RuntimeError as e:
            proj["raised"] = str(e)
    if rank == 0:
        np.savez(out_path, **results, projection=json.dumps(proj))


def run_worlds(suite, tmp_path_factory, timeout):
    """Start a world of gloo processes for each world size of the suite's
    table, all at once; returns ``{world: (return codes, logs, outputs)}``
    once they end.  A world still running ``timeout`` seconds after the
    start is killed."""
    table = FFT_CASES if suite == "fft" else CASES
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = {}
    for w in table:
        tmp = tmp_path_factory.mktemp(f"{suite}{w}")
        procs[w] = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(w), f"file://{tmp}/store",
             str(tmp / "out.npz"), suite], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=str(tmp))
            for r in range(w)]
    deadline = time.monotonic() + timeout
    out = {}
    for w, ps in procs.items():
        rcs, logs = [], []
        for p in ps:
            try:
                log, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                log, _ = p.communicate()
            rcs.append(p.returncode)
            logs.append(log.decode(errors="replace"))
        path = Path(ps[0].args[5])
        data = dict(np.load(path)) if path.exists() else {}
        out[w] = (rcs, logs, data)
    return out


def main(rank, world, url, out_path, suite="welch"):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from pyfft_tpu_torch import parallel as par
    from pyfft_tpu_torch.config import set_default_device
    set_default_device("cpu")
    par.init_distributed(url, world, rank, timeout=TIMEOUT_S)
    if suite == "fft":
        main_fft(rank, world, out_path)
        dist.barrier()
        dist.destroy_process_group()
        return
    meshes, results = {}, {}
    for name, case in CASES[world].items():
        outs = run_case(case, meshes)
        box = [outs]
        dist.broadcast_object_list(box, src=0)
        for k, v in outs.items():
            if not np.array_equal(v, box[0][k], equal_nan=True):
                raise AssertionError(f"rank {rank}: {name}/{k} differs from "
                                     "rank 0's")
            results[f"{name}/{k}"] = v
    # rank-local: each rank's collectives in the widest time split
    tsh = max(m[1] for m in meshes)
    mesh = meshes[(1, tsh)]
    x, y, win, plan = welch_inputs(dict(navr=64))
    rows = par.audit_collectives(par.welch_psd_sharded, x, y, win, plan, FS,
                                 mesh, detrend_style=1)
    audits = [None] * world
    dist.all_gather_object(audits, rows)
    report = par.scaling_report(mesh)
    scaling = par.measure_scaling(nt=1 << 14, nch=2, nwins=256, iters=1)
    host = par.make_host_mesh(ch=2)
    host_info = dict(names=list(host.mesh_dim_names),
                     shape=list(host.shape))
    try:
        par.make_host_mesh(ch=3, t=world)
        host_info["raised"] = False
    except ValueError:
        host_info["raised"] = True
    if rank == 0:
        np.savez(out_path, **results, audit=json.dumps(audits),
                 report=json.dumps(report), scaling=json.dumps(scaling),
                 host=json.dumps(host_info),
                 plan=json.dumps([plan.nwins, plan.hop, plan.navr]))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
             *sys.argv[5:])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
