"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/torch_mesh_worker.py RANK WORLD INIT_URL OUT.npz

Every rank runs every case of ``CASES[WORLD]`` through the mesh tier of
``pyfft_tpu_torch.parallel`` with the same global inputs, made here from
seeds with NumPy (the test file imports this module for the same inputs),
and checks that its outputs equal rank 0's bit for bit.  Rank 0 writes
them to ``OUT.npz`` under ``<case>/<output>``, with each rank's collective
audit and the runtime reports as JSON.  A failure prints its traceback and
exits with code 1.  Imports torch and the port only.
"""
import json
import os
import sys
import traceback

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


def main(rank, world, url, out_path):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from pyfft_tpu_torch import parallel as par
    from pyfft_tpu_torch.config import set_default_device
    set_default_device("cpu")
    par.init_distributed(url, world, rank, timeout=TIMEOUT_S)
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
        main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
