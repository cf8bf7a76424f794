"""Top-level entry points: the flagship forward step and the whole mesh dry run.

Counterpart of the JAX package's root ``__graft_entry__.py``.

- :func:`entry` returns the forward step of the flagship Welch pipeline
  (frames -> window -> transform -> cross-powers summed over segments) on
  the port's kernel route, and its example inputs.
- :func:`dryrun_multichip` runs every part of the mesh tier
  (:mod:`pyfft_tpu_torch.parallel`) in one world of ``n_devices`` ranks on
  the JAX function's shapes: the sharded FIR, the sharded Welch with mean
  and linear detrend, ``fft_pwelch(mesh=...)`` on reflect-extended input
  with the lazy per-segment fill, an odd segment length, the sharded STFT,
  the complex two-sided Welch of IQ signals, and from two ranks on the
  four-step FFT, Bluestein and the analytic signal.  Each stage is held
  against the single-device pipeline (the FFTs against NumPy) and raises
  ``AssertionError`` naming the stage where it disagrees.

The mesh calls take ``fft_backend='pallas'``: on the card that is kernel A
(FIR), kernel B (Welch at power-of-two segment lengths, real and complex
signals), kernel C (STFT) and kernel E (Welch at any other length); on the
CPU their plain versions.  The single-device references take the default
``torch.fft`` route, so every stage holds a kernel against an independent
transform.  The JAX function's mesh is a virtual CPU platform; here the
world is a process group (one process a device), found or started as
:func:`dryrun_multichip` says.

Rank mode, which :func:`dryrun_multichip` starts once a rank::

    python -m pyfft_tpu_torch.entry --rank R --world N --init URL \
        --device {cpu,cuda} [--timeout SECONDS]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import segmentation as seg
from .config import _np, default_device, resolve_device

__all__ = ["entry", "dryrun_multichip"]

_OK = "dryrun_multichip OK:"


def flagship_geometry():
    """``(plan, win, s1sq_enbw)`` of :func:`entry`: 2**15 samples in
    segments of 1024 at 50% overlap, the periodic Hann window in float32,
    and ``S1^2 * ENBW`` at fs = 1 MHz."""
    plan = seg.plan_segments(1 << 15, nwins=1024, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1].astype(np.float32)
    s1 = seg.get_s1(win)
    enbw = seg.get_enbw(1e6, s1, seg.get_s2(win))
    return plan, win, np.float32(s1 ** 2 * enbw)


def entry(device=None):
    """The flagship forward step and its example inputs: ``(forward, (x,
    y))``.

    ``x (2**15,)`` and ``y (4, 2**15)`` are float32 tensors on ``device``
    (:func:`~pyfft_tpu_torch.config.resolve_device`: the card unless the
    CPU is asked for), drawn from ``default_rng(0)`` as the JAX ``entry``
    draws them.  ``forward(x, y)`` returns ``(Pxx (nfreq,), Pyy (nfreq,
    nch), Pxy_re, Pxy_im)``, tensors on the inputs' device: the kernel
    route of :func:`~pyfft_tpu_torch.spectral.pallas_route` (kernel B at
    this geometry, its plain version on CPU tensors) with mean detrend and
    the one-sided scaling.  It raises where no kernel's gate holds, and
    never takes the ``torch.fft`` core instead.
    """
    from .spectral import _welch_core_pallas
    dev = resolve_device(device)
    plan, win, norm = flagship_geometry()
    static = dict(navr=plan.navr, nwins=plan.nwins, noverlap=plan.noverlap,
                  nfft=plan.nfft, nnyquist=plan.nnyquist, onesided=True,
                  detrend_style=1, ntmodel=False)

    def forward(x, y):
        """x: (nt,) reference signal; y: (nch, nt) channels -> spectra."""
        P = _welch_core_pallas(x, y, win, norm, **static)
        if P is None:
            raise RuntimeError(
                f"entry: no kernel takes nwins={plan.nwins} "
                f"navr={plan.navr} nch={y.shape[0]} for these inputs")
        return P[0, 0], P[1:, 0].T, P[1:, 1].T, P[1:, 2].T

    rng = np.random.default_rng(0)
    x = rng.standard_normal(plan.nsig).astype(np.float32)
    y = rng.standard_normal((4, plan.nsig)).astype(np.float32)
    return forward, (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


# --------------------------------------------------------------------------- #
# The dry run's stages (every rank of the world runs them)
# --------------------------------------------------------------------------- #

def _expect(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _stages(n_devices, dev):
    """Every stage of the dry run on this rank of an ``n_devices`` world;
    returns the OK line (rank 0 prints it)."""
    from . import filters as flt
    from . import parallel as par
    from .fftanal import stft_segments
    from .hilbert import hilbert
    from .parallel.mesh import coordinate
    from .spectral import fft_pwelch, welch_cross_spectra

    kern = dict(fft_backend="pallas")
    ch = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    tsh = n_devices // ch
    mesh = par.make_mesh(ch=ch, t=tsh, device=dev)

    # the JAX function's shapes: many segments a time shard, real halos
    nch = 2 * ch
    nt = 4096 * tsh
    fs = 1e3
    rng = np.random.default_rng(1)
    t = np.arange(nt) / fs
    x = (np.sin(2 * np.pi * 97.0 * t)
         + 0.1 * rng.standard_normal(nt)).astype(np.float64)
    y = (np.sin(2 * np.pi * 97.0 * t - 0.5)[None]
         * (1.0 + np.arange(nch))[:, None]
         + 0.1 * rng.standard_normal((nch, nt)))
    checks = []

    # ---- stage 1: sharded causal FIR (halo = ntaps - 1) ------------------ #
    taps = flt.firwin(33, 0.4)
    y_f = par.fir_filter_sharded(y, taps, mesh)
    x_f = par.fir_filter_sharded(np.broadcast_to(x, (ch, nt)).copy(),
                                 taps, mesh)[0]
    ref_f = flt.fir_filter(y[:1], taps)
    _expect(np.allclose(y_f[0], ref_f[0], rtol=1e-4, atol=1e-5),
            "stage 1: sharded FIR diverged from the single-device filter")
    checks.append("fir")

    # ---- stage 2: sharded Welch, mean and linear detrend ----------------- #
    plan = seg.plan_segments(nt, nwins=256, windowoverlap=0.5)
    win = np.hanning(plan.nwins + 1)[:-1]
    for det in (1, -1):
        _, Pxx, _, Pxy = par.welch_psd_sharded(
            x_f, y_f, win, plan, fs=fs, mesh=mesh, onesided=True,
            detrend_style=det, **kern)
        ref = welch_cross_spectra(x_f, y_f, win, plan, fs, onesided=True,
                                  detrend_style=det)
        sc = np.abs(ref["Pxx"]).max()
        _expect(np.allclose(Pxx, ref["Pxx"].real, rtol=1e-4, atol=1e-5 * sc),
                f"stage 2: sharded Pxx != single-device (detrend={det})")
        _expect(np.allclose(Pxy.T, ref["Pxy"], rtol=1e-4, atol=1e-5 * sc),
                f"stage 2: sharded Pxy != single-device (detrend={det})")
    checks.append("welch(det=1,-1)")

    # ---- stage 3: fft_pwelch(mesh=...) on reflect-extended input --------- #
    r_mesh = fft_pwelch(t, x, y, Navr=16, plotit=False, verbose=False,
                        mesh=mesh, **kern)
    r_one = fft_pwelch(t, x, y, Navr=16, plotit=False, verbose=False)
    _expect(np.allclose(r_mesh[2], r_one[2], rtol=1e-4,
                        atol=1e-5 * np.abs(r_one[2]).max()),
            "stage 3: fft_pwelch(mesh=...) != fft_pwelch() on "
            "reflect-extended input")
    checks.append("reflect-api")
    # the per-segment arrays stay lazy until read; the read fills them
    # where the samples live (the sharded raw STFT, a collective)
    info_m, info_1 = r_mesh[6], r_one[6]
    _expect("Xfft_seg" not in info_m.__dict__,
            "stage 3: the mesh path filled Xfft_seg before it was read")
    sxf = np.abs(info_1.Xfft_seg).max()
    _expect(np.allclose(info_m.Xfft_seg, info_1.Xfft_seg, atol=1e-5 * sxf),
            "stage 3: mesh-path Xfft_seg != single-device")
    _expect(np.allclose(info_m.Pxy_seg, info_1.Pxy_seg,
                        atol=1e-5 * np.abs(info_1.Pxy_seg).max()),
            "stage 3: mesh-path Pxy_seg != single-device")
    checks.append("sharded-segfill")

    # ---- stage 4: an odd segment length (kernel E's route) --------------- #
    plan_odd = seg.plan_segments(nt, nwins=250, windowoverlap=0.5)
    win_odd = np.hanning(plan_odd.nwins + 1)[:-1]
    _, Pxx_o, _, _ = par.welch_psd_sharded(x, y, win_odd, plan_odd, fs=fs,
                                           mesh=mesh, **kern)
    ref_o = welch_cross_spectra(x, y, win_odd, plan_odd, fs)
    _expect(np.allclose(Pxx_o, ref_o["Pxx"].real, rtol=1e-4,
                        atol=1e-5 * np.abs(ref_o["Pxx"]).max()),
            "stage 4: sharded Pxx at odd nwins != single-device")
    checks.append("odd-nwins")

    # ---- stage 4b: sharded STFT against stft_segments -------------------- #
    tt_s, _, X_s = par.stft_sharded(x, t, win, plan, fs, mesh, **kern)
    tt_1, _, X_1, _ = stft_segments(x, t, win, plan, fs, fft_backend="mxu")
    _expect(np.allclose(tt_s, tt_1, rtol=1e-6, atol=1e-9),
            "stage 4b: sharded STFT segment times != stft_segments")
    _expect(np.allclose(X_s, X_1, rtol=1e-4, atol=1e-5 * np.abs(X_1).max()),
            "stage 4b: sharded STFT != single-device stft_segments")
    checks.append("stft")

    # ---- stage 4c: complex two-sided Welch, the Doppler IQ configuration - #
    zc = (np.exp(1j * 2 * np.pi * 83.0 * t)
          + 0.1 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    yc = (np.exp(1j * (2 * np.pi * 83.0 * t - 0.4))[None]
          * (1.0 + np.arange(nch))[:, None]
          + 0.1 * (rng.standard_normal((nch, nt))
                   + 1j * rng.standard_normal((nch, nt))))
    _, Pxx_c, _, Pxy_c = par.welch_psd_sharded(
        zc, yc, win, plan, fs=fs, mesh=mesh, onesided=False,
        detrend_style=1, **kern)
    ref_c = welch_cross_spectra(zc, yc, win, plan, fs, onesided=False,
                                detrend_style=1)
    scc = np.abs(ref_c["Pxx"]).max()
    _expect(np.allclose(Pxx_c, ref_c["Pxx"].real, rtol=1e-4,
                        atol=1e-5 * scc),
            "stage 4c: sharded complex two-sided Pxx != single-device")
    _expect(np.allclose(Pxy_c.T, ref_c["Pxy"], rtol=1e-4, atol=1e-5 * scc),
            "stage 4c: sharded complex two-sided Pxy != single-device")
    r_iq = fft_pwelch(t, zc, yc, Navr=16, plotit=False, verbose=False,
                      mesh=mesh, **kern)
    r_iq1 = fft_pwelch(t, zc, yc, Navr=16, plotit=False, verbose=False)
    _expect(np.allclose(r_iq[1], r_iq1[1], rtol=1e-4,
                        atol=1e-5 * np.abs(r_iq1[1]).max()),
            "stage 4c: fft_pwelch(mesh=...) complex IQ != single-device")
    checks.append("complex-iq")

    # ---- stage 5: distributed FFTs over every rank ----------------------- #
    # each rank holds its block of the output axis and compares it with its
    # slice of the whole reference
    if n_devices >= 2:
        fmesh = par.make_mesh(ch=1, t=n_devices, device=dev)
        r = coordinate(fmesh, "t")

        def mine(ref):
            b = ref.shape[-1] // n_devices
            return ref[r * b:(r + 1) * b]

        def joined(re_im):
            return _np(re_im[0]) + 1j * _np(re_im[1])

        nfft = 64 * n_devices * n_devices
        sig = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
        ref_fft = np.fft.fft(sig)
        _expect(np.allclose(joined(par.fft_sharded(sig, fmesh)),
                            mine(ref_fft), rtol=1e-4,
                            atol=1e-5 * np.abs(ref_fft).max()),
                "stage 5: four-step distributed FFT != numpy")
        checks.append("fft4step")
        n_blue = n_devices * 100          # d | n but d^2 does not
        if n_blue % (n_devices * n_devices):
            sigb = rng.standard_normal(n_blue)
            refb = np.fft.fft(sigb)
            _expect(np.allclose(joined(par.fft_sharded(sigb, fmesh)),
                                mine(refb), rtol=1e-4,
                                atol=1e-5 * np.abs(refb).max()),
                    "stage 5: distributed Bluestein FFT != numpy")
            checks.append("bluestein")
        xh = rng.standard_normal(nfft)
        zh = hilbert(xh)
        _expect(np.allclose(joined(par.hilbert_sharded(xh, fmesh)), mine(zh),
                            atol=1e-5 * np.abs(zh).max()),
                "stage 5: distributed Hilbert != single-device")
        checks.append("hilbert")

    line = (f"{_OK} mesh=({ch}x{tsh}), nch={nch}, nt={nt}, "
            f"navr={plan.navr}, nfreq={plan.nnyquist}, "
            f"checks={'/'.join(checks)}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


# --------------------------------------------------------------------------- #
# Finding or starting the world
# --------------------------------------------------------------------------- #

def dryrun_multichip(n_devices: int, device=None, *, timeout=900.0,
                     collective_timeout=120.0):
    """The whole mesh tier over an ``n_devices`` world, checked against the
    single-device pipeline; returns the OK line, which rank 0 prints.

    ``device`` (:func:`~pyfft_tpu_torch.config.resolve_device`: the card
    unless the CPU is asked for) decides the backend: NCCL on the card, one
    rank a card, gloo on the CPU.  The world is found or started so:

    - a default process group exists: its world size must be
      ``n_devices``, and every rank calls this (as a launcher, or a script
      that started the group, runs it);
    - no group and ``n_devices == 1``: a one-rank group is started here,
      run in this process and destroyed after;
    - no group and ``n_devices > 1``: ``n_devices`` rank processes are
      started (``python -m pyfft_tpu_torch.entry``) on a ``file://`` store,
      each with ``collective_timeout`` seconds a collective; the call raises
      with a rank's last output where it exits non-zero, or where the world
      is still running after ``timeout`` seconds.

    Without a group, the card takes a world of at most as many ranks as it
    has cards (NCCL puts one rank on a card): a larger one raises; ask for
    ``device="cpu"`` to run it over gloo.

    A stage that disagrees raises ``AssertionError`` naming the stage.  The
    OK line keeps the JAX format and lists only the checks that ran: the
    FFT checks need two ranks, Bluestein a world whose size squared does
    not divide ``100 * n_devices``.
    """
    dev = resolve_device(device)
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"dryrun_multichip needs n_devices >= 1, got {n}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != n:
            raise RuntimeError(
                f"dryrun_multichip({n}) in a process group of {world} "
                f"ranks: the world size must equal n_devices")
        with default_device(dev):
            return _stages(n, dev)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n}) on the card needs {n} CUDA devices, "
            f"this host has {torch.cuda.device_count()} (NCCL takes one rank "
            f'a card); pass device="cpu" to run the world over gloo')
    if n == 1:
        from .parallel import init_distributed
        init_distributed(device=dev, timeout=collective_timeout)
        try:
            with default_device(dev):
                return _stages(1, dev)
        finally:
            dist.destroy_process_group()
    line = _run_world(n, dev.type, timeout, collective_timeout)
    print(line, flush=True)
    return line


def _tail(path, lines=40):
    text = Path(path).read_text(errors="replace").splitlines()
    return "\n".join(text[-lines:])


def _run_world(n, device_type, timeout, collective_timeout):
    """Start ``n`` rank processes, wait for them; returns rank 0's OK
    line."""
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    if device_type == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    tmp = Path(tempfile.mkdtemp(prefix="pyfft_dryrun_"))
    procs, logs = [], []
    try:
        for r in range(n):
            logs.append(tmp / f"rank{r}.log")
            with open(logs[-1], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pyfft_tpu_torch.entry",
                     "--rank", str(r), "--world", str(n),
                     "--init", f"file://{tmp}/store",
                     "--device", device_type,
                     "--timeout", str(collective_timeout)],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=str(tmp)))
        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(
                    f"dryrun_multichip({n}): rank {r} exited with code "
                    f"{rcs[r]}; its last output:\n{_tail(logs[r])}")
            if all(rc == 0 for rc in rcs):
                break
            if time.monotonic() > deadline:
                hung = [r for r, rc in enumerate(rcs) if rc is None]
                raise RuntimeError(
                    f"dryrun_multichip({n}): ranks {hung} still running "
                    f"after {timeout} s; rank {hung[0]}'s last output:\n"
                    f"{_tail(logs[hung[0]])}")
            time.sleep(0.05)
        ok = [s for s in logs[0].read_text().splitlines()
              if s.startswith(_OK)]
        if not ok:
            raise RuntimeError(f"dryrun_multichip({n}): rank 0 printed no "
                               f"OK line:\n{_tail(logs[0])}")
        return ok[-1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(argv=None):
    ap = argparse.ArgumentParser(description="One rank of dryrun_multichip.")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True, help="init_method URL")
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective")
    a = ap.parse_args(argv)
    from .parallel import init_distributed
    dev = torch.device(a.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(a.init, a.world, a.rank, device=dev, timeout=a.timeout)
    with default_device(dev):
        _stages(a.world, dev)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
