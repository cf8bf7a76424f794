"""Smoke test of pyfft_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyfft_tpu_torch/csrc`` with ``nvcc``,
holds each against its plain PyTorch version at the shapes of the main path,
then drives the main path (the fused FIR -> Welch cross-spectral chain) at
the size of bench configurations 0 and 5: 8 channels of 2**25 float32
samples at fs = 1 MHz with a 129-tap band-pass and nwins = 2048, and 8
channels of 2**24 samples with nwins = 4096 through ``fft_pwelch``.

Every phase prints one JSON line.  Then come the kernels' line
(``{"kernels": [...]}``, launches counted over the main-path phases only),
the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the exit code
is then non-zero and no ``ok`` line is printed.  There is no CPU fallback:
without a CUDA device the script exits with code 2.

Float32 convolutions and matmuls run in full float32 (both TF32 flags are
set to False), so the plain versions are float32 references computed by
cuDNN/cuFFT, on the same inputs as the kernels.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

FS = 1e6
NCH = 8
SEED = 0
FIR_TOL = 1e-5      # kernel A: max |kernel - plain| / max |plain|
WELCH_TOL = 2e-5    # kernel B: the same, per output


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, ref):
    """max |got - ref| / max |ref| in float64 (complex allowed)."""
    import torch
    got = torch.as_tensor(got).to(torch.complex128)
    ref = torch.as_tensor(ref).to(torch.complex128)
    scale = ref.abs().max().item()
    return (got.to(ref.device) - ref).abs().max().item() / scale, scale


def time_ms(fn, reps=5):
    """Median of `reps` timed runs after one warm-up, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def signals(nt, dev):
    """bench.py's signals: a 97 kHz sine plus 0.3 noise, and channels
    tile(x) + 0.1 noise, seeded with numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    t = (np.arange(nt) / FS).astype(np.float32)
    x = (np.sin(2 * np.pi * 97e3 * t)
         + 0.3 * rng.standard_normal(nt)).astype(np.float32)
    y = (np.tile(x, (NCH, 1))
         + 0.1 * rng.standard_normal((NCH, nt))).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def main():
    if not (HERE / "pyfft_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: pyfft_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import pyfft_tpu_torch as pt
    from pyfft_tpu_torch import segmentation as seg
    from pyfft_tpu_torch.ops import _build, fir, welch
    check(Path(pt.__file__).resolve().parent == HERE / "pyfft_tpu_torch",
          f"pyfft_tpu_torch imported from {pt.__file__}")
    check("jax" not in sys.modules and "pyfft_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    # ---- phase 1: device and build --------------------------------------- #
    t0 = time.perf_counter()
    _build.library()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         build_s=time.perf_counter() - t0, nvcc_s=_build.build_seconds())

    nt0 = 1 << 25
    x0, y0 = signals(nt0, dev)
    taps0 = pt.filters.firwin(129, [0.05, 0.45], pass_zero=False)
    kernels = {}

    # ---- phase 2: kernel A against its plain version --------------------- #
    sig9 = torch.cat([x0[None], y0])
    rng = np.random.default_rng(SEED + 1)
    long_taps = rng.standard_normal(1024) / 32
    # config-0 signals at 129 and 1024 taps, and config-5-sized ones
    for nt, K, taps in ((nt0, 129, taps0), (nt0, 1024, long_taps),
                        (nt0 // 2, 129, taps0)):
        sig = sig9[:, :nt].contiguous()
        got = fir.fir_cuda(sig, taps)
        ref = fir.fir_plain(sig, taps)
        err, scale = rel_err(got, ref)
        max_abs = err * scale
        del got, ref
        ms = time_ms(lambda: fir.fir_cuda(sig, taps))
        plain_ms = time_ms(lambda: fir.fir_plain(sig, taps))
        emit("fir_vs_plain", shape=list(sig.shape), K=K, rel_err=err,
             max_abs_err=max_abs, tol=FIR_TOL, ms=ms, plain_ms=plain_ms)
        check(err <= FIR_TOL, f"kernel A {list(sig.shape)} K={K}: rel err "
              f"{err} > {FIR_TOL}")
        if nt == nt0 and K == 129:
            kernels["fir"] = dict(max_abs_err=max_abs, ms=ms,
                                  plain_ms=plain_ms)
    del sig9, sig

    # ---- phase 3: kernel B against its plain version --------------------- #
    x5, y5 = x0[:nt0 // 2], y0[:, :nt0 // 2]
    for cfg, x, y, nwins, taps in ((0, x0, y0, 2048, taps0),
                                   (5, x5, y5, 4096, None)):
        nt = x.shape[0]
        plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
        win = np.hanning(nwins + 1)[:-1]
        s1 = seg.get_s1(win)
        norm = 1.0 / (s1 ** 2 * seg.get_enbw(FS, s1, seg.get_s2(win))
                      * plan.navr)
        kw = dict(navr=plan.navr, nwins=nwins, hop=plan.hop, taps=taps,
                  detrend_style=1)
        got = welch.welch_cuda(x, y, win, plan.nnyquist, norm, **kw)
        ref = welch.welch_plain(x, y, win, plan.nnyquist, norm, **kw)
        errs = {"Pxx": rel_err(got[0], ref[0]),
                "Pyy": rel_err(got[1], ref[1]),
                "Pxy": rel_err(torch.complex(got[2], got[3]),
                               torch.complex(ref[2], ref[3]))}
        del got, ref
        ms = time_ms(lambda: welch.welch_cuda(x, y, win, plan.nnyquist, norm,
                                              **kw))
        plain_ms = time_ms(lambda: welch.welch_plain(
            x, y, win, plan.nnyquist, norm, **kw))
        max_abs = max(e * s for e, s in errs.values())
        emit("welch_vs_plain", config=cfg, nch=NCH, nt=nt, nwins=nwins,
             navr=plan.navr, ntaps=0 if taps is None else len(taps),
             rel_err={k: e for k, (e, _) in errs.items()},
             max_abs_err=max_abs, tol=WELCH_TOL, ms=ms, plain_ms=plain_ms)
        for name, (e, _) in errs.items():
            check(e <= WELCH_TOL,
                  f"kernel B config {cfg} {name}: rel err {e} > {WELCH_TOL}")
        if cfg == 0:
            kernels["welch"] = dict(max_abs_err=max_abs, ms=ms,
                                    plain_ms=plain_ms)

    # ---- main path: counts from here on ---------------------------------- #
    fir.LAUNCHES = 0
    welch.LAUNCHES = 0

    # ---- phase 4: config 0 through welch_filtered_cross_spectra ---------- #
    nwins = 2048
    plan = seg.plan_segments(nt0, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1]
    t0 = time.perf_counter()
    out = pt.welch_filtered_cross_spectra(x0, y0, taps0, win, plan, FS)
    wall_fused = time.perf_counter() - t0
    check(welch.LAUNCHES == 1, f"fused chain launched kernel B "
          f"{welch.LAUNCHES} times")
    freq = out["freq"]
    ipk = np.argmax(np.abs(out["Pyy"]), axis=0)          # per channel
    df = FS / nwins
    fpk = freq[ipk]
    coh2 = (np.abs(out["Pxy"][ipk, np.arange(NCH)]) ** 2
            / (np.abs(out["Pxx"][ipk]) * np.abs(out["Pyy"][ipk, np.arange(NCH)])))
    check(np.all(np.isfinite(out["Pyy"])) and np.all(np.isfinite(out["Pxy"])),
          "non-finite spectra")
    check(np.all(np.abs(fpk - 97e3) <= df), f"Pyy peaks at {fpk}")
    check(np.all(coh2 > 0.9), f"|Cxy|^2 at the peak {coh2}")
    # the filter-first route (kernel A, then torch.fft) on the same tensors
    fir_before = fir.LAUNCHES
    t0 = time.perf_counter()
    ref = pt.welch_filtered_cross_spectra(x0, y0, taps0, win, plan, FS,
                                          fft_backend="xla")
    wall_unfused = time.perf_counter() - t0
    check(fir.LAUNCHES > fir_before, "filter-first route did not launch "
          "kernel A")
    errs4 = {k: rel_err(out[k], ref[k])[0] for k in ("Pxx", "Pyy", "Pxy")}
    emit("main_config0", nt=nt0, nch=NCH, nwins=nwins, navr=plan.navr,
         ntaps=len(taps0), peak_hz=fpk.tolist(), coh2_at_peak=coh2.tolist(),
         wall_s_fused=wall_fused, wall_s_filter_first=wall_unfused,
         rel_err_vs_filter_first=errs4, tol=WELCH_TOL)
    for k, e in errs4.items():
        check(e <= WELCH_TOL, f"config 0 {k}: fused vs filter-first {e}")
    del out, ref

    # ---- phase 5: config 5 through fft_pwelch ---------------------------- #
    nt5 = x5.shape[0]
    tvec = np.arange(nt5) / FS
    args = dict(tbounds=[tvec[1], tvec[-2]], tper=4096.5 / FS, plotit=False)
    before = welch.LAUNCHES
    t0 = time.perf_counter()
    f_p, Pxy_p, Pxx_p, Pyy_p, C_p, phi_p, info = pt.fft_pwelch(
        tvec, x5, y5, fft_backend="pallas", **args)
    wall_pallas = time.perf_counter() - t0
    check(welch.LAUNCHES == before + 1, "fft_pwelch('pallas') did not "
          "launch kernel B")
    check(info.nwins == 4096, f"nwins resolved to {info.nwins}")
    check("_lazy_segments" in info.__dict__, "per-segment fill not armed")
    t0 = time.perf_counter()
    f_x, Pxy_x, Pxx_x, Pyy_x, C_x, phi_x, info_x = pt.fft_pwelch(
        tvec, x5, y5, fft_backend="xla", **args)
    wall_xla = time.perf_counter() - t0
    check(np.array_equal(f_p, f_x), "freq differs between backends")
    errs5 = {"Pxx": rel_err(Pxx_p, Pxx_x)[0], "Pyy": rel_err(Pyy_p, Pyy_x)[0],
             "Pxy": rel_err(Pxy_p, Pxy_x)[0], "Cxy": rel_err(C_p, C_x)[0],
             "phi_xy": rel_err(phi_p, phi_x)[0]}
    seg_shape = info.Pxx_seg.shape              # fills lazily (xla core)
    check("_lazy_segments" not in info.__dict__, "lazy fill did not run")
    check(seg_shape == (info.Navr, info.Nnyquist), f"Pxx_seg {seg_shape}")
    errs5["Pxx_seg"] = rel_err(info.Pxx_seg, info_x.Pxx_seg)[0]
    emit("main_config5", nt=nt5, nch=NCH, nwins=info.nwins, navr=info.Navr,
         wall_s_pallas=wall_pallas, wall_s_xla=wall_xla,
         rel_err_vs_xla=errs5, tol=WELCH_TOL, Pxx_seg_shape=list(seg_shape))
    for k, e in errs5.items():
        check(e <= WELCH_TOL, f"config 5 {k}: pallas vs xla {e}")
    check(np.all(np.isfinite(Pxx_p)) and np.all(np.isfinite(C_p)),
          "non-finite fft_pwelch outputs")

    launches = {"fir": fir.LAUNCHES, "welch": welch.LAUNCHES}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    source = {"fir": ("pyfft_tpu_torch/csrc/fir.cu",
                      "pyfft_tpu/ops/pallas_fir.py:150"),
              "welch": ("pyfft_tpu_torch/csrc/welch.cu",
                        "pyfft_tpu/ops/pallas_welch3.py:455")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name][0],
         "replaces": source[name][1], "launches": launches[name],
         **kernels[name]} for name in ("fir", "welch")]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
