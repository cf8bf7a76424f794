"""Build and load the hand-written CUDA kernels (``pyfft_tpu_torch/csrc``).

The sources have a plain C interface.  On first use :func:`library`
compiles every ``csrc/*.cu`` at once, one ``nvcc`` process per source,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <name>.o csrc/<name>.cu

then links the objects with ``nvcc -shared -o libpyfft_kernels.so``, into
``pyfft_tpu_torch/_build/<hash>/``, where ``<hash>`` covers the sources
and the flags, and loads the result with :mod:`ctypes`.  The compilers'
output (with ptxas' register and shared-memory report) is kept beside the
library as ``build.log``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "build", "build_seconds", "check"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libpyfft_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
# C signatures of the entries in csrc/*.cu
_SIGNATURES = {
    "pyfft_error_string": ([_I], ctypes.c_char_p),
    "pyfft_fir": ([_P, _P, _P, _LL, _LL, _I, _P], _I),
    "pyfft_fir_t": ([_P, _P, _LL, _I, _P, _I, _P, _P, _LL, _LL, _P], _I),
    "pyfft_welch": ([_P, _P, _LL, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _D, _P], _I),
    "pyfft_welch_resident": ([_I, _I], _I),
    "pyfft_welch_pair": ([_P, _P, _P, _LL, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _I, _D, _P], _I),
    "pyfft_welch_pair_resident": ([_I, _I], _I),
    "pyfft_welch_means": ([_P, _P, _LL, _P, _P, _LL, _P, _I, _I, _I, _P, _P],
                          _I),
    "pyfft_stft": ([_P, _P, _LL, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                    ctypes.c_float, _P], _I),
    "pyfft_hilbert": ([_P, _P, _P, _I, _I, _P], _I),
    "pyfft_hilbert_blocks_per_sm": ([_I], _I),
    "pyfft_welch_dft": ([_P, _P, _LL, _P, _P, _D, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D,
                         _P], _I),
    "pyfft_welch_dft_blocks_per_sm": ([_I], _I),
    "pyfft_colsum": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "pyfft_chain": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
}

_lib = None
_build_seconds = None


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of pyfft_tpu_torch are built from source at first use")


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path."""
    global _build_seconds
    out_dir = BUILD_DIR / _key()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        tmp = out_dir / f".{LIB_NAME}.{tag}"
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    _build_seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def build_seconds():
    """Seconds the last compile in this process took (None: cached)."""
    return _build_seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = library().pyfft_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
