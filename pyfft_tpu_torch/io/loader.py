"""Streaming shot-file loader: ctypes binding over the port's C++ reader.

Counterpart of :mod:`pyfft_tpu.io.loader`.  The compute pipelines consume
``(nch, block)`` float32 blocks; raw DAQ captures are interleaved channel
frames on disk.  ``pyfft_tpu_torch/csrc/shotloader.cpp`` memory-maps the
file and deinterleaves/converts/decimates in one pass; this module
compiles it with ``g++`` at first use into
``pyfft_tpu_torch/_build/shotloader-<hash>/`` (``<hash>`` covers the
source and the flags) and binds it with ctypes.  A machine without a
toolchain reads with an equivalent NumPy implementation: the same
blocks, one extra copy; :attr:`ShotLoader.native` says which reader runs.

:func:`stream_welch` feeds a whole file to
:class:`~pyfft_tpu_torch.streaming.StreamingWelch` on the compute device.
On a card each block is read straight into one of two pinned host
buffers and copied to the card asynchronously; a buffer is written again
only after its copy has completed (a CUDA event per buffer).

>>> ld = ShotLoader("shot.bin", nch=8, dtype="int16")
>>> for block in ld.stream(block=1 << 16, decim=4):
...     sw.push(block[0], block)            # feed StreamingWelch
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["ShotLoader", "stream_welch", "native_available"]

_DTYPES = {"int16": (0, np.int16), "float32": (1, np.float32),
           "float64": (2, np.float64)}

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "shotloader.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_err = None


def library_path() -> Path:
    """Where the C++ reader is built: a directory per source and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _PKG / "_build" / f"shotloader-{h.hexdigest()[:16]}" \
        / "libshotloader.so"


def _build(so: Path):
    """Compile the reader into ``so`` (to a temporary name first, so a
    concurrent process never loads a half-written library)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, so)


def _load_native():
    """Compile (once per source) and dlopen the native library; None on
    failure."""
    global _lib, _build_err
    with _lib_lock:
        if _lib is not None or _build_err is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.shotloader_open.restype = ctypes.c_void_p
            lib.shotloader_open.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                            ctypes.c_int, ctypes.c_long]
            lib.shotloader_nsamples.restype = ctypes.c_long
            lib.shotloader_nsamples.argtypes = [ctypes.c_void_p]
            lib.shotloader_read.restype = ctypes.c_long
            lib.shotloader_read.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                            ctypes.c_long, ctypes.c_long,
                                            ctypes.POINTER(ctypes.c_float)]
            lib.shotloader_close.restype = None
            lib.shotloader_close.argtypes = [ctypes.c_void_p]
            lib.shotloader_prefetch_start.restype = ctypes.c_void_p
            lib.shotloader_prefetch_start.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_long, ctypes.c_long, ctypes.c_int]
            lib.shotloader_prefetch_next.restype = ctypes.c_long
            lib.shotloader_prefetch_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.shotloader_prefetch_close.restype = None
            lib.shotloader_prefetch_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            _build_err = e                 # no toolchain: the NumPy reader
        return _lib


def native_available():
    """Whether the C++ loader compiled and loaded on this machine."""
    return _load_native() is not None


class ShotLoader:
    """Reader over an interleaved-frame binary capture file.

    ``dtype`` in {'int16', 'float32', 'float64'}; ``header_bytes`` skipped
    at the file start.  :meth:`read` returns ``(nch, n)`` float32; with
    ``decim > 1`` each output sample is the boxcar mean of ``decim`` input
    frames (fused into the native copy).
    """

    def __init__(self, path, nch, dtype="float32", header_bytes=0,
                 force_numpy=False):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r} not in {list(_DTYPES)}")
        self.path = os.fspath(path)
        self.nch = int(nch)
        self.dtype = dtype
        self.header_bytes = int(header_bytes)
        self._code, self._np_dtype = _DTYPES[dtype]
        self._h = None
        self._mm = None

        lib = None if force_numpy else _load_native()
        if lib is not None:
            h = lib.shotloader_open(self.path.encode(), self.nch,
                                    self._code, self.header_bytes)
            if not h:
                raise OSError(f"cannot open shot file {self.path!r}")
            self._h = ctypes.c_void_p(h)
            self._lib = lib
            self.nsamples = int(lib.shotloader_nsamples(self._h))
        else:
            data = np.memmap(self.path, dtype=self._np_dtype, mode="r",
                             offset=self.header_bytes)
            self.nsamples = data.size // self.nch
            self._mm = data[:self.nsamples * self.nch].reshape(
                self.nsamples, self.nch)

    @property
    def native(self):
        return self._h is not None

    def read(self, start=0, count=None, decim=1, out=None):
        """``(nch, floor(count/decim))`` float32 block starting at frame
        ``start``, written into ``out`` (a C-contiguous float32 array of
        that shape) when it is given."""
        if count is None:
            count = self.nsamples - start
        count = max(0, min(count, self.nsamples - start))
        decim = int(decim)
        if decim < 1:
            raise ValueError("decim must be >= 1")
        count -= count % decim
        nout = count // decim
        if out is None:
            out = np.empty((self.nch, nout), dtype=np.float32)
        elif (out.shape != (self.nch, nout) or out.dtype != np.float32
              or not out.flags.c_contiguous):
            raise ValueError(
                f"out must be C-contiguous float32 of shape "
                f"{(self.nch, nout)}, got {out.dtype} {out.shape}")
        if nout == 0:
            return out
        if self._h is not None:
            n = self._lib.shotloader_read(
                self._h, int(start), int(count), decim,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if n != nout:
                raise OSError(f"native read returned {n}, expected {nout}")
        else:
            blk = np.asarray(self._mm[start:start + count], dtype=np.float32)
            if decim == 1:
                out[:] = blk.T
            else:
                out[:] = blk.reshape(nout, decim, self.nch).mean(
                    axis=1).T
        return out

    def stream(self, block=1 << 16, decim=1, start=0, prefetch=0):
        """Iterate ``(nch, <=block/decim)`` float32 blocks over the file.

        ``prefetch > 0``: blocks are produced asynchronously ``prefetch``
        slots ahead of the consumer — on the native path by a C++ worker
        thread (ring buffer inside ``libshotloader``), otherwise by a
        Python reader thread — so disk latency and the deinterleave/
        convert/decimate work overlap the consumer's (device) compute.
        """
        block = int(block) - int(block) % int(decim)
        if prefetch and self._h is not None:
            yield from self._stream_native_prefetch(block, int(decim),
                                                    int(start),
                                                    int(prefetch))
            return
        if prefetch:
            yield from self._stream_thread_prefetch(block, int(decim),
                                                    int(start),
                                                    int(prefetch))
            return
        pos = int(start)
        while pos < self.nsamples:
            blk = self.read(pos, min(block, self.nsamples - pos), decim)
            if blk.shape[1] == 0:
                break
            yield blk
            pos += blk.shape[1] * decim

    def _stream_native_prefetch(self, block, decim, start, prefetch):
        nout_max = block // decim
        ph = self._lib.shotloader_prefetch_start(
            self._h, start, -1, block, decim, max(2, prefetch + 1))
        if not ph:
            raise OSError("shotloader_prefetch_start failed")
        ph = ctypes.c_void_p(ph)
        try:
            while True:
                out = np.empty((self.nch, nout_max), dtype=np.float32)
                n = self._lib.shotloader_prefetch_next(
                    ph, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if n < 0:
                    raise OSError("shotloader_prefetch_next failed")
                if n == 0:
                    break
                # slots are written (nch, n) row-major with the SLOT's n
                yield (out[:, :n] if n == nout_max
                       else np.ascontiguousarray(
                           out.reshape(-1)[:self.nch * n]
                           .reshape(self.nch, n)))
        finally:
            self._lib.shotloader_prefetch_close(ph)

    def _stream_thread_prefetch(self, block, decim, start, prefetch):
        import queue
        q = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def produce():
            pos = start
            try:
                while pos < self.nsamples and not stop.is_set():
                    blk = self.read(pos, min(block, self.nsamples - pos),
                                    decim)
                    if blk.shape[1] == 0:
                        break
                    q.put(blk)
                    pos += blk.shape[1] * decim
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                blk = q.get()
                if blk is None:
                    break
                yield blk
        finally:
            stop.set()
            # drain so the producer's final put never blocks
            try:
                while q.get_nowait() is not None:
                    pass
            except queue.Empty:
                pass
            t.join(timeout=5)

    def close(self):
        if self._h is not None:
            self._lib.shotloader_close(self._h)
            self._h = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class _Staging:
    """Two pinned host buffers a card's blocks are read into, each
    overwritten only after the copy that last read it has completed."""

    def __init__(self, nch, nmax, device):
        self.bufs = [torch.empty(nch * nmax, dtype=torch.float32,
                                 pin_memory=True) for _ in range(2)]
        self.done = [None, None]
        self.device = device
        self.k = 0

    def read(self, loader, pos, count, decim):
        """The block at ``pos`` read into the next buffer, copied to the
        card without waiting for the copy."""
        k, self.k = self.k, self.k ^ 1
        if self.done[k] is not None:
            self.done[k].synchronize()
        n = count // decim
        host = self.bufs[k][:loader.nch * n].view(loader.nch, n)
        loader.read(pos, count, decim, out=host.numpy())
        blk = host.to(self.device, non_blocking=True)
        self.done[k] = torch.cuda.Event()
        self.done[k].record(torch.cuda.current_stream(self.device))
        return blk


def stream_welch(loader, nwins, fs, ref_channel=0, block=1 << 18, decim=1,
                 device=None, **welch_kw):
    """Stream a whole shot file through :class:`~pyfft_tpu_torch.streaming.
    StreamingWelch` (reference channel vs all channels) on ``device``
    (:func:`~pyfft_tpu_torch.config.resolve_device`); returns the result
    Struct."""
    from ..streaming import StreamingWelch

    sw = StreamingWelch(nwins=nwins, fs=fs / decim, nch=loader.nch,
                        device=device, **welch_kw)
    step = int(block) - int(block) % int(decim)
    staging = (_Staging(loader.nch, step // decim, sw.device)
               if sw.device.type == "cuda" else None)
    for pos in range(0, loader.nsamples, step):
        count = min(step, loader.nsamples - pos)
        count -= count % decim
        if count == 0:
            break
        blk = (staging.read(loader, pos, count, decim) if staging
               else torch.from_numpy(loader.read(pos, count, decim)))
        sw.push(blk[ref_channel], blk)
    return sw.result()
