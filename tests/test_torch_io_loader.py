"""The port's shot-file loader against the JAX package's.

Both packages read the same files (int16, float32 and float64 frames
behind a 32-byte header); the port's blocks must equal the JAX package's
bit for bit, with the C++ reader and with the NumPy one, with and without
decimation and prefetch.  The port builds its own copy of the reader
(``pyfft_tpu_torch/csrc/shotloader.cpp``) under ``pyfft_tpu_torch/_build``.
``stream_welch`` runs on the CPU here and is held to the JAX package's at
2e-5 of max: the port computes the loader's float32 blocks in float32 (as
the kernels do on the card), the JAX package casts them to float64.
"""
import numpy as np
import pytest

from pyfft_tpu.io import ShotLoader as JaxShotLoader
from pyfft_tpu.io import stream_welch as jax_stream_welch

import pyfft_tpu_torch as pt
from pyfft_tpu_torch.config import default_device
from pyfft_tpu_torch.io import ShotLoader, stream_welch, native_available
from pyfft_tpu_torch.io import loader as ploader

NCH, NT = 4, 50000


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


@pytest.fixture(scope="module", params=["int16", "float32", "float64"])
def shotfile(request, tmp_path_factory):
    dtype = request.param
    rng = np.random.default_rng({"int16": 1, "float32": 2,
                                 "float64": 3}[dtype])
    sig = rng.standard_normal((NT, NCH)) * 100.0
    arr = sig.astype({"int16": np.int16, "float32": np.float32,
                      "float64": np.float64}[dtype])
    path = tmp_path_factory.mktemp("shots") / f"shot_{dtype}.bin"
    with open(path, "wb") as f:
        f.write(b"DAQHDR\x00\x01" * 4)       # 32-byte header
        f.write(arr.tobytes())               # interleaved frames
    return str(path), dtype, arr


def test_native_lib_builds_in_the_ports_build_dir():
    """The port's reader builds from its own source into
    ``pyfft_tpu_torch/_build/shotloader-<hash>/``, never into native/."""
    assert native_available(), "g++ present; the native build failed"
    so = ploader.library_path()
    assert so.exists()
    assert so.parent.parent == ploader._PKG / "_build"
    assert so.parent.name.startswith("shotloader-")
    assert ploader._SRC == ploader._PKG / "csrc" / "shotloader.cpp"


@pytest.mark.parametrize("force_numpy", [False, True])
def test_read_matches_jax_bit_for_bit(shotfile, force_numpy):
    path, dtype, arr = shotfile
    kw = dict(header_bytes=32, force_numpy=force_numpy)
    with ShotLoader(path, NCH, dtype, **kw) as got, \
            JaxShotLoader(path, NCH, dtype, **kw) as want:
        assert got.native == want.native == (not force_numpy)
        assert got.nsamples == want.nsamples == NT
        for start, count, decim in [(0, NT, 1), (1000, 8192, 1),
                                    (17, 9999, 3), (0, NT, 8),
                                    (NT - 5, 100, 1)]:
            np.testing.assert_array_equal(got.read(start, count, decim),
                                          want.read(start, count, decim))


def test_native_and_numpy_readers_agree(shotfile):
    path, dtype, arr = shotfile
    with ShotLoader(path, NCH, dtype, header_bytes=32) as nat, \
            ShotLoader(path, NCH, dtype, header_bytes=32,
                       force_numpy=True) as ref:
        for start, count, decim in [(0, NT, 1), (17, 9999, 3), (0, NT, 8)]:
            np.testing.assert_allclose(nat.read(start, count, decim),
                                       ref.read(start, count, decim),
                                       rtol=1e-6, atol=1e-4)
        blk = nat.read(100, 50)
        np.testing.assert_allclose(blk, arr[100:150].astype(np.float32).T,
                                   rtol=1e-6)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_read_into_out(shotfile, force_numpy):
    """``read(..., out=)`` writes the block into the caller's buffer (what
    ``stream_welch`` does with its pinned buffers) and checks its shape."""
    path, dtype, _ = shotfile
    with ShotLoader(path, NCH, dtype, header_bytes=32,
                    force_numpy=force_numpy) as ld:
        buf = np.full(NCH * 3000, np.nan, dtype=np.float32)
        out = buf[:NCH * 2000].reshape(NCH, 2000)
        got = ld.read(300, 8000, 4, out=out)
        assert got is out
        np.testing.assert_array_equal(out, ld.read(300, 8000, 4))
        assert np.isnan(buf[NCH * 2000:]).all()
        with pytest.raises(ValueError, match="out must be"):
            ld.read(0, 100, out=np.empty((NCH, 99), np.float32))


@pytest.mark.parametrize("force_numpy", [False, True])
@pytest.mark.parametrize("decim", [1, 4])
@pytest.mark.parametrize("prefetch", [0, 3])
def test_stream_matches_jax_bit_for_bit(shotfile, force_numpy, decim,
                                        prefetch):
    """Blocks of ``stream`` (synchronous, the C++ ring or the reader
    thread) equal the JAX package's bit for bit, the short trailing block
    included, and cover the file."""
    path, dtype, _ = shotfile
    kw = dict(header_bytes=32, force_numpy=force_numpy)
    with ShotLoader(path, NCH, dtype, **kw) as got, \
            JaxShotLoader(path, NCH, dtype, **kw) as want:
        a = list(got.stream(block=9000, decim=decim, prefetch=prefetch))
        b = list(want.stream(block=9000, decim=decim, prefetch=prefetch))
    assert len(a) == len(b)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(q))
    assert sum(p.shape[1] for p in a) == NT // decim


def _tone_file(tmp_path, nt, fs, offset=0.0):
    t = np.arange(nt) / fs
    rng = np.random.default_rng(0)
    sig = np.stack([np.sin(2 * np.pi * 2500.0 * t),
                    0.5 * np.sin(2 * np.pi * 2500.0 * t - 0.9)], axis=1)
    sig = 1000 * (sig + 0.02 * rng.standard_normal((nt, 2))) + offset
    path = tmp_path / "tone.bin"
    with open(path, "wb") as f:
        f.write(sig.astype(np.int16).tobytes())
    return str(path)


@pytest.mark.parametrize("backend", [None, "pallas"])
@pytest.mark.parametrize("decim", [1, 2])
def test_stream_welch_matches_jax(tmp_path, backend, decim):
    """A tone capture with an ADC offset 100x its noise, streamed through
    both packages' ``stream_welch``: the line, coherence and phase, and
    every output within 2e-5 of the JAX package's (float32 blocks)."""
    fs = 5e4
    path = _tone_file(tmp_path, 1 << 17, fs, offset=2000.0)
    with ShotLoader(path, 2, "int16") as ld:
        got = stream_welch(ld, nwins=4096, fs=fs, block=1 << 15,
                           decim=decim, fft_backend=backend, device="cpu")
    with JaxShotLoader(path, 2, "int16") as ld:
        want = jax_stream_welch(ld, nwins=4096, fs=fs, block=1 << 15,
                                decim=decim)
    pk = int(np.argmax(got.Pxx))
    assert abs(got.freq[pk] - 2500.0) < fs / decim / 4096
    assert got.Cxy2[1, pk].real > 0.95
    assert abs(got.phi_xy[1, pk] + 0.9) < 0.02
    assert got.Navr == want.Navr and got.nseen == want.nseen
    for name in ("Pxx", "Pyy", "Pxy"):
        g, w = getattr(got, name), getattr(want, name)
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), name


def test_stream_welch_follows_the_device_rule(tmp_path):
    """``stream_welch`` computes on the package default (here the CPU) and
    returns host NumPy, as the JAX package does."""
    path = _tone_file(tmp_path, 1 << 15, 5e4)
    with ShotLoader(path, 2, "int16") as ld:
        res = stream_welch(ld, nwins=2048, fs=5e4)
    assert isinstance(res.Pxx, np.ndarray) and res.Pxx.dtype == np.float64


def test_io_exports():
    assert pt.io.ShotLoader is ShotLoader is pt.ShotLoader
    assert pt.io.stream_welch is stream_welch
    assert pt.io.save_hdf5 is pt.heatpulse.save_hdf5
    assert pt.io.load_hdf5 is pt.heatpulse.load_hdf5
