"""Kernel A's module (pyfft_tpu_torch.ops.fir, filters.py) against the JAX
package.

On the CPU the port's FIR wrapper runs kernel A's plain version; the JAX
side runs its Pallas kernel in interpret mode at precision 'highest'.  The
kernel itself runs only on a CUDA card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import pyfft_tpu.filters as jfilters
from pyfft_tpu.ops import pallas_fir as jfir

import pyfft_tpu_torch.filters as pfilters
from pyfft_tpu_torch.ops import fir as pfir
from pyfft_tpu_torch.config import default_device


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _taps(K, seed=0):
    if K == 1:
        return np.array([0.7])
    return np.asarray(jfilters.firwin(K | 1, [0.05, 0.45],
                                      pass_zero=False))[:K] \
        + 1e-3 * np.random.default_rng(seed).standard_normal(K)


@pytest.mark.parametrize("K", [1, 63, 129, 1024])
def test_fir_plain_matches_jax_kernel_and_numpy(K):
    """float32, nt not a multiple of 128.  Both sides accumulate K float32
    products, so they agree with the float64 np.convolve to ~K*eps32 of the
    output scale: atol 2e-6 * max|ref| (K=1024 gives ~1e-6 observed)."""
    rng = np.random.default_rng(K)
    nt = 3000 + K % 7
    x = rng.standard_normal((2, nt)).astype(np.float32)
    taps = _taps(K)
    ref = np.stack([np.convolve(r.astype(np.float64), taps)[:nt] for r in x])
    jax_out = np.asarray(jfir.fir_pallas(x, taps, interpret=True,
                                         precision="highest"))
    port = pfir.fir_pallas(torch.from_numpy(x), taps)
    assert port.dtype == torch.float32 and port.shape == (2, nt)
    atol = 2e-6 * np.abs(ref).max()
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=atol)
    np.testing.assert_allclose(port.numpy(), jax_out, rtol=0, atol=atol)


@pytest.mark.parametrize("K", [1, 63, 1024])
def test_fir_plain_float64_is_the_convolution(K):
    """In float64 the plain version is np.convolve(x, taps)[:nt] to
    rounding (rtol 1e-12 of the output scale)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 777))
    taps = _taps(K, seed=1)
    ref = np.stack([np.convolve(r, taps)[:777] for r in x])
    got = pfir.fir_plain(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    one = pfir.fir_pallas(torch.from_numpy(x[0]), taps)
    assert one.shape == (777,)
    np.testing.assert_allclose(one.numpy(), ref[0], rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_fir_plain_complex_filters_both_parts():
    rng = np.random.default_rng(3)
    z = rng.standard_normal(500) + 1j * rng.standard_normal(500)
    taps = _taps(33)
    got = pfir.fir_plain(torch.from_numpy(z), taps).numpy()
    np.testing.assert_allclose(got, np.convolve(z, taps)[:500], rtol=0,
                               atol=1e-12 * np.abs(z).max())


def test_tiled_aliases_match_jax_layout():
    """tile_rows/untile_rows/fir_pallas_tiled keep the JAX contract: the
    (nch, nrows, 128) row view, same layout in and out."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    taps = _taps(129)
    jr, jnt = jfir.tile_rows(x, block_rows=16)
    pr, pnt = pfir.tile_rows(torch.from_numpy(x), block_rows=16)
    assert jnt == pnt and tuple(jr.shape) == tuple(pr.shape)
    np.testing.assert_array_equal(np.asarray(jr), pr.numpy())
    jy = np.asarray(jfir.fir_pallas_tiled(jr, taps, interpret=True,
                                          precision="highest"))
    py = pfir.fir_pallas_tiled(pr, taps)
    assert tuple(py.shape) == jy.shape
    np.testing.assert_allclose(py.numpy(), jy, rtol=0,
                               atol=2e-6 * np.abs(jy).max())
    np.testing.assert_array_equal(pfir.untile_rows(py, pnt).numpy(),
                                  py.reshape(2, -1)[:, :pnt].numpy())


@pytest.mark.parametrize("backend", [None, "os", "pallas"])
def test_fir_filter_matches_jax(backend):
    """fir_filter on float64: overlap-save on torch.fft vs jnp.fft at
    rtol 1e-10 of the scale (x64 on both sides); 'pallas' is float32 on
    both sides (the kernels' dtype): atol 2e-6 of the scale."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 2000))
    taps = _taps(129)
    ref = np.asarray(jfilters.fir_filter(x, taps, backend=backend))
    got = pfilters.fir_filter(torch.from_numpy(x), taps, backend=backend)
    assert isinstance(got, np.ndarray)
    assert got.dtype == np.float64 and got.shape == x.shape
    tol = 2e-6 if backend == "pallas" else 1e-10
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    # axis handling: time on axis 0
    got0 = pfilters.fir_filter(torch.from_numpy(x.T.copy()), taps, axis=0,
                               backend=backend)
    np.testing.assert_allclose(got0.T, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_oaconvolve_matches_jax(mode):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 3001))
    taps = _taps(200)
    ref = np.asarray(jfilters.oaconvolve(x, taps, mode=mode))
    got = pfilters.oaconvolve(torch.from_numpy(x), taps, mode=mode)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["fir_filter", "oaconvolve"])
def test_numpy_in_numpy_out_on_the_asked_device(name):
    """NumPy input with ``device="cpu"``: NumPy out, as the JAX package
    returns, equal to the JAX result (float64 on both sides, 1e-10 of the
    scale)."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 1500))
    taps = _taps(65)
    ref = np.asarray(getattr(jfilters, name)(x, taps))
    got = getattr(pfilters, name)(x, taps, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("args", [
    (129, [0.05, 0.45], False), (64, 0.3, True), (101, 0.2, False),
    (51, [0.1, 0.3], True)])
def test_firwin_matches_jax(args):
    n, cut, pz = args
    np.testing.assert_array_equal(pfilters.firwin(n, cut, pass_zero=pz),
                                  jfilters.firwin(n, cut, pass_zero=pz))


def test_fir_rejects_bad_taps_and_devices():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="taps"):
        pfir.fir_pallas(x, np.ones(1025))
    with pytest.raises(ValueError, match="taps"):
        pfir.fir_pallas(x, np.ones(0))
    # the kernel wrapper never runs CPU tensors: it raises
    with pytest.raises(ValueError, match="CUDA"):
        pfir.fir_cuda(x, np.ones(3))
