"""The Hilbert slice of pyfft_tpu_torch against the JAX package on the CPU.

- ``hilbert`` / ``hilbert_1d`` in float64 against the JAX functions in x64
  (tests/conftest.py): atol 1e-10, the FFT libraries' rounding only.
- The factored chain (outer ``torch.fft``, kernel D's plain version in the
  middle, inverse outer ``torch.fft``) on float32 input against JAX
  ``_analytic_factored`` and ``_analytic_factored_slab`` (interpret mode)
  at 'highest' precision: atol 3e-6 * max|z|, the JAX test's own bound
  between its two float32 chains (tests/test_hilbert.py).
- ``envelope_phase`` (float32 on both sides) against JAX ``envelope_phase``:
  envelope rtol 1e-5; phase, wrapped, within 1e-4 rad where the envelope
  is above 1e-2 of its maximum.
- On the CPU nothing launches kernel D (``ops.hilbert.LAUNCHES``).
- Kernel D's plan (``csrc/hilbert.cu`` on ``csrc/fft_reg.cuh``) emulated in
  float64: the factored twiddles, the rows of a block, ``fftreg``'s passes,
  the mask by register, 1/M and the conjugations as the spectrum is read
  back, the second transform and the conjugate twiddle, held
  to ``hilbert_plain`` in complex128 at 1e-12 of max for every row length
  16..16384, and the chain through it to scipy and the JAX chain.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch
import jax.numpy as jnp

from pyfft_tpu.hilbert import (_analytic_factored as j_factored,
                               _analytic_factored_slab as j_slab,
                               analytic_mask as j_mask,
                               envelope_phase as j_envelope_phase,
                               hilbert as j_hilbert,
                               hilbert_1d as j_hilbert_1d,
                               test_hilbert as j_test_hilbert)
from pyfft_tpu.ops.mxu_fft import balanced3_factorization

import pyfft_tpu_torch as pt
from pyfft_tpu_torch.hilbert import (_analytic_factored, _factored_applies,
                                     analytic_mask, envelope_phase)
from pyfft_tpu_torch.ops import hilbert as kd
from pyfft_tpu_torch.config import default_device

from test_torch_stft import _PT, _pad, _radices, _transform


@pytest.fixture(autouse=True)
def _cpu_default():
    """The port runs on the CPU only when asked to: these tests ask."""
    with default_device("cpu"):
        yield


def _signal(shape, cplx, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x


def _am(nt, fs=1e6):
    """bench config 4's AM signal at a small size (float32)."""
    t = np.arange(nt) / fs
    return ((1 + 0.5 * np.sin(2 * np.pi * 500 * t))
            * np.sin(2 * np.pi * 50e3 * t)).astype(np.float32)


@pytest.mark.parametrize("shape,cplx,nfft", [
    ((32,), False, None), ((33,), False, None), ((100,), False, None),
    ((255,), False, None), ((3, 64), False, None), ((64,), True, None),
    ((2, 33), True, None), ((100,), False, 128), ((100,), False, 64),
])
def test_hilbert_matches_jax(shape, cplx, nfft):
    x = _signal(shape, cplx, seed=sum(shape))
    got = pt.hilbert(x, nfft=nfft, device="cpu")
    want = j_hilbert(x, nfft=nfft)
    assert got.dtype == np.complex128 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [32, 33, 100, 255])
def test_hilbert_1d_matches_jax(n):
    x = _signal((n,), False, seed=n)
    np.testing.assert_allclose(pt.hilbert_1d(x, device="cpu"),
                               j_hilbert_1d(x), rtol=0, atol=1e-10)


def test_hilbert_axis0_and_tensor_input():
    x = _signal((64, 3), False, seed=7)
    want = j_hilbert(x, axes=0)
    np.testing.assert_allclose(pt.hilbert(x, axes=0), want, atol=1e-10)
    np.testing.assert_allclose(pt.hilbert(torch.as_tensor(x), axes=0), want,
                               atol=1e-10)


@pytest.mark.parametrize("n", [2, 3, 8, 9, 16, 17, 1000, 1001])
def test_analytic_mask_matches_jax(n):
    np.testing.assert_array_equal(analytic_mask(n), j_mask(n))


def test_test_hilbert_matches_jax():
    np.testing.assert_allclose(pt.hilbert_mod.test_hilbert(),
                               j_test_hilbert(), atol=1e-12)


@pytest.mark.parametrize("nfft,split", [
    (1 << 24, (2048, 8192)), (9 << 20, (1152, 8192)), (1 << 12, (1, 4096)),
    (9 << 10, (9, 1024)), (48, (3, 16)), (1000, None), (1001, None),
    (8, None), (1 << 15, (4, 8192)), (2047 << 13, (2047, 8192)),
])
def test_row_split_is_a_function_of_nfft(nfft, split):
    assert kd.row_split(nfft) == split
    n1, M = kd.row_split(1 << 24, kd.ROW_MAX)
    assert (n1, M) == (1024, 16384)


@pytest.mark.parametrize("nfft,max_row", [
    (1 << 12, kd.ROW_DEFAULT), (1 << 12, 256), (9 << 10, kd.ROW_MAX),
    (9 << 10, 64), (1 << 14, kd.ROW_MAX),
])
def test_factored_chain_matches_jax_chains(nfft, max_row):
    """float32 chains; the JAX factorization is (n1, n2, n3), the port's
    (n1, M).  Both against the JAX chain and its Pallas slab kernel."""
    rng = np.random.default_rng(nfft + max_row)
    x = rng.standard_normal(nfft).astype(np.float32)
    fac = balanced3_factorization(nfft)
    zr0, zi0 = j_factored(jnp.asarray(x), nfft=nfft, factors=fac,
                          prec="highest")
    zr1, zi1 = j_slab(jnp.asarray(x), nfft=nfft, factors=fac,
                      prec="highest", interpret=True)
    before = kd.LAUNCHES
    z = _analytic_factored(torch.as_tensor(x),
                           split=kd.row_split(nfft, max_row)).numpy()
    assert kd.LAUNCHES == before
    assert z.dtype == np.complex64
    for zr, zi in ((zr0, zi0), (zr1, zi1)):
        want = np.asarray(zr) + 1j * np.asarray(zi)
        np.testing.assert_allclose(z, want, rtol=0,
                                   atol=3e-6 * np.abs(want).max())


@pytest.mark.parametrize("n1,M", [(1, 16), (3, 16), (4, 64), (9, 128),
                                  (16, 256)])
def test_hilbert_plain_matches_float64_dft(n1, M):
    """The rows' section in complex128 against its definition written out
    with NumPy DFT matrices: rtol 1e-12."""
    rng = np.random.default_rng(n1 * M)
    A = rng.standard_normal((n1, M)) + 1j * rng.standard_normal((n1, M))
    N = n1 * M
    k1 = np.arange(n1)[:, None]
    m = np.arange(M)[None, :]
    w = np.exp(-2j * np.pi * ((k1 * m) % N) / N)
    D = np.exp(-2j * np.pi * np.outer(np.arange(M), np.arange(M)) / M)
    X = (A * w) @ D.T
    k = k1 + n1 * m
    h = np.where((k == 0) | (k == N // 2), 1.0, np.where(k < N // 2, 2.0,
                                                         0.0))
    want = ((X * h) @ D.conj().T / M) * w.conj()
    got = kd.hilbert_plain(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("nt,nfft,shape", [
    (1 << 12, None, None), (9 << 10, None, None), (1000, None, None),
    (1000, 1024, None), (1 << 11, None, (2, 1 << 11)), (1001, None, None),
])
def test_envelope_phase_matches_jax(nt, nfft, shape):
    x = _am(nt)
    if shape is not None:
        x = np.stack([x, 0.5 * x[::-1]])
    before = kd.LAUNCHES
    env, ph = envelope_phase(x, nfft=nfft, device="cpu")
    assert kd.LAUNCHES == before
    jenv, jph = j_envelope_phase(x, nfft=nfft)
    assert env.dtype == ph.dtype == np.float32
    assert env.shape == jenv.shape and ph.shape == jph.shape
    np.testing.assert_allclose(env, jenv, rtol=1e-5)
    keep = jenv > 1e-2 * jenv.max()
    dphi = np.angle(np.exp(1j * (ph.astype(np.float64) - jph)))
    assert np.abs(dphi[keep]).max() <= 1e-4


@pytest.mark.parametrize("nt,nfft,shape,factored", [
    (1 << 12, 1 << 12, (1 << 12,), True),
    (9 << 10, 9 << 10, (9 << 10,), True),
    (1000, 1000, (1000,), False),           # power-of-two part 8 < 16
    (1000, 1024, (1000,), False),           # nfft != nt
    (2048, 2048, (2, 2048), False),         # N-D
])
def test_envelope_phase_route_is_a_gate_on_shapes(nt, nfft, shape, factored):
    u = torch.zeros(shape, dtype=torch.float32)
    assert _factored_applies(u, nfft, -1) is factored


def test_envelope_phase_demodulates_am():
    """The config-4 checks at 2^16 samples on the CPU: the envelope tracks
    1 + 0.5 sin(2 pi 500 t) away from the edges, and the median
    instantaneous frequency is within 1 Hz of 50 kHz."""
    nt, fs = 1 << 16, 1e6
    env, ph = envelope_phase(_am(nt, fs), device="cpu")
    t = np.arange(nt) / fs
    core = slice(2000, -2000)
    want = 1 + 0.5 * np.sin(2 * np.pi * 500 * t)
    np.testing.assert_allclose(env[core], want[core], atol=2e-3)
    finst = np.diff(np.unwrap(ph.astype(np.float64))) * fs / (2 * np.pi)
    assert abs(np.median(finst) - 50e3) < 1.0


def test_envelope_phase_mesh_raises():
    """``mesh=`` runs the distributed transform (the mesh tier's FFT half,
    tests/test_torch_parallel_fft.py) on a one-rank gloo group: the
    single-device result, and the ``LAST axis`` error for another axis."""
    import torch.distributed as dist
    from pyfft_tpu_torch import parallel as par
    x = _am(4096, 1e6)
    env1, ph1 = envelope_phase(x, device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = par.make_mesh(1, 1, device="cpu")
        env2, ph2 = envelope_phase(x, mesh=mesh)
        with pytest.raises(ValueError, match="LAST axis"):
            envelope_phase(np.ones((4, 64)), axes=0, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert env2.dtype == ph2.dtype == np.float32 and env2.shape == (4096,)
    np.testing.assert_allclose(env2, env1, atol=2e-5 * np.abs(env1).max())
    dphi = np.angle(np.exp(1j * (ph2.astype(np.float64) - ph1)))
    np.testing.assert_allclose(dphi, 0.0, atol=1e-4)


def test_hilbert_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kd.hilbert_cuda(torch.zeros(4, 16, dtype=torch.complex64))


# --------------------------------------------------------------------------- #
# Kernel D's plan (csrc/hilbert.cu on csrc/fft_reg.cuh), emulated in float64
# --------------------------------------------------------------------------- #

_SRC = Path(pt.__file__).resolve().parent / "csrc" / "hilbert.cu"


def _const(name):
    """An ``int`` constant of ``csrc/hilbert.cu``."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _SRC.read_text()).group(1))


def _block_threads(logm):
    """``block_threads``: one row's M/16 threads, or several rows up to
    ``kMinThreads``."""
    return max((1 << logm) // _PT, _const("kMinThreads"))


def _w(e, N):
    """W_N^e = exp(-2 pi i e / N) in float64 for integer exponents."""
    return torch.exp(-2j * np.pi * (e % N).to(torch.float64) / N)


def _emulate_kernel_d(A):
    """Kernel D's arithmetic in float64 on rows ``A (n1, M)``: block b's
    slot s takes row k1 = b*F + s (slots past n1 load zeros and store
    nothing); thread t's point r is sample t + r*T, twiddled by W_N^(t k1)
    * W_N^(r T k1); ``fftreg::transform``; thread t's inverse point q is
    bin t + q*T of the spectrum in shared memory, times the kernel's gain
    for q over M, conjugated; ``transform`` again; sample t + q*T of the
    buffer times the twiddle, conjugated, to ``out``.  Unwritten outputs
    stay NaN."""
    n1, M = A.shape
    logm = M.bit_length() - 1
    N, T = n1 * M, M // _PT
    F = _block_threads(logm) // T
    k1 = torch.arange(-(-n1 // F) * F)[:, None, None]     # (blocks*F, 1, 1)
    active = k1[:, 0, 0] < n1
    t = torch.arange(T)[:, None]
    q = torch.arange(_PT)
    steps = _w(q * T * k1, N)                             # (K, 1, 16)
    base = _w(t * k1, N)                                  # (K, T, 1)
    rows = torch.zeros(k1.shape[0], M, dtype=torch.complex128)
    rows[active] = A.to(torch.complex128)
    n = t + q * T                                         # (T, 16)
    v = rows[:, n] * (base * steps)
    spec = _transform(v, logm)[..., _pad(n)]
    # the gains by q alone: 2 below q = 8, 0 above; 1 at q = 0 and 8 where
    # t = 0 in row 0 (bins 0 and N/2)
    edge = (t == 0) & (k1 == 0)
    h = torch.where(edge & (q % (_PT // 2) == 0), 1.0,
                    torch.where(q < _PT // 2, 2.0, 0.0)) / M
    z = (_transform((spec * h).conj(), logm)[..., _pad(n)]
         * (base * steps)).conj()
    out = torch.full((n1, M), complex(np.nan, np.nan),
                     dtype=torch.complex128)
    out[:, n.reshape(-1)] = z[active].reshape(n1, -1)
    return out


@pytest.mark.parametrize("logn", range(4, 15))
def test_last_pass_writes_each_thread_the_next_first_pass_points(logn):
    """``fftreg``'s last pass (radix R, spanning Ns = N/R) writes thread
    t's register b*R + r to bin t + T*(b + r*16/R): the 16 registers of a
    thread are bins t + q*T, the first-pass points of another transform,
    so a handoff in registers would be a renaming of them (measured
    slower, PERF.md, kernel D).  Checked on the store indices and on the
    emulated spectrum against the DFT at 1e-12."""
    N = 1 << logn
    T = N // _PT
    R = _radices(logn)[-1]
    Ns = N // R
    t = torch.arange(T)[:, None, None]
    b = torch.arange(_PT // R)[:, None]
    r = torch.arange(R)
    j = t + b * T                                    # butterflies, < Ns
    d = (j // Ns) * Ns * R + j % Ns + r * Ns          # store_pass
    assert bool((j < Ns).all())
    assert torch.equal(d, t + T * (b + r * (_PT // R)))
    q = (b + r * (_PT // R)).reshape(-1)
    assert sorted(q.tolist()) == list(range(_PT))
    rng = np.random.default_rng(logn)
    z = torch.as_tensor(rng.standard_normal((2, N))
                        + 1j * rng.standard_normal((2, N)))
    tt = torch.arange(T)[:, None]
    buf = _transform(z[:, tt + torch.arange(_PT) * T], logn)
    ref = torch.fft.fft(z)[:, tt + q * T]
    got = buf[:, _pad(tt + q * T)]
    assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()


@pytest.mark.parametrize("logm,n1", [
    (4, 1), (4, 3), (4, 130), (5, 5), (6, 7), (6, 33), (7, 3), (8, 9),
    (9, 3), (10, 5), (11, 3), (12, 5), (13, 3), (13, 1), (14, 3), (14, 1),
])
def test_kernel_d_plan_matches_plain(logm, n1):
    """The float64 emulation of kernel D's plan against ``hilbert_plain``
    in complex128: 1e-12 of max, every output written once."""
    M = 1 << logm
    rng = np.random.default_rng(n1 * M)
    A = torch.as_tensor(rng.standard_normal((n1, M))
                        + 1j * rng.standard_normal((n1, M)))
    got = _emulate_kernel_d(A)
    assert not got.isnan().any()
    ref = kd.hilbert_plain(A)
    assert (got - ref).abs().max() <= 1e-12 * ref.abs().max()


@pytest.mark.parametrize("logm", range(4, 15))
def test_kernel_d_rows_per_block(logm):
    """One row per M/16 threads; below M = 2048 a block of 128 threads
    takes 128/(M/16) rows, from M = 2048 one row a block of M/16 threads;
    a block's shared memory (pad(M) float2 a row, and 16 twiddle steps a
    row) fits the card's 227 KB, and its threads the 1024 of a block."""
    M = 1 << logm
    T = M // _PT
    threads = _block_threads(logm)
    F = threads // T
    assert F * T == threads <= 1024
    assert F == (1 if M >= 2048 else 2048 // M)
    assert F * (_pad(M) + _PT) * 8 <= 232448
    assert _const("kMinLogM") == 4 and _const("kMaxLogM") == 14
    assert (1 << _const("kMinLogM"), 1 << _const("kMaxLogM")) == (
        kd.ROW_MIN, kd.ROW_MAX)


@pytest.mark.parametrize("nfft,max_row", [
    (1 << 12, kd.ROW_DEFAULT), (9 << 10, 64), (48, kd.ROW_MAX),
    (3 << 14, kd.ROW_MAX), (1 << 14, 16),
])
def test_kernel_d_plan_chain_matches_scipy_and_jax(nfft, max_row):
    """The chain (outer torch.fft, the emulated kernel D, inverse outer
    torch.fft) in float64 against ``scipy.signal.hilbert`` at 1e-12 of max,
    and against the JAX ``_analytic_factored`` (float32 tables) at the JAX
    test's own 3e-6 of max."""
    rng = np.random.default_rng(nfft + max_row)
    x = rng.standard_normal(nfft)
    z = _analytic_factored(torch.as_tensor(x),
                           split=kd.row_split(nfft, max_row),
                           rows=_emulate_kernel_d).numpy()
    want = scipy.signal.hilbert(x)
    assert np.abs(z - want).max() <= 1e-12 * np.abs(want).max()
    zr, zi = j_factored(jnp.asarray(x.astype(np.float32)), nfft=nfft,
                        factors=balanced3_factorization(nfft),
                        prec="highest")
    jz = np.asarray(zr) + 1j * np.asarray(zi)
    assert np.abs(z - jz).max() <= 3e-6 * np.abs(jz).max()
