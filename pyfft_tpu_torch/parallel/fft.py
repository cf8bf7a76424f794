"""Distributed FFT: the four-step decomposition over the ``'t'`` mesh axis.

Counterpart of :mod:`pyfft_tpu.parallel.fft`, run SPMD on
``torch.distributed``: every rank calls with the same global input, takes
its contiguous ``1/D`` block of the last axis (``D`` ranks along ``'t'``),
and gets back its contiguous block of the output axis, as tensors on its
device (the shard a JAX device holds).  Transforms whose working set
outgrows one card factor into local stages with all-to-all transposes
between them, the four-step (Bailey) algorithm:

    N = N1 * N2,   n = n1*N2 + n2,   k = k1 + N1*k2
    X[k1 + N1*k2] = sum_{n2} W_N^{n2 k1} [ sum_{n1} x[n1*N2+n2] W_N1^{n1 k1} ]
                    * W_N2^{n2 k2}

Stage map (rank ``r`` holds samples ``[r*N/D, (r+1)*N/D)``):

    1. local reshape to (N1/D, N2) rows
    2. all-to-all  -> (N1, N2/D)  columns
    3. local length-N1 FFT along n1
    4. local twiddle  W_N^{k1 * n2}
    5. all-to-all  -> (N1/D, N2)  rows of k1
    6. local length-N2 FFT along n2
    7. transpose + all-to-all -> natural order, contiguous on k

The four-step runs where ``D^2 | N``; every other length takes the
distributed Bluestein chirp-z transform over a four-step of length
``M = D^2 * 2^k >= 2N - 1``.  Inverses ride the conjugation identity
``ifft(z) = conj(fft(conj(z))) / N``.  The local transforms are
``torch.fft`` for every backend name (``'pallas'`` and ``'mxu'`` name the
JAX package's TPU routes, where no Pallas kernel lies either), in
complex: the JAX function's real pairs are a TPU workaround.  The
arithmetic runs in the input's precision on the CPU (complex128 for
float64 input) and in complex64 on the card.  Twiddles come from the exact
integer products ``k1*n2 < N`` with the angle, its cosine and sine in
float64, rounded once to the compute dtype; the Bluestein chirps from the
host, with the angle reduced exactly modulo ``2N``.

Every rank issues every all-to-all in the same order (three a transform;
Bluestein adds one re-blocking before its transforms and one after);
:mod:`._comm` records them as ``all-to-all``.  Inside
:func:`~.runtime.recording` a call's wall splits into ``fft``,
``twiddle`` (every elementwise table product: twiddles, chirps, the
Bluestein filter, the analytic mask) and ``all_to_all``.

Also exported: :func:`axis_swap`, the bare re-shard that trades which
array axis is partitioned, and :func:`hilbert_sharded`, the analytic
signal with the mask applied on the frequency blocks where they lie.
"""
from __future__ import annotations

from functools import lru_cache
import math

import numpy as np
import torch

from . import _comm
from .mesh import axis_size, coordinate, group, mesh_device
from .welch import local_block

__all__ = ["fft_sharded", "ifft_sharded", "rfft_sharded", "irfft_sharded",
           "hilbert_sharded", "axis_swap", "four_step_factor"]


def four_step_factor(n: int, d: int):
    """Pick ``N1 * N2 = n`` with ``d | N1``, ``d | N2``, ``N1`` near sqrt(n).

    Both factors must be divisible by the shard count so each all-to-all
    moves equal tiles.  Raises if no such factorization exists (lengths
    with ``d^2 !| N`` go through the distributed Bluestein path instead).
    """
    if n % (d * d):
        raise ValueError(
            f"four-step FFT needs d^2={d*d} | N={n} (got remainder {n % (d*d)})")
    m = n // (d * d)
    best = None
    for m1 in range(1, int(np.sqrt(m)) + 1):
        if m % m1 == 0:
            for cand in (m1, m // m1):
                n1 = d * cand
                n2 = n // n1
                if n2 % d:
                    continue
                score = abs(n1 - np.sqrt(n))
                if best is None or score < best[0]:
                    best = (score, n1, n2)
    if best is None:
        raise ValueError(f"no valid four-step factorization of {n} over {d}")
    return best[1], best[2]


def _line(mesh, axis_name):
    """``(D, r, group, device)``: this rank's line along ``axis_name``."""
    return (axis_size(mesh, axis_name), coordinate(mesh, axis_name),
            group(mesh, axis_name), mesh_device(mesh))


def _swap(z, grp, split_axis, concat_axis):
    with _comm.step("all_to_all", z.device):
        return _comm.all_to_all(z, grp, split_axis, concat_axis)


# elements of a block of the twiddle table built at once (its float64
# temporaries are about 32 bytes an element)
_TWIDDLE_BLOCK = 1 << 22


def _fft(z, dim):
    with _comm.step("fft", z.device):
        return torch.fft.fft(z, dim=dim)


@lru_cache(maxsize=2)
def _twiddle(n, n1, cols, r, device, dtype):
    """``W_N^{k1 * n2}`` for ``k1 < n1`` and rank ``r``'s ``cols`` columns
    ``n2``: the angle from the exact product ``k1 * n2 < n``, in float64,
    rounded once to ``dtype``.  Built in blocks of rows straight into
    ``dtype``, so the float64 temporaries stay near ``_TWIDDLE_BLOCK``
    elements whatever the shard; the two latest tables stay cached (a
    Bluestein call's two transforms share one)."""
    out = torch.empty((n1, cols), dtype=dtype, device=device)
    n2 = torch.arange(cols, dtype=torch.int64, device=device) + r * cols
    step = max(1, _TWIDDLE_BLOCK // cols)
    for k0 in range(0, n1, step):
        k1 = torch.arange(k0, min(n1, k0 + step), dtype=torch.int64,
                          device=device)
        ang = (k1[:, None] * n2).to(torch.float64) * (-2.0 * math.pi / n)
        out[k0:k0 + step] = torch.polar(torch.ones_like(ang), ang)
    return out


def _fourstep(z, n, d, r, grp):
    """Forward DFT of the length-``n`` axis whose rank-``r`` block is ``z
    (..., n/d)``; returns the rank's block of the spectrum."""
    n1, n2 = four_step_factor(n, d)
    lead = z.shape[:-1]
    z = _swap(z.reshape(*lead, n1 // d, n2), grp, -1, -2)     # (n1, n2/d)
    z = _fft(z, -2)
    with _comm.step("twiddle", z.device):
        z = z * _twiddle(n, n1, n2 // d, r, z.device, z.dtype)
    z = _fft(_swap(z, grp, -2, -1), -1)                       # (n1/d, n2)
    z = _swap(z.transpose(-1, -2), grp, -2, -1)               # (n2/d, n1)
    return z.reshape(*lead, n // d)


def _fourstep_run(z, mesh, axis_name="t"):
    """Forward four-step transform of the axis whose rank block is ``z
    (..., N/D)``, complex; requires ``D^2 | N``.  Returns the rank's block
    of the spectrum."""
    d, r, grp, _ = _line(mesh, axis_name)
    return _fourstep(z, z.shape[-1] * d, d, r, grp)


def _inverse(forward, z, n):
    """The ``1/n``-normalised inverse of ``forward`` by the conjugation
    identity ``ifft(z) = conj(fft(conj(z))) / n``."""
    return forward(z.conj_physical()).conj_physical() / n


def bluestein_size(n, d):
    """The least ``M = d^2 * 2^k >= 2n - 1`` (at least ``d^2``)."""
    dd = d * d
    return dd * max(1, 1 << int(np.ceil(np.log2(max((2 * n - 1) / dd, 1)))))


@lru_cache(maxsize=2)
def _chirp_tables(n, M, d, r, device, dtype):
    """Rank ``r``'s blocks of the Bluestein chirp ``exp(-i pi k^2 / n)``
    (length ``n/d``) and of the filter ``V = FFT(v_ext)`` (length ``M/d``),
    built on the host in float64 with ``k^2`` reduced exactly modulo
    ``2n``, rounded once to ``dtype`` on ``device``.  The two latest sets
    stay cached: a length's first call pays the host build."""
    sq = (np.arange(n, dtype=np.int64) ** 2) % (2 * n)
    ang = np.pi * sq.astype(np.float64) / n
    v = np.exp(1j * ang)
    v_ext = np.zeros(M, dtype=np.complex128)
    v_ext[:n] = v
    if n > 1:
        v_ext[M - n + 1:] = v[1:][::-1]
    b, bm = n // d, M // d
    a = np.cos(ang[r * b:(r + 1) * b]) - 1j * np.sin(ang[r * b:(r + 1) * b])
    V = np.fft.fft(v_ext)[r * bm:(r + 1) * bm]
    return (torch.as_tensor(a, device=device).to(dtype),
            torch.as_tensor(V, device=device).to(dtype))


def _reblock(t, n, src, dst, d, r, grp):
    """Samples ``[0, n)`` of an axis held in blocks of ``src`` a rank
    (rank ``i`` holds ``[i*src, (i+1)*src)``), re-blocked to ``dst`` a
    rank; samples at ``n`` and past it come back as zeros."""
    def piece(i, j):
        return max(0, min((i + 1) * src, (j + 1) * dst, n)
                   - max(i * src, j * dst))
    recv = [piece(i, r) for i in range(d)]
    with _comm.step("all_to_all", t.device):
        got = _comm.all_to_all_v(t, grp, [piece(r, j) for j in range(d)],
                                 recv)
    out = t.new_zeros(t.shape[:-1] + (dst,))
    out[..., :sum(recv)] = got
    return out


def _bluestein_sharded(z, mesh, axis_name="t"):
    """Distributed chirp-z transform of the length-``N`` axis whose rank
    block is ``z (..., N/D)``, complex, for any ``N`` a multiple of ``D``.

    Re-expresses the DFT as an ``M``-point circular convolution
    (:func:`bluestein_size`, so the four-step always factors): the chirp
    product on the rank's block, a re-blocking to the ``M/D`` layout (zeros
    past ``N``), a forward four-step, the product with the filter's block,
    an inverse four-step, the re-blocking back and the chirp product.  Two
    all-to-all re-blockings more than two four-step transforms; about four
    times the arithmetic of one.  Returns the rank's block of the
    spectrum."""
    d, r, grp, _ = _line(mesh, axis_name)
    n = z.shape[-1] * d
    M = bluestein_size(n, d)
    a, V = _chirp_tables(n, M, d, r, z.device, z.dtype)
    with _comm.step("twiddle", z.device):
        u = z * a
    U = _fourstep(_reblock(u, n, n // d, M // d, d, r, grp), M, d, r, grp)
    with _comm.step("twiddle", z.device):
        UV = U * V
    w = _inverse(lambda t: _fourstep(t, M, d, r, grp), UV, M)
    w = _reblock(w, n, M // d, n // d, d, r, grp)
    with _comm.step("twiddle", z.device):
        return w * a


def _transform(z, mesh, axis_name, inverse):
    """The route of ``_run_pair``: four-step where ``D^2 | N``, Bluestein
    otherwise; the inverse through :func:`_inverse`."""
    d = axis_size(mesh, axis_name)
    n = z.shape[-1] * d
    route = _fourstep_run if n % (d * d) == 0 else _bluestein_sharded

    def forward(t):
        return route(t, mesh, axis_name)
    return _inverse(forward, z, n) if inverse else forward(z)


def _compute_dtype(x, device):
    """complex64 on the card; on the CPU, complex64 for float32 or
    complex64 input and complex128 for any other."""
    if device.type == "cuda":
        return torch.complex64
    dt = x.dtype if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.empty(0, x.dtype)).dtype
    return (torch.complex64 if dt in (torch.float32, torch.complex64)
            else torch.complex128)


def _block(x, mesh, axis_name, n=None):
    """Rank ``r``'s block ``[r*n/D, (r+1)*n/D)`` of the last axis of ``x``
    (NumPy or a tensor, the same on every rank), complex in the compute
    dtype on the rank's device; ``n`` (default the axis' length) pads with
    zeros or trims.  Raises ``ValueError`` where ``D`` does not divide
    ``n``."""
    d, r, _, dev = _line(mesh, axis_name)
    x = x if isinstance(x, torch.Tensor) else np.asarray(x)
    n = x.shape[-1] if n is None else n
    if n % d:
        raise ValueError(f"transform length {n} not divisible by {d} "
                         f"'{axis_name}' shards")
    lead = tuple(x.shape[:-1])
    rows = x.reshape(-1, x.shape[-1])[:, :n]
    z = local_block(rows, slice(None), r, n // d, dev, _compute_dtype(x, dev))
    return z.reshape(*lead, n // d)


def gather_blocks(z, mesh, axis_name="t"):
    """The whole last axis from every rank's block ``z``, on every rank."""
    parts = _comm.all_gather(z, group(mesh, axis_name))       # (D, ..., b)
    return parts.movedim(0, -2).flatten(-2)


def _run(x, mesh, axis_name, inverse):
    return _transform(_block(x, mesh, axis_name), mesh, axis_name, inverse)


def fft_sharded(x, mesh, axis_name="t", backend=None):
    """Distributed forward FFT along the last axis of ``x``.

    ``x``: real or complex NumPy array or tensor, batched over leading
    axes, the same on every rank; its last axis (length ``N``, a multiple
    of the ``D`` ranks along ``axis_name``) is split over them.  Returns
    ``(re, im)``: this rank's contiguous block ``[r*N/D, (r+1)*N/D)`` of
    the spectrum, tensors on its device.  ``backend`` is any of the JAX
    names; every one takes ``torch.fft`` for the local transforms.
    """
    y = _run(x, mesh, axis_name, inverse=False)
    return y.real, y.imag


def ifft_sharded(x, mesh, axis_name="t", backend=None):
    """Distributed inverse FFT (1/N normalized) along the last axis; the
    contract of :func:`fft_sharded`."""
    y = _run(x, mesh, axis_name, inverse=True)
    return y.real, y.imag


def rfft_sharded(x, mesh, axis_name="t", backend=None):
    """Distributed real-input FFT: the ``n//2 + 1`` non-negative bins.

    Runs the full distributed transform and returns the sliced half
    spectrum as NumPy ``(re, im)`` on every rank (the half spectrum no
    longer tiles evenly over the mesh, so it is gathered).
    """
    n = x.shape[-1]
    y = gather_blocks(_run(x, mesh, axis_name, inverse=False), mesh,
                      axis_name)
    ri = torch.view_as_real(y[..., :n // 2 + 1]).cpu().numpy()
    return ri[..., 0], ri[..., 1]


def irfft_sharded(re, im, n, mesh, axis_name="t", backend=None):
    """Distributed inverse of :func:`rfft_sharded` (length-``n`` real out,
    NumPy on every rank).

    The Hermitian extension of the ``n//2 + 1``-bin input happens on the
    host (NumPy), the ``n``-point inverse transform runs distributed.
    Matches ``numpy.fft.irfft`` semantics including zero-padding of short
    inputs (reference ``fft_analysis.py:548``).
    """
    re = np.array(re, dtype=np.float64)
    im = np.array(im, dtype=np.float64)
    need = n // 2 + 1
    if re.shape[-1] < need:
        pad = [(0, 0)] * (re.ndim - 1) + [(0, need - re.shape[-1])]
        re = np.pad(re, pad)
        im = np.pad(im, pad)
    else:
        re = re[..., :need]
        im = im[..., :need]
    im[..., 0] = 0.0
    if n % 2 == 0:
        im[..., -1] = 0.0
    body = slice(1, need - 1) if n % 2 == 0 else slice(1, need)
    full = np.concatenate([re + 1j * im,
                           (re[..., body] - 1j * im[..., body])[..., ::-1]],
                          axis=-1)
    y = gather_blocks(_run(full, mesh, axis_name, inverse=True), mesh,
                      axis_name)
    return y.real.cpu().numpy()


def axis_swap(x, mesh, axis_name, sharded_axis, target_axis):
    """Ulysses-style re-shard: the rank's block of ``x`` (NumPy or a
    tensor, the same on every rank) along ``sharded_axis`` traded by one
    all-to-all for its block along ``target_axis``.

    Both axes must be divisible by the shard count.  Returns this rank's
    block, partitioned on ``target_axis`` (whole along every other axis),
    as a tensor on its device; values are unchanged.
    """
    d, r, grp, dev = _line(mesh, axis_name)
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    sharded_axis %= x.dim()
    target_axis %= x.dim()
    if x.shape[sharded_axis] % d or x.shape[target_axis] % d:
        raise ValueError(
            f"axes {x.shape[sharded_axis]}, {x.shape[target_axis]} must both "
            f"divide by {d} shards")
    b = x.shape[sharded_axis] // d
    xb = x.narrow(sharded_axis, r * b, b).to(dev)
    if sharded_axis == target_axis:
        return xb
    with _comm.step("all_to_all", dev):
        return _comm.all_to_all(xb, grp, target_axis, sharded_axis)


@lru_cache(maxsize=2)
def _mask_block(n, d, r, device, dtype):
    """Rank ``r``'s block of :func:`~pyfft_tpu_torch.hilbert.analytic_mask`
    on ``device`` (the two latest stay cached)."""
    from ..hilbert import analytic_mask
    b = n // d
    return torch.as_tensor(analytic_mask(n)[r * b:(r + 1) * b],
                           device=device).to(dtype)


def analytic_block(x, mesh, axis_name="t", n=None):
    """This rank's block of the analytic signal of ``x`` along its last
    axis (zero-padded or trimmed to ``n``), complex, on its device: the
    distributed forward transform, the mask on the rank's frequency block,
    the distributed inverse."""
    y = _transform(_block(x, mesh, axis_name, n), mesh, axis_name, False)
    d, r, _, _ = _line(mesh, axis_name)
    with _comm.step("twiddle", y.device):
        y = y * _mask_block(y.shape[-1] * d, d, r, y.device, y.real.dtype)
    return _transform(y, mesh, axis_name, inverse=True)


def hilbert_sharded(x, mesh, axis_name="t", backend=None):
    """Distributed analytic signal ``x + j H[x]`` along the last axis.

    The reference's Hilbert transform (``hilbert.py:22-67``) at beyond-
    one-card lengths: distributed forward FFT (four-step, or Bluestein
    when ``d^2 !| N``), the analytic spectral mask applied elementwise on
    the contiguous frequency blocks where they lie (no gather), then the
    distributed inverse.  Returns ``(zr, zi)``: this rank's block of the
    output axis, tensors on its device.
    """
    z = analytic_block(x, mesh, axis_name)
    return z.real, z.imag
