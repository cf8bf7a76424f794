"""Kernel G's unit plan (``pyfft_tpu_torch/csrc/probe.cu``) in float32 on
the CPU against ``ops.probe.chain_plain`` and the JAX probe's math.

The CUDA kernel runs only on the card; this emulation follows its plan:
each of a block's two warpgroups walks the (group, 64-column) units ``u =
2 block + wg, u + 2 grid, ...``, the unit's row of ``part`` ``u // ncol``
(row block ``b``, group ``g``) and its column slice ``u % ncol``; columns
past ``N`` are zero-filled and stay zero; a column's sum over the unit's
128 rows of the last pass is taken by the four lanes of a quad, lane ``q``
adding rows ``16 kb + 2q, 16 kb + 2q + 1, 16 kb + 2q + 8, 16 kb + 2q + 9``
for ``kb = 0..7`` in order, then ``(s0 + s1) + (s2 + s3)``;
``sum_partials`` adds the rows of ``part`` in order in float64.  With
``probe.two_tap_T`` every order of the float32 sums gives the same chain,
so the plan must agree with the plain version to the order of the final
column sums (1e-6 of the largest).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfft_tpu_torch.ops import probe

CHAIN_TOL = 1e-4   # kernel G against chain_plain on order-free inputs


def _quad_rows():
    """The rows each lane q of a quad adds, in its order."""
    return [[16 * kb + 2 * q + e for kb in range(8) for e in (0, 1, 8, 9)]
            for q in range(4)]


def _emulate(x, T, rows_blk, passes, resident, grid):
    """Kernel G's plan in float32: the result (1, N) and how many times each
    unit was taken.  The units' arithmetic is batched in the walk's order
    (no unit's result depends on another's)."""
    nrows, N = x.shape
    ncol = -(-N // 64)
    groups = rows_blk // 128
    nparts = nrows // 128
    nunits = nparts * ncol
    walk = [u for block in range(grid) for wg in range(2)
            for u in range(2 * block + wg, nunits, 2 * grid)]
    taken = np.bincount(walk, minlength=nunits)
    xpad = torch.zeros(nrows, ncol * 64)
    xpad[:, :N] = x                              # the zero fill
    units = []
    for u in walk:
        p, cu = divmod(u, ncol)
        row0 = (0 if resident else p // groups) * rows_blk \
            + (p % groups) * 128
        units.append(xpad[row0:row0 + 128, cu * 64:(cu + 1) * 64])
    y = torch.stack(units).to(torch.bfloat16)
    for _ in range(passes):
        y = torch.matmul(T.float(), y.float()).to(torch.bfloat16)
    yf = y.float()
    s = []
    for rows in _quad_rows():
        acc = torch.zeros(len(walk), 64)
        for r in rows:
            acc = acc + yf[:, r]
        s.append(acc)
    sums = (s[0] + s[1]) + (s[2] + s[3])
    part = torch.full((nparts, N), float("nan"))
    for i, u in enumerate(walk):
        p, cu = divmod(u, ncol)
        w = min(64, N - cu * 64)
        assert not yf[i, :, w:].any()            # and stays zero
        part[p, cu * 64:cu * 64 + w] = sums[i, :w]
    out = torch.zeros(N, dtype=torch.float64)
    for p in range(nparts):
        out = out + part[p].double()
    return out.float().reshape(1, N), taken


def _jax_chain(x, T, rows_blk, passes, resident):
    """The JAX probe's math (``pyfft_tpu/utils/profiling.py:234-242``)
    over the row blocks, as its grid adds them."""
    Tj = jnp.asarray(T.float().numpy(), jnp.bfloat16)
    xb = x.numpy().reshape(-1, rows_blk, x.shape[1])
    acc = 0
    for b in range(xb.shape[0]):
        blk = jnp.asarray(xb[0 if resident else b])
        total = jnp.zeros((128, blk.shape[1]), jnp.float32)
        for g in range(rows_blk // 128):
            y = blk[g * 128:(g + 1) * 128].astype(jnp.bfloat16)
            for _ in range(passes):
                y = jnp.dot(Tj, y, preferred_element_type=jnp.float32
                            ).astype(jnp.bfloat16)
            total = total + y.astype(jnp.float32)
        acc = acc + np.asarray(jnp.sum(total, axis=0, keepdims=True))
    return acc


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("passes,resident", [(0, False), (1, False),
                                             (12, False), (3, True)])
@pytest.mark.parametrize("nrows,N,rows_blk", [(512, 200, 128),
                                              (512, 1000, 256),
                                              (256, 100, 256), (384, 4, 128),
                                              (256, 97, 128)])
def test_unit_plan_matches_chain_plain(nrows, N, rows_blk, passes, resident,
                                       grid):
    rng = np.random.default_rng(N)
    x = torch.as_tensor(rng.standard_normal((nrows, N)), dtype=torch.float32)
    T = probe.two_tap_T(N)
    got, taken = _emulate(x, T, rows_blk, passes, resident, grid)
    assert (taken == 1).all()
    ref = probe.chain_plain(x, T, rows_blk, passes, resident)
    assert got.shape == ref.shape == (1, N)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-6 * scale
    jref = _jax_chain(x, T, rows_blk, passes, resident)
    assert np.abs(got.numpy() - jref).max() <= 1e-6 * scale


@pytest.mark.parametrize("nrows,N,rows_blk", [(4096, 1152, 512),
                                              (1024, 100, 256),
                                              (2048, 4, 1024),
                                              (1024, 200, 128),
                                              (1024, 1000, 128)])
def test_two_tap_chain_is_order_free_and_needs_rerounding(nrows, N,
                                                          rows_blk):
    """At the card test's shapes: the chain on ``two_tap_T`` is the same in
    float64 as in float32 accumulation, and leaving out the bf16
    re-rounding moves it by more than ten times ``CHAIN_TOL`` at the
    probe's 12 passes (five times at one pass, where 4 columns give
    8e-4)."""
    rng = np.random.default_rng(N)
    x = torch.as_tensor(rng.standard_normal((nrows, N)), dtype=torch.float32)
    T = probe.two_tap_T(N)
    for passes, margin in ((1, 5), (12, 10)):
        y32 = x.reshape(-1, 128, N).to(torch.bfloat16)
        y64, ctl = y32, y32.float()
        for _ in range(passes):
            y32 = torch.matmul(T.float(), y32.float()).to(torch.bfloat16)
            y64 = torch.matmul(T.double(), y64.double()).to(torch.bfloat16)
            ctl = torch.matmul(T.float(), ctl)
        assert torch.equal(y32, y64)
        ref = probe.chain_plain(x, T, rows_blk, passes)
        err = ((ctl.sum(dim=(0, 1)) - ref[0]).abs().max()
               / ref.abs().max()).item()
        assert err > margin * CHAIN_TOL


def test_quads_cover_the_rows_once():
    rows = sorted(r for q in _quad_rows() for r in q)
    assert rows == list(range(128))


def test_two_tap_T_has_two_halves_a_row_and_a_column():
    T = probe.two_tap_T(7).float()
    assert T.dtype == torch.float32 and T.shape == (128, 128)
    assert ((T == 0.5).sum(1) == 2).all() and ((T == 0.5).sum(0) == 2).all()
    assert int((T != 0).sum()) == 256
    assert not torch.equal(T, probe.two_tap_T(8).float())
