"""Time-sharded causal FIR filtering with a halo exchange.

Counterpart of :mod:`pyfft_tpu.parallel.fir`.  The time axis is split over
the ``'t'`` mesh axis and the channels over ``'ch'``; each rank receives
the last ``ntaps - 1`` samples of its left neighbour (zeros at the global
left edge, as the zero-padded causal convolution has), filters its block
with that halo in front, and drops the first ``ntaps - 1`` outputs: what
is left is exactly its slice of the global causal convolution.  The blocks
are all-gathered over ``'t'`` and ``'ch'``.

The filter is the route :func:`pyfft_tpu_torch.filters._fir_filter` takes
on the card for the taps: kernel A (``csrc/fir.cu``, direct form, float32)
for up to 1024 taps on a CUDA tensor, its plain version on a CPU tensor in
the signal's dtype, overlap-save with ``torch.fft`` for longer filters.
The JAX package runs overlap-save on XLA's FFT here; kernel A is the
port's counterpart of its TPU FIR kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..filters import _fir_filter
from ..ops.fir import PALLAS_FIR_MAX_TAPS
from . import _comm
from .mesh import axis_size, coordinate, group, mesh_device
from .welch import local_block

__all__ = ["fir_filter_sharded"]


def fir_filter_sharded(x, taps, mesh, *, fft_backend=None, nfft=None):
    """Causal FIR filtering of ``x (nch, nt)`` (NumPy or a tensor, the same
    on every rank) distributed over the mesh.

    Equivalent to ``lfilter(taps, [1], x)`` / ``fir_filter``; returns the
    whole ``(nch, nt)`` NumPy result on every rank of the mesh.
    ``fft_backend`` and ``nfft`` are accepted for the JAX signature: the
    route depends on the taps alone (module docstring).
    """
    x = x if isinstance(x, torch.Tensor) else np.asarray(x)
    x = x.reshape(1, -1) if x.ndim == 1 else x
    taps = np.asarray(taps, dtype=np.float64)
    ntaps = len(taps)
    dt_shards, dch = axis_size(mesh, "t"), axis_size(mesh, "ch")
    nch, nt = x.shape
    if nt % dt_shards:
        raise ValueError(f"time axis {nt} not divisible by {dt_shards}")
    B = nt // dt_shards
    if ntaps - 1 > B:
        raise ValueError(f"taps {ntaps} exceed block {B}; fewer time shards")
    if nch % dch:
        raise ValueError(f"nch={nch} not divisible by ch shards")
    d, c = coordinate(mesh, "t"), coordinate(mesh, "ch")
    tgrp, chgrp = group(mesh, "t"), group(mesh, "ch")
    dev = mesh_device(mesh)
    nch_l = nch // dch

    with _comm.step("host", dev):
        v = local_block(x, slice(c * nch_l, (c + 1) * nch_l), d, B, dev)
    with _comm.step("halo", dev):
        h = _comm.halo(v, ntaps - 1, tgrp, from_right=False)
    with _comm.step("kernel", dev):
        backend = "pallas" if ntaps <= PALLAS_FIR_MAX_TAPS else "os"
        if h is None:                    # the global left edge: zeros
            out = _fir_filter(v, taps, backend=backend)
        else:
            out = _fir_filter(torch.cat([h, v], -1), taps,
                              backend=backend)[:, ntaps - 1:]
    with _comm.step("reductions", dev):
        rows = _comm.all_gather(out, tgrp)                # (t, nch_l, B)
        rows = rows.transpose(0, 1).reshape(nch_l, nt)
        rows = _comm.all_gather(rows, chgrp).reshape(nch, nt)
    with _comm.step("host", dev):
        return rows.cpu().numpy()
