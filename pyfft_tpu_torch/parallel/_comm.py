"""The collectives of the mesh tier, and what a run of them records.

Every collective the port's mesh functions issue goes through this module,
on one group of a :class:`~torch.distributed.device_mesh.DeviceMesh` (the
``'t'`` or ``'ch'`` axis):

- :func:`all_reduce` (sum): the global detrend moments and the Welch
  segment sums;
- :func:`halo`: the neighbour exchange of the segment and FIR halos, one
  ``dist.batch_isend_irecv`` on the axis;
- :func:`all_gather`: the results, stacked along a new leading axis in
  group-rank order;
- :func:`all_to_all`: the four-step FFT's transposes, one axis' equal
  chunks traded for another's (``lax.all_to_all(..., tiled=True)``);
- :func:`all_to_all_v`: the distributed Bluestein's re-blocking between the
  length-``N`` and the length-``M`` layouts, pieces of any size along the
  last axis.

Every rank of a group issues the same collectives in the same order,
whatever its share of the work: a rank that skips one hangs the group.  A
group of one rank runs its all-reduces and all-gathers too (a one-rank
NCCL group on a single card runs the whole path); a halo there has no
neighbour and issues nothing.  Complex tensors travel as
``torch.view_as_real``; ``dist.all_to_all_single`` trades equal (or the
given) chunks of dimension 0 of a contiguous tensor, so the all-to-alls
move the split axis to the front and copy first.

Inside :func:`recording`, each collective adds one row ``{'op', 'shapes',
'bytes'}`` under the HLO name the JAX package's audit reports
(``all-reduce``, ``collective-permute``, ``all-gather``, ``all-to-all``):
the payload of the exchange (an all-gather's or all-to-all's whole
result), as
``pyfft_tpu.parallel.runtime.audit_collectives`` reads it from a result
shape.  :func:`step` also times the named steps of a call there, with the
device synchronised at each end; outside :func:`recording` nothing is
recorded or synchronised.
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

_HLO = {torch.float64: "f64", torch.float32: "f32", torch.complex64: "c64",
        torch.complex128: "c128", torch.int64: "s64", torch.int32: "s32"}


class Recorder:
    """What :func:`recording` collects: ``rows`` (the collectives, in
    issue order) and ``wall`` (seconds a named step, summed)."""

    def __init__(self):
        self.rows = []
        self.wall = {}


_active: Recorder | None = None


@contextlib.contextmanager
def recording():
    """Record this rank's collectives and step times while the block runs;
    yields the :class:`Recorder`."""
    global _active
    prev, _active = _active, Recorder()
    try:
        yield _active
    finally:
        _active = prev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def step(name, device):
    """Add the block's wall time to ``wall[name]`` of the active recorder."""
    rec = _active
    if rec is None:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        rec.wall[name] = rec.wall.get(name, 0.0) + time.perf_counter() - t0


def _log(op, t):
    if _active is not None:
        dims = ",".join(str(n) for n in t.shape)
        _active.rows.append({"op": op, "shapes": [f"{_HLO[t.dtype]}[{dims}]"],
                             "bytes": int(t.numel() * t.element_size())})


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce(t, group):
    """Sum the contiguous tensor ``t`` over ``group`` in place; returns
    it."""
    dist.all_reduce(_real(t), group=group)
    _log("all-reduce", t)
    return t


def halo(v, n, group, *, from_right):
    """The ``n`` samples along the last axis of ``v`` that border this
    rank's block: the first ``n`` of the next rank's (``from_right``) or
    the last ``n`` of the previous rank's; None where there is no such
    rank (the axis' ends, a group of one), whose samples no output
    reads."""
    size = dist.get_world_size(group)
    if size == 1 or n == 0:
        return None
    me = dist.get_rank(group)
    send = (v[..., :n] if from_right else v[..., v.shape[-1] - n:])
    send = send.contiguous()
    to, frm = (me - 1, me + 1) if from_right else (me + 1, me - 1)
    recv, ops = None, []
    if 0 <= to < size:
        ops.append(dist.P2POp(dist.isend, _real(send),
                              dist.get_global_rank(group, to), group))
    if 0 <= frm < size:
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.irecv, _real(recv),
                              dist.get_global_rank(group, frm), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _log("collective-permute", send)
    return recv


def all_gather(t, group):
    """``t`` of every rank of ``group``, stacked along a new leading axis
    in group-rank order."""
    size = dist.get_world_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather([_real(p) for p in parts], _real(t), group=group)
    out = torch.stack(parts)
    _log("all-gather", out)
    return out


def all_to_all(t, group, split_axis, concat_axis):
    """``t``'s ``split_axis`` cut into equal chunks, one a rank of
    ``group`` (chunk ``j`` to group rank ``j``); returns the chunks received,
    joined along ``concat_axis`` in group-rank order (``lax.all_to_all``
    with ``tiled=True``)."""
    size = dist.get_world_size(group)
    split_axis %= t.dim()
    n = t.shape[split_axis]
    if n % size:
        raise ValueError(f"axis of {n} does not split into {size} chunks")
    send = t.unflatten(split_axis, (size, n // size)).movedim(split_axis, 0)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(_real(recv), _real(send), group=group)
    concat_axis %= t.dim()
    out = recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)
    _log("all-to-all", out)
    return out


def all_to_all_v(t, group, send, recv):
    """Pieces of any size along the last axis of ``t``: its first
    ``send[0]`` samples to group rank 0, the next ``send[1]`` to rank 1, and
    so on; returns the ``recv[i]`` samples from each rank ``i``, joined in
    group-rank order."""
    src = t[..., :sum(send)].movedim(-1, 0).contiguous()
    dst = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(_real(dst), _real(src), list(recv), list(send),
                           group=group)
    out = dst.movedim(0, -1)
    _log("all-to-all", out)
    return out
