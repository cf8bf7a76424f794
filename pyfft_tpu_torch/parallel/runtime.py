"""Multi-process runtime on ``torch.distributed``.

Counterpart of :mod:`pyfft_tpu.parallel.runtime` (the Welch half): one
process per device, a process group joining them, meshes over its ranks.

- :func:`init_distributed`: idempotent start of the default process group,
  NCCL on the card and gloo where the CPU is asked for;
- :func:`make_host_mesh`: the ``('host', 'ch', 't')`` mesh, hosts
  outermost, so the time axis' halos and sums stay inside a host;
- :func:`scaling_report`: axis sizes and the collective -> link mapping;
- :func:`measure_scaling`: Welch throughput over sub-meshes of the world;
- :func:`audit_collectives`: the collectives a call issued on this rank,
  with their payloads.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import resolve_device
from ._comm import recording
from .mesh import axis_size, make_mesh

__all__ = ["init_distributed", "make_host_mesh", "scaling_report",
           "measure_scaling", "audit_collectives", "recording"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None, timeout=None):
    """Start the default process group (idempotent: a no-op once one
    exists).

    The backend is NCCL for the card and gloo where ``device`` (resolved by
    :func:`~pyfft_tpu_torch.config.resolve_device`) is the CPU.  With no
    arguments and no ``WORLD_SIZE`` in the environment, a single process
    gets a one-rank group (the JAX package's no-op gives one device).
    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means TCP) with
    ``num_processes`` and ``process_id``; without it, ``WORLD_SIZE``,
    ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` in the environment (as a
    launcher sets them) are read.  On the card each process takes CUDA
    device ``rank % device_count``.  ``timeout`` (seconds) bounds every
    collective.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" in os.environ:
            rank = int(os.environ["RANK"])
            kw.update(init_method="env://")
        else:
            rank = 0
            kw.update(store=dist.HashStore(), rank=0, world_size=1)
    else:
        rank = int(process_id)
        url = coordinator_address
        if "://" not in url:
            url = "tcp://" + url
        kw.update(init_method=url, rank=rank, world_size=int(num_processes))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)


def _local_world(dev):
    """Processes a host: ``LOCAL_WORLD_SIZE`` where a launcher sets it,
    else one a card (at most the world), else the whole world."""
    world = dist.get_world_size()
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if dev.type == "cuda":
        return min(world, torch.cuda.device_count())
    return world


def make_host_mesh(ch=1, t=None, device=None):
    """``('host', 'ch', 't')`` mesh: hosts outermost (the network), ``ch``
    and ``t`` within a host (NVLink).  ``t`` defaults to all remaining
    ranks of a host."""
    dev = resolve_device(device)
    init_distributed(device=dev)
    world = dist.get_world_size()
    per_host = _local_world(dev)
    if world % per_host:
        raise ValueError(f"world of {world} not divisible by {per_host} "
                         "processes a host")
    if t is None:
        t = per_host // ch
    if ch * t != per_host:
        raise ValueError(f"ch*t = {ch * t} != {per_host} devices per host")
    ranks = np.arange(world).reshape(world // per_host, ch, t)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("host", "ch", "t"))


def scaling_report(mesh, measure=False, **measure_kw):
    """Axis sizes, the collective -> link mapping, and (optionally) a
    *measured* scaling table from :func:`measure_scaling`."""
    sizes = {n: axis_size(mesh, n) for n in mesh.mesh_dim_names}
    link = ("NVLink/NCCL" if mesh.device_type == "cuda"
            else f"gloo ({mesh.device_type})")
    inner = {n: f"{link} ('{n}')" for n in ("t", "ch") if n in sizes}
    rep = {
        "axes": sizes,
        "devices": int(np.prod(list(sizes.values()))),
        "collectives": {
            "all_reduce(welch average)": inner.get("t", "n/a"),
            "isend/irecv(segment/FIR halo)": inner.get("t", "n/a"),
            "all_gather(final spectra)": ("network ('host')"
                                          if "host" in sizes
                                          else inner.get("ch", "n/a")),
        },
    }
    if measure:
        rep["measured"] = measure_scaling(**measure_kw)
    return rep


def measure_scaling(nt=1 << 20, nch=4, nwins=1024, iters=5, shard_counts=None,
                    fft_backend=None, device=None):
    """Measure Welch throughput against the time-shard count; returns an
    efficiency table.

    Runs :func:`~pyfft_tpu_torch.parallel.welch_psd_sharded` on ``('ch'=1,
    't'=d)`` meshes over ranks ``0 .. d-1`` for each ``d`` in
    ``shard_counts`` (default: the powers of two up to the world size) and
    reports samples/s and the efficiency against linear scaling from the
    smallest count.  Every rank of the world calls it (the sub-meshes are
    built by all of them); rank 0, in every sub-mesh, times the calls and
    every rank returns its table.  On CPU processes sharing cores the
    efficiency only checks the harness; quote numbers from runs on cards.
    """
    from .. import segmentation as seg
    from .welch import welch_psd_sharded

    dev = resolve_device(device)
    init_distributed(device=dev)
    world = dist.get_world_size()
    if shard_counts is None:
        shard_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(nt).astype(np.float32)
    y = rng.standard_normal((nch, nt)).astype(np.float32)
    plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=0.5)
    win = np.hanning(nwins + 1)[:-1].astype(np.float32)

    rows = []
    for d in shard_counts:
        mesh = make_mesh(ch=1, t=d, devices=range(d), device=dev)
        if mesh.get_coordinate() is not None:
            welch_psd_sharded(x, y, win, plan, 1e6, mesh,
                              fft_backend=fft_backend)        # warm-up
            t0 = time.perf_counter()
            for _ in range(iters):
                welch_psd_sharded(x, y, win, plan, 1e6, mesh,
                                  fft_backend=fft_backend)
            dt = (time.perf_counter() - t0) / iters
            rows.append({"t_shards": d, "samples_per_s": nch * nt / dt,
                         "wall_s": dt})
    box = [rows]
    dist.broadcast_object_list(box, src=0)
    rows = box[0]
    base = rows[0]
    for r in rows:
        ideal = base["samples_per_s"] * (r["t_shards"] / base["t_shards"])
        r["efficiency"] = round(r["samples_per_s"] / ideal, 3)
    return rows


def audit_collectives(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` and return the collectives it issued on this
    rank: rows ``{'op', 'shapes', 'bytes'}`` under the HLO names of the JAX
    package's audit (``all-reduce``, ``collective-permute``,
    ``all-gather``), in issue order.

    The JAX package's ``audit_collectives(compiled_text)`` parses a
    compiled HLO module.  The port compiles none, so its mesh functions
    record each collective as they issue it (:mod:`._comm`) and this takes
    the call itself: the rows then count what ran, not what a compiler
    planned, and a group of one rank issues none.
    """
    with recording() as rec:
        fn(*args, **kw)
    return rec.rows

