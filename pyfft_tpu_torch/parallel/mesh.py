"""Device-mesh construction on ``torch.distributed``.

Counterpart of :mod:`pyfft_tpu.parallel.mesh`.  The scaling model is the
JAX package's: a 2-D logical mesh with a channel axis (``'ch'``, channels
processed independently) and a time axis (``'t'``, each rank a contiguous
time block with a halo exchange).  Welch sums reduce over ``'t'``, segment
and FIR halos move along ``'t'``, results gather over both.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, one process per device (SPMD): every
rank calls the mesh functions with the same global inputs and returns the
same result.  Rank ``r`` sits at ``(r // t, r % t)``, the row-major order
of the JAX package's ``devices.reshape(ch, t)``, so both packages put the
same shard on the same mesh coordinate.  ``Mesh`` is ``DeviceMesh``; the
JAX package's ``shard_map``, ``P`` and ``NamedSharding`` are JAX's own
sharding API and have no counterpart.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import resolve_device

Mesh = DeviceMesh

__all__ = ["make_mesh", "Mesh", "device_counts"]


def device_counts():
    """The world size of the default process group where one exists, else
    the number of CUDA devices."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()


def make_mesh(ch: int = 1, t: int | None = None, devices=None,
              device=None) -> Mesh:
    """Build a ``('ch', 't')`` mesh over the ranks of the world.

    ``devices`` are global ranks (default: all of them); the mesh takes the
    first ``ch * t``.  ``t`` defaults to ``len(devices) // ch``.  The mesh
    lies on ``device``'s type (:func:`~pyfft_tpu_torch.config.resolve_device`:
    the card unless the CPU is asked for); without a process group a
    one-rank group is started first (:func:`.runtime.init_distributed`),
    so a single process gets a valid 1x1 mesh.  Every rank of the world
    calls this, also one outside the mesh (it sits at no coordinate).
    """
    from .runtime import init_distributed
    dev = resolve_device(device)
    init_distributed(device=dev)
    if devices is None:
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if t is None:
        if n % ch:
            raise ValueError(f"{n} devices not divisible by ch={ch}")
        t = n // ch
    if ch * t > n:
        raise ValueError(f"mesh {ch}x{t} needs {ch * t} devices, have {n}")
    ranks = np.asarray(devices[:ch * t]).reshape(ch, t)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("ch", "t"))


def axis_size(mesh, name):
    """The number of ranks along the mesh axis ``name`` (1 if absent)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def coordinate(mesh, name):
    """This rank's index along the mesh axis ``name`` (0 if absent); raises
    on a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    names = mesh.mesh_dim_names
    return coord[names.index(name)] if name in names else 0


def group(mesh, name):
    """The process group of this rank's line along the mesh axis
    ``name``."""
    return mesh.get_group(name)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on for ``mesh``: its current CUDA
    device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
