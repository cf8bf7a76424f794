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
  with their payloads;
- :func:`project_scaling`, :func:`project_scaling_paths`: the modelled
  multi-host scaling efficiency of the Welch + FIR chain, the sharded STFT
  and the four-step FFT, from the collectives those paths issue and book
  link rates.
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
           "measure_scaling", "audit_collectives", "project_scaling",
           "project_scaling_paths", "recording"]

# The port's own single-card rates, the default compute rates of the
# scaling projections.  Taken by chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# a 700.00 W power limit, torch 2.11.0+cu128 (PERF.md section 6, "PR 17 -
# the projections' rates").
# Phase 4: welch_filtered_cross_spectra on config 0 (8 channels of 2**25
# samples with the 129-tap band-pass, kernel B), 9.153876 ms to NumPy.
H100_CONFIG0_SAMPLES_PER_S = 8 * 2 ** 25 / 9.153876e-3
# Phase 7: fftanal(...).pwelch() on config 2 (a 2**24-sample chirp, nwins
# 2048, kernel C), 0.990523 s to NumPy.
H100_CONFIG2_SAMPLES_PER_S = 2 ** 24 / 0.990523
# Phase 13: kernel F's streaming read of 65536 x 1152 float32, GB/s.
H100_READ_GBS = 1901.0


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
            "all_to_all(four-step FFT)": inner.get("t", "n/a"),
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



def _sum_bytes(rows, *ops, exclude=False):
    return sum(r["bytes"] for r in rows if (r["op"] in ops) != exclude)


def _projection_mesh(hosts, chips_per_host, device):
    """``(mesh, audit)``: the ``('ch'=1, 't'=hosts*chips_per_host)`` mesh
    over ranks ``0 ..`` of the world, and ``audit(fn, *args, **kw)``, which
    runs ``fn`` on the ranks of the mesh and gives every rank rank 0's
    :func:`audit_collectives` rows.  Every rank of the world calls it;
    raises where the world is smaller than the mesh."""
    dev = resolve_device(device)
    init_distributed(device=dev)
    ndev = hosts * chips_per_host
    if dist.get_world_size() < ndev:
        raise RuntimeError(
            f"projection needs {ndev} ranks, the world has "
            f"{dist.get_world_size()}; start at least {ndev} processes")
    mesh = make_mesh(ch=1, t=ndev, devices=range(ndev), device=dev)
    inside = mesh.get_coordinate() is not None

    def rows(fn, *args, **kw):
        box = [audit_collectives(fn, *args, **kw) if inside else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    return mesh, rows


def project_scaling(nt=1 << 24, nch=8, nwins=4096, windowoverlap=0.5,
                    ntaps=129, hosts=2, chips_per_host=4,
                    per_chip_samples_per_s=None, kind=None,
                    fft_backend="mxu", device=None):
    """Projected ``hosts``-host scaling efficiency for the Welch+FIR chain.

    The collectives are the rows :func:`audit_collectives` records from
    running the sharded Welch and the sharded FIR on zeros of the given
    shapes over the ``hosts * chips_per_host`` ranks ``0 ..`` of the world
    (every rank of the world calls this, as :func:`measure_scaling`; a
    smaller world raises); rank 0's rows are modelled against the book link
    rates (:func:`pyfft_tpu_torch.utils.profiling.interconnect_peaks` of
    ``kind``, default the current card, the H100 on a world without one):

    - ``collective-permute`` (segment/FIR halo): all neighbour pairs
      transfer in parallel; the host-boundary pair rides the network and
      sets the critical path -> ``t = bytes / BW_net``;
    - ``all-reduce`` (Welch sums): hierarchical ring, intra-host over NVLink
      (``2 B (L-1)/L / BW_nvlink``) plus the inter-host exchange over the
      network (``2 B (H-1)/H / BW_net``);
    - every other collective (the result gathers, which the port's mesh
      functions issue to return the whole result on every rank) over the
      network;
    - compute time per card from the measured single-card throughput
      (``per_chip_samples_per_s``; default the port's config-0 rate,
      ``H100_CONFIG0_SAMPLES_PER_S``).

    Efficiency bounds: ``no_overlap = Tc / (Tc + sum(Tcomm))`` (every
    collective exposed) and ``overlapped = Tc / max(Tc, Tcomm)``.  Returns
    the full model as a dict, the JAX function's keys, on every rank.
    """
    from .. import segmentation as seg
    from ..utils.profiling import interconnect_peaks, link_kind
    from .fir import fir_filter_sharded
    from .welch import welch_psd_sharded

    mesh, audit = _projection_mesh(hosts, chips_per_host, device)
    ndev = hosts * chips_per_host
    if per_chip_samples_per_s is None:
        per_chip_samples_per_s = H100_CONFIG0_SAMPLES_PER_S
    plan = seg.plan_segments(nt, nwins=nwins, windowoverlap=windowoverlap)
    win = np.hanning(nwins + 1)[:-1].astype(np.float32)
    x = np.zeros(nt, np.float32)
    y = np.zeros((nch, nt), np.float32)
    rows = (audit(welch_psd_sharded, x, y, win, plan, 1.0, mesh,
                  fft_backend=fft_backend)
            + audit(fir_filter_sharded, y, np.zeros(ntaps), mesh))
    kind = link_kind(kind)
    ici, dcn = interconnect_peaks(kind)
    halo_bytes = _sum_bytes(rows, "collective-permute")
    psum_bytes = _sum_bytes(rows, "all-reduce")
    other_bytes = _sum_bytes(rows, "collective-permute", "all-reduce",
                             exclude=True)

    L, Hn = chips_per_host, hosts
    t_halo = halo_bytes / (dcn * 1e9)
    t_psum = (2 * psum_bytes * (L - 1) / L / (ici * 1e9)
              + 2 * psum_bytes * (Hn - 1) / Hn / (dcn * 1e9))
    t_other = other_bytes / (dcn * 1e9)
    t_comm = t_halo + t_psum + t_other
    t_compute = (nch * nt / ndev) / per_chip_samples_per_s

    return {
        "workload": {"nt": nt, "nch": nch, "nwins": nwins,
                     "noverlap": plan.noverlap, "navr": plan.navr,
                     "ntaps": ntaps},
        "mesh": {"hosts": hosts, "chips_per_host": chips_per_host,
                 "t_shards": ndev},
        "collectives": rows,
        "bytes": {"halo_ppermute": halo_bytes, "psum_allreduce": psum_bytes,
                  "other": other_bytes},
        "link_gbs": {"ici_per_link": ici, "dcn_per_host": dcn,
                     "kind": kind},
        "times_s": {"compute_per_chip": t_compute, "halo": t_halo,
                    "psum": t_psum, "other": t_other, "comm_total": t_comm},
        "per_chip_samples_per_s": per_chip_samples_per_s,
        "efficiency": {
            "no_overlap": t_compute / (t_compute + t_comm),
            "overlapped": t_compute / max(t_compute, t_comm),
        },
        "dcn_sensitivity": _dcn_band(t_compute,
                                     {"halo": halo_bytes,
                                      "other": other_bytes},
                                     psum_bytes, chips_per_host, hosts,
                                     ici, dcn),
    }


def _dcn_band(t_compute, dcn_bytes, psum_bytes, L, Hn, ici, dcn,
              factors=(0.5, 1.0, 2.0)):
    """No-overlap efficiency at ``dcn * factor`` for each factor: the
    sensitivity band the projection quotes (the network rate is the
    softest number in the model; halving it bounds the worst case)."""
    band = {}
    for f in factors:
        d_eff = dcn * f
        t_d = sum(dcn_bytes.values()) / (d_eff * 1e9)
        t_p = (2 * psum_bytes * (L - 1) / L / (ici * 1e9)
               + 2 * psum_bytes * (Hn - 1) / Hn / (d_eff * 1e9))
        band[f"dcn_x{f:g}"] = round(
            t_compute / (t_compute + t_d + t_p), 4)
    return band


def project_scaling_paths(nt=1 << 24, nch=8, nwins=4096, windowoverlap=0.5,
                          ntaps=129, hosts=2, chips_per_host=4,
                          kind=None, fft_backend="mxu",
                          stft_nwins=2048, fft_n=None, device=None):
    """Per-path multi-host scaling projection: the Welch+FIR chain (the
    headline, :func:`project_scaling`), the sharded STFT (large per-segment
    output -> result-gather pressure), and the four-step FFT (three
    all-to-all rounds, the worst collective pattern in the framework).

    Each row carries the audited collective bytes (rank 0's, from running
    the path on zeros over the projection's ranks), the modelled
    communication time, a no-overlap efficiency, and a network bandwidth
    sensitivity band (x0.5 / x1 / x2).  Compute-time models per path:

    - STFT: the port's measured single-card config-2 rate
      (``H100_CONFIG2_SAMPLES_PER_S``); communication adds the final
      gather of the (navr, nfreq) complex64 result, of which the remote
      hosts' share crosses the network (the port's rows already hold its
      own all-gather of the tiles, so the gather counts twice);
    - four-step FFT: local work modelled as 10 device-memory passes of the
      per-card shard (two local FFT stages, the twiddle, the layout swaps)
      at the port's measured streaming read rate (``H100_READ_GBS``, kernel
      F); each of the three all-to-alls moves (d-1)/d of every card's
      shard, the inter-host fraction ((H-1)/H) through the host's network.
    """
    from .. import segmentation as seg
    from ..utils.profiling import interconnect_peaks
    from .fft import _fourstep_run, four_step_factor
    from .stft import stft_sharded

    ndev = hosts * chips_per_host
    out = {"chain": project_scaling(
        nt=nt, nch=nch, nwins=nwins, windowoverlap=windowoverlap,
        ntaps=ntaps, hosts=hosts, chips_per_host=chips_per_host,
        kind=kind, fft_backend=fft_backend, device=device)}
    mesh, audit = _projection_mesh(hosts, chips_per_host, device)
    ici, dcn = interconnect_peaks(out["chain"]["link_gbs"]["kind"])
    L, Hn = chips_per_host, hosts

    # ---- sharded STFT ----
    plan2 = seg.plan_segments(nt, nwins=stft_nwins,
                              windowoverlap=windowoverlap)
    win2 = np.hanning(stft_nwins + 1)[:-1]
    srows = audit(stft_sharded, np.zeros(nt, np.float32), np.zeros(nt), win2,
                  plan2, 1.0, mesh, fft_backend=fft_backend)
    s_halo = _sum_bytes(srows, "collective-permute")
    s_psum = _sum_bytes(srows, "all-reduce")
    s_other = _sum_bytes(srows, "collective-permute", "all-reduce",
                         exclude=True)
    result_bytes = 8.0 * plan2.navr * plan2.nnyquist     # complex64, global
    gather_dcn = result_bytes * (Hn - 1) / Hn            # remote hosts' share
    rate2 = H100_CONFIG2_SAMPLES_PER_S
    t_c2 = (nt / ndev) / rate2
    t_comm2 = (s_halo + s_other + gather_dcn) / (dcn * 1e9) + \
        (2 * s_psum * (L - 1) / L / (ici * 1e9)
         + 2 * s_psum * (Hn - 1) / Hn / (dcn * 1e9))
    out["stft"] = {
        "workload": {"nt": nt, "nwins": stft_nwins, "navr": plan2.navr,
                     "nfreq": plan2.nnyquist},
        "collectives": srows,
        "bytes": {"halo_ppermute": s_halo, "psum_allreduce": s_psum,
                  "other": s_other, "result_gather": int(result_bytes),
                  "result_gather_dcn": int(gather_dcn)},
        "times_s": {"compute_per_chip": t_c2, "comm_total": t_comm2},
        "per_chip_samples_per_s": rate2,
        "efficiency": {
            "no_overlap": t_c2 / (t_c2 + t_comm2),
            # the same shard count on ONE host: every collective (and the
            # result assembly) rides NVLink
            "ici_only": t_c2 / (t_c2 + (s_halo + s_other + 2 * s_psum
                                        * (ndev - 1) / ndev
                                        + result_bytes * (ndev - 1) / ndev)
                                / (ici * 1e9)),
        },
        "dcn_sensitivity": _dcn_band(
            t_c2, {"halo": s_halo, "other": s_other + gather_dcn},
            s_psum, L, Hn, ici, dcn),
    }

    # ---- four-step distributed FFT ----
    if fft_n is None:
        fft_n = (nt // (ndev * ndev)) * ndev * ndev
    n1, n2 = four_step_factor(fft_n, ndev)
    dev = resolve_device(device)
    frows = audit(_fourstep_run, torch.zeros(fft_n // ndev, device=dev,
                                             dtype=torch.complex64), mesh)
    a2a_bytes = _sum_bytes(frows, "all-to-all")
    f_other = _sum_bytes(frows, "all-to-all", exclude=True)
    shard_bytes = 8.0 * fft_n / ndev                     # complex64 a card
    t_c3 = 10.0 * shard_bytes / (H100_READ_GBS * 1e9)
    # the inter-host share of each all-to-all rides the host's network
    a2a_dcn = a2a_bytes * (Hn - 1) / Hn * L              # a host
    t_comm3 = (a2a_dcn + f_other) / (dcn * 1e9)
    out["fft4step"] = {
        "workload": {"n": fft_n, "n1": n1, "n2": n2, "d": ndev},
        "collectives": frows,
        "bytes": {"all_to_all_per_device": a2a_bytes,
                  "all_to_all_dcn_per_host": int(a2a_dcn),
                  "other": f_other},
        "times_s": {"compute_per_chip": t_c3, "comm_total": t_comm3},
        "compute_model": "10 device-memory passes of the per-card shard at "
                         f"the measured {H100_READ_GBS} GB/s streaming read "
                         "rate (kernel F, NVIDIA H100 80GB HBM3, 700 W)",
        "efficiency": {
            "no_overlap": t_c3 / (t_c3 + t_comm3),
            # all-to-all entirely on NVLink (a single-host mesh): the
            # four-step transform is designed to run with d = cards a host
            "ici_only": t_c3 / (t_c3 + a2a_bytes * (ndev - 1) / ndev
                                / (ici * 1e9)),
        },
        "dcn_sensitivity": _dcn_band(
            t_c3, {"a2a": a2a_dcn, "other": f_other}, 0.0,
            L, Hn, ici, dcn),
    }
    return out
