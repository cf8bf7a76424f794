"""The general traffic generator.  A traffic mix is a JSON file of
parameters under ``traffic/``, found by its name:

- ``loop``: ``"closed"`` (a client sends its next call when the last one
  has returned its results) and ``clients``: how many such clients (1);
- ``pool``: how many distinct records set-up makes from the seed; the
  calls go through them in turn, so no call sees the record of the call
  before it and no cache keyed on the input can answer;
- ``placement``: where the records wait for the program, ``"device"``
  (tensors on the card) or ``"host"`` (pageable NumPy arrays);
- ``warm_calls``: the calls set-up makes before the window, on the pool's
  own records (the cell's own shapes and no others);
- ``sample_calls``: how many calls of the window, drawn from the seed,
  are compared with the reference once the window has closed;
- ``trace_seconds``: the length of the stretch a ``--trace 1`` run traces.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
KEYS = ("loop", "clients", "pool", "placement", "warm_calls", "sample_calls",
        "trace_seconds")


def load(name: str) -> dict:
    """The parameters of the traffic mix ``name``, checked."""
    mix = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic {name!r} lacks {missing}")
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError(f"traffic {name!r}: only a closed loop with one "
                         f"client is generated")
    if mix["placement"] not in ("device", "host") or mix["pool"] < 2:
        raise ValueError(f"traffic {name!r}: placement {mix['placement']!r},"
                         f" pool {mix['pool']}")
    return mix


def seed_of(seed: int) -> int:
    """A ``torch.Generator`` seed for any whole number."""
    return int(seed) % (1 << 63)


def _place(value, placement):
    """``value`` where the mix places records.  On the host a tensor becomes
    an array that NumPy allocated, as ``np.fromfile`` or ``h5py`` would
    give a user (NumPy asks the kernel for huge pages on large arrays)."""
    if isinstance(value, torch.Tensor) and placement == "host":
        out = np.empty(tuple(value.shape),
                       torch.empty(0, dtype=value.dtype).numpy().dtype)
        torch.from_numpy(out).copy_(value)
        return out
    return value


def make_pool(mix: dict, cfg: dict, inputs, seed: int, device) -> list:
    """``mix['pool']`` records of the configuration, made on ``device`` by
    ``inputs.make_record`` from one generator seeded with ``seed``, then
    placed where the mix says."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    pool = []
    for _ in range(mix["pool"]):
        rec = inputs.make_record(cfg, gen, device)
        pool.append({k: _place(v, mix["placement"]) for k, v in rec.items()})
        del rec
    return pool


def record_index(mix: dict, call: int) -> int:
    """The pool record the ``call``-th call of a run takes."""
    return call % mix["pool"]
