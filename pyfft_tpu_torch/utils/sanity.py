"""Consistency sanitizers (counterpart of :mod:`pyfft_tpu.utils.sanity`).

The hazards on the card are the JAX package's: (a) divergence between
compiled and eager execution, (b) silent NaN/Inf propagation, and (c)
nondeterminism between sharded and single-device execution (collective
reassociation).  Each gets an executable check:

- :func:`check_jit_eager`: run a function compiled
  (``torch.compile(fn, backend="aot_eager")``, which needs no C++
  compiler) and eagerly on the same inputs and compare leaf-wise;
- :func:`nan_guard`: a ``TorchDispatchMode`` within a scope that raises at
  the first operation whose floating output is not finite, naming it (the
  counterpart of ``jax_debug_nans``);
- :func:`assert_finite`: finiteness of every tensor or array in nested
  dicts, lists, tuples and ``Struct``\\ s, with the path of the offending
  leaf;
- :func:`check_sharded_consistency`: compare a sharded computation against
  its single-device run within a reassociation tolerance.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .structure import Struct

__all__ = ["check_jit_eager", "nan_guard", "assert_finite",
           "check_sharded_consistency"]


def _leaves(tree, path=""):
    """``(path, leaf)`` of nested dicts (``['k']``), lists and tuples
    (``[i]``) and ``Struct``\\ s (``.name``), in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, Struct):
        for k, v in vars(tree).items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _compare_trees(a, b, rtol, atol, label_a, label_b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    pa, pb = [p for p, _ in la], [p for p, _ in lb]
    if pa != pb:
        raise AssertionError(
            f"{label_a} / {label_b} structures differ: {pa} vs {pb}")
    for (path, xa), (_, xb) in zip(la, lb):
        np.testing.assert_allclose(
            _host(xa), _host(xb), rtol=rtol, atol=atol,
            err_msg=f"leaf {path or '(root)'}: {label_a} != {label_b}")


def check_jit_eager(fn, *args, rtol=1e-5, atol=1e-8, static_argnames=()):
    """Assert ``torch.compile(fn)(*args) == fn(*args)`` leaf-wise; returns
    the compiled output on success.  ``static_argnames`` is accepted for
    the JAX signature: ``torch.compile`` specializes non-tensor arguments
    itself."""
    eager = fn(*args)
    compiled = torch.compile(fn, backend="aot_eager")(*args)
    _compare_trees(compiled, eager, rtol, atol, "compiled", "eager")
    return compiled


class _NanGuard(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first operation with a
    non-finite floating or complex output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for path, t in _leaves(out):
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"{func}: non-finite output{path}")
        return out


@contextlib.contextmanager
def nan_guard(enable=True):
    """Scope in which the first operation that produces a NaN or Inf
    raises immediately instead of propagating."""
    if not enable:
        yield
        return
    with _NanGuard():
        yield


def assert_finite(tree, name="output"):
    """Raise with the leaf path if any tensor or array in ``tree`` has
    NaN/Inf."""
    for path, leaf in _leaves(tree):
        if not isinstance(leaf, (torch.Tensor, np.ndarray, float, complex)):
            continue
        arr = _host(leaf)
        if arr.dtype.kind in "fc" and not np.all(np.isfinite(arr)):
            nbad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(
                f"{name}{path}: {nbad}/{arr.size} non-finite values")
    return tree


def check_sharded_consistency(sharded_fn, single_fn, *args, rtol=1e-5,
                              atol=1e-8):
    """Assert a sharded computation matches its single-device reference.

    ``sharded_fn`` runs over the mesh; ``single_fn`` is the same math on one
    device.  Tolerances absorb collective reassociation (all-reduce order).
    """
    _compare_trees(sharded_fn(*args), single_fn(*args), rtol, atol,
                   "sharded", "single-device")
