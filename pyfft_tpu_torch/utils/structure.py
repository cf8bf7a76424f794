"""Result containers (counterpart of :mod:`pyfft_tpu.utils.structure`).

A minimal attribute bag standing in for the reference's
``pybaseutils.Struct``.  Unlike the JAX package's, it is not registered as a
pytree: nothing in the port traces through it.
"""
from __future__ import annotations


class Struct:
    """A minimal attribute-bag (replacement for ``pybaseutils.Struct``).

    Supports construction from a dict, attribute access, and conversion back
    to a dict via :meth:`dict_from_class` (name kept for reference parity).
    """

    def __init__(self, d=None):
        if d is not None:
            if not isinstance(d, dict):
                d = d.dict_from_class()
            self.__dict__.update(d)

    def dict_from_class(self):
        return dict(self.__dict__)

    def update(self, d=None):
        if d is not None:
            if not isinstance(d, dict):
                d = d.dict_from_class()
            self.__dict__.update(d)
        return self

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):  # pragma: no cover - debugging aid
        keys = ", ".join(sorted(self.__dict__.keys()))
        return f"Struct({keys})"
