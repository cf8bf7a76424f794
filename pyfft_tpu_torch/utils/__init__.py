"""Utility layer of the port: result containers, detrending, small numerics."""

from .structure import Struct
from .detrend import detrend_none, detrend_mean, detrend_linear, detrend_func
from . import profiling
from . import sanity
from .interp import (
    interp,
    trapz_var,
    sliding_window_1d,
    reshapech,
    rect,
    delta,
)

__all__ = [
    "profiling",
    "sanity",
    "Struct",
    "detrend_none",
    "detrend_mean",
    "detrend_linear",
    "detrend_func",
    "interp",
    "trapz_var",
    "sliding_window_1d",
    "reshapech",
    "rect",
    "delta",
]
