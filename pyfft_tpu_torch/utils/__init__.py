"""Utility layer of the port: result containers and detrending."""

from .structure import Struct
from .detrend import detrend_none, detrend_mean, detrend_linear, detrend_func

__all__ = [
    "Struct",
    "detrend_none",
    "detrend_mean",
    "detrend_linear",
    "detrend_func",
]
