"""Detrending primitives on tensors (counterpart of
:mod:`pyfft_tpu.utils.detrend`).

The reference's selection convention ``detrend_style > 0 -> mean,
== 0 -> none, < 0 -> linear`` (reference ``fft_analysis.py:2539-2549``).
Each function works along ``axis`` of a real or complex tensor and keeps
its dtype and device.
"""
from __future__ import annotations

import torch


def detrend_none(x, axis=0):
    """Identity detrend."""
    return x


def detrend_mean(x, axis=0):
    """Remove the mean along ``axis``."""
    x = torch.as_tensor(x)
    return x - x.mean(dim=axis, keepdim=True)


def detrend_linear(x, axis=0):
    """Remove a least-squares linear fit along ``axis``.

    Matches ``matplotlib.mlab.detrend_linear`` semantics: fit ``y = a t + b``
    on a unit-spaced grid and subtract it.
    """
    x = torch.as_tensor(x)
    axis = axis % x.dim()
    n = x.shape[axis]
    real = x.real.dtype if x.is_complex() else x.dtype
    if not real.is_floating_point:
        real = torch.float64
    t = torch.arange(n, dtype=real, device=x.device)
    # center t so the normal equations are diagonal
    t = t - t.mean()
    shape = [1] * x.dim()
    shape[axis] = n
    tb = t.reshape(shape)
    denom = torch.sum(t * t)
    xm = x.mean(dim=axis, keepdim=True)
    slope = torch.sum((x - xm) * tb, dim=axis, keepdim=True) / denom
    return x - xm - slope * tb


def detrend_func(detrend_style=None):
    """Map the reference's integer detrend-style flag to a function:
    ``None -> 0``; ``>0 -> mean``; ``<0 -> linear``; ``0 -> none``."""
    if detrend_style is None:
        detrend_style = 0
    if detrend_style > 0:
        return detrend_mean
    elif detrend_style < 0:
        return detrend_linear
    return detrend_none
