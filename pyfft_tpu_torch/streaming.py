"""Block-streamed, checkpoint/resumable Welch estimation.

Counterpart of :mod:`pyfft_tpu.streaming`, with the same names, results
and checkpoint format:

- **O(block) memory**: the signal arrives in arbitrary-size time blocks;
  only segment *sums* and a ``nwins - hop``-sample carry persist between
  pushes, both on the compute device, so sequence length is unbounded by
  device or host memory.
- **Checkpoint / resume**: :meth:`StreamingWelch.checkpoint` writes the
  state to one ``.npz`` under the JAX package's keys and dtypes (float64
  and complex128 arrays), so a checkpoint written by either package
  restores in the other; a restored stream gives results bit-identical to
  an uninterrupted one.
- **Exact batch equivalence**: mean detrending is applied *post hoc* from
  the running signal mean, by the identity

      sum_g |X_g - m W|^2 = sum|X_g|^2 - 2 Re(conj(m W) sum X_g)
                            + G |m W|^2        (W = FFT of the window)

  so the accumulators hold the raw sums ``sum|X_g|^2``, ``sum Y_g conj
  X_g`` and the linear sums ``sum X_g``, as in the JAX package.

Each push computes its block's sums in two parts (:func:`_block_sums`).
The powers come from the block *centred* on its own mean ``mu``, rounded
to the compute dtype: ``sum|Xc_g|^2`` and ``sum Yc_g conj Xc_g`` with
``Xc_g = X_g - mu W``.  The linear sums ``L = sum X_g`` come from the raw
block in float64 (one transform of the window times the sum of the
block's frames).  The raw sums then follow in float64:

    sum|X_g|^2        = sum|Xc_g|^2 + 2 Re(conj(a) L_x) - G |a|^2
    sum Y_g conj X_g  = sum Yc_g conj Xc_g + conj(a) L_y + b conj(L_x)
                        - G b conj(a)          (a = mu_x W, b = mu_y W)

Powers of a raw block with a DC offset far above the noise (an ADC
offset) carry ``G |mu W|^2`` at the first bins, which the post-hoc
detrend cancels; summed in float32 their rounding would survive that
cancellation.  Centred, the float32 powers are at the noise's scale, and
every term of the size of the offset is float64.

The centred powers go through the transform path the batch ``fft_pwelch``
takes for the geometry: with ``fft_backend='pallas'`` the kernel that
:func:`~pyfft_tpu_torch.spectral.pallas_route` names (kernel B on CUDA
tensors: ``csrc/welch_pair.cu`` for real blocks in float32,
``csrc/welch.cu`` for complex ones in complex64; E or H where the route
says so; their plain versions on CPU tensors, in the block's dtype), else
``torch.fft`` (:func:`~pyfft_tpu_torch.ops.welch.welch_plain`) in the
block's dtype.  A push with no complete segment launches nothing; a
kernel that fails raises.
"""
from __future__ import annotations

import numpy as np
import torch

from . import segmentation as seg
from .config import resolve_device
from .spectral import (_kernel_sums, _onesided_power_scale, pallas_route,
                       resolve_fft_backend)
from .ops import welch
from .utils.structure import Struct
from .windows import windows as _windows

__all__ = ["StreamingWelch"]


def _linear_sums(sig, win, *, navr, nwins, hop, nfreq, onesided):
    """float64 (complex128) ``sum_g X_g`` of each row of ``sig (C, nt)``:
    the transform of ``win`` times the sum of the row's ``navr`` frames,
    its first ``nfreq`` bins; ``win`` a float64 tensor on ``sig``'s
    device."""
    wide = torch.complex128 if sig.is_complex() else torch.float64
    frames = seg.frame_signal(sig.to(wide), nwins, hop, navr).sum(-2)
    spec = torch.fft.rfft if onesided else torch.fft.fft
    return spec(frames * win, dim=-1)[..., :nfreq]


def _block_sums(sig, win, W, centred_sums, *, navr, nwins, hop, nfreq,
                onesided):
    """Raw segment sums of one block (module docstring).

    ``sig (1 + nch, nt)`` holds the reference first, in the dtype the
    centred sums run in; ``win`` and ``W`` are that dtype's window and its
    spectrum's first ``nfreq`` bins, as float64 (complex128) tensors;
    ``centred_sums(xc, yc)`` returns ``(Pxx, Pyy, Pxy_re, Pxy_im)`` summed
    over the ``navr`` segments.  Returns float64 ``S_auto (1 + nch,
    nfreq)`` (``sum|X_g|^2`` then each ``sum|Y_g|^2``), complex128 ``Sxy
    (nch, nfreq)`` and the linear sums ``L (1 + nch, nfreq)``.
    """
    span = (navr - 1) * hop + nwins
    sig = sig[:, :span]
    wide = torch.complex128 if sig.is_complex() else torch.float64
    # each row's mean, rounded to the compute dtype: the offset removed is
    # then known exactly
    mu = welch._row_sums(sig).div(span).to(sig.dtype)
    sigc = sig - mu[:, None]
    Pxx, Pyy, Pre, Pim = centred_sums(sigc[0].contiguous(), sigc[1:])
    L = _linear_sums(sig, win, navr=navr, nwins=nwins, hop=hop, nfreq=nfreq,
                     onesided=onesided)
    a = mu.to(wide)[:, None] * W                          # (C, nfreq)
    G = float(navr)
    auto = torch.cat([Pxx[None], Pyy]).double()
    auto = (auto + 2.0 * (a.conj() * L).real
            - G * (a.real ** 2 + a.imag ** 2))
    ax, Lx = a[0], L[0]
    b, Ly = a[1:], L[1:]
    Sxy = (torch.complex(Pre.double(), Pim.double()) + ax.conj() * Ly
           + b * Lx.conj() - G * b * ax.conj())
    return auto, Sxy, L


class StreamingWelch:
    """Streaming one- or two-sided Welch cross-spectral accumulator.

    >>> sw = StreamingWelch(nwins=1024, fs=1e4, nch=4, device="cuda")
    >>> for xb, yb in blocks:      # arbitrary block sizes
    ...     sw.push(xb, yb)
    >>> res = sw.result()          # freq, Pxx, Pyy, Pxy, Cxy2, phi, ...

    ``detrend`` in {'mean', 'none'}: 'mean' subtracts the running global
    mean exactly (see module docstring); 'linear' has no streaming form and
    raises.  ``device``: where the sums and the carry live and the blocks
    are transformed (:func:`~pyfft_tpu_torch.config.resolve_device`).
    """

    def __init__(self, nwins, fs=1.0, nch=1, windowoverlap=None,
                 windowfunction="hanning", detrend="mean", fft_backend=None,
                 onesided=True, device=None):
        if detrend not in ("mean", "none"):
            raise ValueError(
                "streaming supports detrend 'mean' or 'none' (global linear "
                "detrend has no one-pass form)")
        win = _windows(windowfunction, nwins=int(nwins), verbose=False)
        if windowoverlap is None:
            windowoverlap = _windows(windowfunction, verbose=False)
        self.nwins = int(nwins)
        self.noverlap = seg.get_noverlap(self.nwins, windowoverlap)
        self.hop = self.nwins - self.noverlap
        if self.hop <= 0:
            raise ValueError(f"overlap {windowoverlap} leaves hop <= 0")
        self.fs = float(fs)
        self.nch = int(nch)
        self.detrend = detrend
        self.windowfunction = windowfunction
        self.win = np.asarray(win, dtype=np.float64)
        self.nnyquist = seg.get_nnyquist(self.nwins)
        self.backend = resolve_fft_backend(fft_backend)
        self.onesided = bool(onesided)
        self.device = resolve_device(device)

        nf = self.nnyquist if self.onesided else self.nwins
        self.nfreq = nf
        self.navr = 0
        self.nseen = 0                       # total samples consumed
        self._acc = torch.float64 if self.onesided else torch.complex128

        def zeros(*shape, dtype=self._acc):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        self.sum_x = zeros()                 # running sums (for the mean)
        self.sum_y = zeros(self.nch)
        self.Sxx = zeros(nf, dtype=torch.float64)
        self.Syy = zeros(self.nch, nf, dtype=torch.float64)
        self.Sxy = zeros(self.nch, nf, dtype=torch.complex128)
        self.Ax = zeros(nf, dtype=torch.complex128)
        self.Ay = zeros(self.nch, nf, dtype=torch.complex128)
        self._carry_x = zeros(0)
        self._carry_y = zeros(self.nch, 0)
        # window spectrum for the post-hoc mean-detrend correction
        self._W = (np.fft.rfft(self.win)[:nf] if self.onesided
                   else np.fft.fft(self.win))
        self._windows = {}                   # compute dtype -> (win, W)

    # ------------------------------------------------------------------ #

    def _block(self, a):
        """``a`` as a tensor on the compute device, in a floating dtype
        (float64 for integers, as the JAX package casts), complex for
        two-sided streams."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.ascontiguousarray(a))
        a = a.to(self.device)
        if a.is_complex() and self.onesided:
            raise ValueError("complex blocks require onesided=False")
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(torch.float64)
        if not self.onesided and not a.is_complex():
            a = a.to(torch.complex128 if a.dtype == torch.float64
                     else torch.complex64)
        return a

    def _route(self, navr, cplx):
        """The kernel route of a push with ``navr`` segments, or None for
        ``torch.fft``."""
        if self.backend != "pallas":
            return None
        return pallas_route(nwins=self.nwins, noverlap=self.noverlap,
                            navr=navr, nnyquist=self.nnyquist,
                            onesided=self.onesided, detrend_style=0,
                            ntmodel=False, is_cplx=cplx, nch=self.nch)

    def _compute_dtype(self, dtype, route):
        """The kernels take float32 (complex64) on the card; the plain
        versions run in the block's dtype."""
        if route is None or self.device.type != "cuda":
            return dtype
        return torch.complex64 if dtype.is_complex else torch.float32

    def _window(self, dtype):
        """The window as the centred sums see it (rounded to ``dtype``'s
        precision) and its spectrum, as float64 tensors on the device."""
        if dtype not in self._windows:
            real = torch.empty(0, dtype=dtype).real.dtype
            w = torch.as_tensor(self.win, dtype=real).double()
            spec = torch.fft.rfft if self.onesided else torch.fft.fft
            W = spec(w)[:self.nfreq]
            self._windows[dtype] = (w.to(self.device), W.to(self.device))
        return self._windows[dtype]

    def _centred_sums(self, route, navr):
        """``(xc, yc) -> (Pxx, Pyy, Pxy_re, Pxy_im)`` summed over ``navr``
        segments, unscaled: the route's kernel (its plain version on CPU
        tensors) or ``torch.fft``."""
        kw = dict(navr=navr, nwins=self.nwins, hop=self.hop)
        nf, win = self.nfreq, self.win
        if route is not None:
            return lambda xc, yc: _kernel_sums(route, xc, yc, win, nf, **kw)
        return lambda xc, yc: welch.welch_plain(xc, yc, win, nf, 1.0,
                                                detrend_style=0, **kw)

    def push(self, x, y=None):
        """Consume the next time block (``x`` (nb,); ``y`` (nch, nb)), NumPy
        or tensors; returns the number of segments it completed."""
        x = self._block(x).reshape(-1)
        if y is None:
            if self.nch != 1:
                raise ValueError(f"y shape None != ({self.nch}, {x.numel()})")
            y = x[None, :]
        y = self._block(y)
        if y.dim() == 1:
            y = y[None]
        if tuple(y.shape) != (self.nch, x.shape[0]):
            raise ValueError(
                f"y shape {tuple(y.shape)} != ({self.nch}, {x.shape[0]})")
        dtype = torch.promote_types(x.dtype, y.dtype)

        self.nseen += x.shape[0]
        self.sum_x += x.sum(dtype=self._acc)
        self.sum_y += y.sum(-1, dtype=self._acc)

        x = torch.cat([self._carry_x.to(dtype), x.to(dtype)])
        y = torch.cat([self._carry_y.to(dtype), y.to(dtype)], dim=1)

        nb = x.shape[0]
        navr = 0 if nb < self.nwins else 1 + (nb - self.nwins) // self.hop
        if navr > 0:
            route = self._route(navr, x.is_complex())
            cdt = self._compute_dtype(dtype, route)
            win, W = self._window(cdt)
            auto, Sxy, L = _block_sums(
                torch.cat([x[None], y]).to(cdt), win, W,
                self._centred_sums(route, navr), navr=navr,
                nwins=self.nwins, hop=self.hop, nfreq=self.nfreq,
                onesided=self.onesided)
            self.navr += navr
            self.Sxx += auto[0]
            self.Syy += auto[1:]
            self.Sxy += Sxy
            self.Ax += L[0]
            self.Ay += L[1:]
        consumed = navr * self.hop
        self._carry_x = x[consumed:].clone()
        self._carry_y = y[:, consumed:].clone()
        return navr

    # ------------------------------------------------------------------ #

    def _host(self, name):
        """State ``name`` as the JAX package holds it: NumPy float64 or
        complex128 (the carry widened from its compute dtype), or int."""
        v = getattr(self, name)
        if not isinstance(v, torch.Tensor):
            return v
        if name.startswith("_carry"):
            v = v.to(self._acc)
        return v.cpu().numpy()

    def _detrended_sums(self):
        """Apply the post-hoc global-mean correction to the raw sums (host
        float64, as in the JAX package)."""
        Sxx, Syy, Sxy, Ax, Ay = (self._host(k) for k in
                                 ("Sxx", "Syy", "Sxy", "Ax", "Ay"))
        if self.detrend == "none" or self.nseen == 0:
            return Sxx, Syy, Sxy
        mx = self._host("sum_x") / self.nseen
        my = self._host("sum_y") / self.nseen            # (nch,)
        W = self._W
        G = self.navr
        cx = mx * W                                      # (nf,)
        cy = my[:, None] * W[None, :]                    # (nch, nf)
        Sxx = (Sxx - 2.0 * np.real(np.conj(cx) * Ax)
               + G * np.abs(cx) ** 2)
        Syy = (Syy - 2.0 * np.real(np.conj(cy) * Ay)
               + G * np.abs(cy) ** 2)
        Sxy = (Sxy - cy * np.conj(Ax)
               - np.conj(cx) * Ay + G * cy * np.conj(cx))
        return Sxx, Syy, Sxy

    def result(self):
        """Finalize: normalized spectra + coherence/phase (a Struct of NumPy
        arrays, computed on the host in float64)."""
        if self.navr == 0:
            raise ValueError("no complete segment consumed yet")
        S1 = seg.get_s1(self.win)
        S2 = seg.get_s2(self.win)
        ENBW = seg.get_enbw(self.fs, S1, S2)
        if self.onesided:
            scale = _onesided_power_scale(self.nwins, self.nnyquist)
        else:
            scale = 1.0
        norm = scale / (S1 ** 2 * ENBW * self.navr)

        Sxx, Syy, Sxy = self._detrended_sums()
        out = Struct()
        if self.onesided:
            out.freq = self.fs * np.arange(self.nnyquist) / self.nwins
            out.Pxx = Sxx * norm
            out.Pyy = Syy * norm
            out.Pxy = Sxy * norm
        else:
            out.freq = np.fft.fftshift(
                np.fft.fftfreq(self.nwins, 1.0 / self.fs))
            out.Pxx = np.fft.fftshift(Sxx * norm)
            out.Pyy = np.fft.fftshift(Syy * norm, axes=-1)
            out.Pxy = np.fft.fftshift(Sxy * norm, axes=-1)
        # (nch, nf) layout: broadcast Pxx over the channel axis
        denom = np.abs(out.Pxx)[None, :] * np.abs(out.Pyy)
        with np.errstate(divide="ignore", invalid="ignore"):
            out.Cxy2 = np.real(out.Pxy * np.conj(out.Pxy)) / denom
            out.Cxy = out.Pxy / np.sqrt(denom)
        out.phi_xy = np.arctan2(out.Pxy.imag, out.Pxy.real)
        out.Navr = self.navr
        out.ENBW = ENBW
        out.S1, out.S2 = S1, S2
        out.nseen = self.nseen
        return out

    # ------------------------------------------------------------------ #

    _STATE = ("navr", "nseen", "sum_x", "sum_y", "Sxx", "Syy", "Sxy",
              "Ax", "Ay", "_carry_x", "_carry_y")
    _CONFIG = ("nwins", "fs", "nch", "noverlap", "detrend",
               "windowfunction", "onesided")

    def checkpoint(self, path):
        """Write the full resumable state to one ``.npz`` file (the JAX
        package's keys and dtypes)."""
        state = {k: np.asarray(self._host(k)) for k in self._STATE}
        cfg = {f"cfg_{k}": np.asarray(getattr(self, k))
               for k in self._CONFIG}
        np.savez(path, **state, **cfg)
        return path

    @classmethod
    def restore(cls, path, fft_backend=None, device=None):
        """Reconstruct a mid-stream estimator from :meth:`checkpoint` (of
        either package), its state on ``device``."""
        with np.load(path, allow_pickle=False) as z:
            nwins = int(z["cfg_nwins"])
            noverlap = int(z["cfg_noverlap"])
            sw = cls(nwins=nwins, fs=float(z["cfg_fs"]),
                     nch=int(z["cfg_nch"]),
                     windowoverlap=noverlap / nwins,
                     windowfunction=str(z["cfg_windowfunction"]),
                     detrend=str(z["cfg_detrend"]),
                     onesided=bool(z["cfg_onesided"]),
                     fft_backend=fft_backend, device=device)
            for k in cls._STATE:
                v = z[k]
                if k in ("navr", "nseen"):
                    setattr(sw, k, int(v))
                else:
                    setattr(sw, k, torch.as_tensor(v, device=sw.device))
        return sw
