"""Plain building blocks of the references: float64 Welch sums, a float64
FIR, the one-sided power scale, and the TF32 emulation the controls use.

Plain PyTorch and NumPy only.  Nothing here imports the program under
test: the references work everything out again from the inputs the
benchmark made.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def exact_float32():
    """Float32 products stay float32: no TF32 in matrix products or
    convolutions while the block runs."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest, ties away from zero: the operand a TF32 tensor core reads.
    Two such operands multiply exactly in float32, so a float32 product of
    rounded operands is what the tensor core computes."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def onesided_power_scale(nfft: int, nnyquist: int) -> np.ndarray:
    """The one-sided doubling of the upstream ``fft_pwelch``: the retained
    bins between the first and the last doubled, and the last too when
    ``nfft`` is odd (for even ``nfft`` the Nyquist bin is not retained)."""
    s = np.ones(nnyquist)
    s[1:-1] = 2.0
    if nfft % 2:
        s[-1] = 2.0
    return s


def nnyquist(nfft: int) -> int:
    """Bins the upstream one-sided spectra keep: ``nfft // 2`` for even
    ``nfft`` (the Nyquist bin dropped), ``(nfft + 1) // 2`` for odd."""
    return (nfft + 1) // 2 if nfft % 2 else nfft // 2


def fir64(sig: torch.Tensor, taps) -> torch.Tensor:
    """``np.convolve(row, taps, 'full')[:nt]`` of every row of ``sig``
    (float64), by FFT in float64, a row at a time."""
    nt = sig.shape[-1]
    taps = torch.as_tensor(np.asarray(taps, np.float64), device=sig.device)
    n = 1 << int(np.ceil(np.log2(nt + taps.numel() - 1)))
    H = torch.fft.rfft(taps, n)
    out = torch.empty_like(sig)
    for r in range(sig.shape[0]):
        out[r] = torch.fft.irfft(torch.fft.rfft(sig[r], n) * H, n)[:nt]
    return out


def fir_tf32(sig: torch.Tensor, taps) -> torch.Tensor:
    """The same FIR as a float32 direct-form convolution whose operands are
    rounded to TF32 (the control's filter)."""
    K = len(taps)
    w = torch.as_tensor(np.ascontiguousarray(np.asarray(taps)[::-1]),
                        dtype=torch.float32, device=sig.device)
    x = torch.nn.functional.pad(round_tf32(sig)[:, None], (K - 1, 0))
    with exact_float32():
        return torch.nn.functional.conv1d(x, round_tf32(w).view(1, 1, K))[:, 0]


def _dft_tables(nwins: int, nbins: int, device) -> tuple:
    """TF32-rounded cos and sin tables (nwins, nbins) of the forward DFT,
    each angle reduced exactly (m k mod nwins) before it is evaluated."""
    m = torch.arange(nwins, dtype=torch.int64, device=device)
    k = torch.arange(nbins, dtype=torch.int64, device=device)
    ang = (m[:, None] * k[None, :] % nwins).to(torch.float64) * (
        2.0 * np.pi / nwins)
    return round_tf32(torch.cos(ang).float()), round_tf32(torch.sin(ang).float())


def welch_sums(sig: torch.Tensor, win, *, nwins: int, hop: int, navr: int,
               nbins: int, dft: str = "fft64", block: int = 2048) -> tuple:
    """Welch sums over ``navr`` segments of every row of ``sig`` (S, nt),
    row 0 the reference: ``(auto (S, nbins) float64, cross (S - 1, nbins)
    complex128)``, with auto the sums of |F|^2 and cross the sums of
    ``F_row * conj(F_0)``, unscaled.

    ``dft='fft64'``: the windowed segments in float64 through
    ``torch.fft.rfft``.  ``dft='tf32'`` (the control): the windowed
    segments in float32, the DFT as a matrix product of TF32-rounded
    operands accumulated in float32.  The sums are float64 either way.
    """
    dev = sig.device
    frames = sig.unfold(-1, nwins, hop)[:, :navr]          # (S, navr, nwins)
    S = sig.shape[0]
    auto = torch.zeros((S, nbins), dtype=torch.float64, device=dev)
    cross = torch.zeros((S - 1, nbins), dtype=torch.complex128, device=dev)
    if dft == "fft64":
        w = torch.as_tensor(np.asarray(win, np.float64), device=dev)
    else:
        w = torch.as_tensor(np.asarray(win), dtype=torch.float32, device=dev)
        C, Sn = _dft_tables(nwins, nbins, dev)
    for s0 in range(0, navr, block):
        fr = frames[:, s0:s0 + block]
        if dft == "fft64":
            F = torch.fft.rfft(fr.to(torch.float64) * w, dim=-1)[..., :nbins]
        else:
            a = round_tf32(fr.to(torch.float32) * w).reshape(-1, nwins)
            with exact_float32():
                re = (a @ C).double()
                im = -(a @ Sn).double()
            F = torch.complex(re, im).reshape(S, -1, nbins)
        auto += (F.real ** 2 + F.imag ** 2).sum(1)
        cross += (F[1:] * F[:1].conj()).sum(1)
        del F
    return auto, cross


def rel_err_by_column(got, want) -> float:
    """The worst column's max |got - want| over its max |want|: each
    channel's spectrum held to its own peak, so a quiet channel beside a
    loud one keeps its own accuracy."""
    got = np.asarray(got)
    want = np.asarray(want)
    if want.ndim == 1:
        got, want = got[:, None], want[:, None]
    if got.shape != want.shape:
        return float("inf")
    scale = np.abs(want).max(axis=0)
    err = np.abs(got - want).max(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(scale > 0, err / scale, np.where(err > 0, np.inf, 0.0))
    r = np.where(np.isfinite(got).all(axis=0), r, np.inf)
    return float(r.max())
