"""Pedagogical DFT/FFT implementations (reference-teaching module, working);
a copy of :mod:`pyfft_tpu.dft`, which is pure Python and NumPy.

Role of the reference ``dft.py``: small, readable implementations for
understanding the algorithms — direct DFT sums, a radix-2 decimation-in-time
butterfly with bit-reversal, and Cooley-Tukey recursion.  The reference's
versions carry py2 syntax and a missing ``bitrev`` (``dft.py:200,219,268``);
these are complete, working ports of the same algorithms.

None of this is the production path: the port's transforms are
``torch.fft`` and the register-radix Stockham FFT of its CUDA kernels
(``csrc/fft_reg.cuh``: radix-16 passes of in-register radix-2 butterflies,
the Cooley-Tukey split of :func:`fft_basic` without the bit reversal in
memory) — this module documents the math they implement.
"""
from __future__ import annotations

import cmath
import math

import numpy as np

__all__ = ["compute_dft_complex", "compute_dft_real_pair", "ForwardDFT",
           "InverseDFT", "dft", "idft", "complex_dft", "fft_basic", "bitrev",
           "fft", "ifft"]

pi2 = 2.0 * cmath.pi


def compute_dft_complex(sig):
    """O(N^2) complex DFT by direct summation (reference :34-55)."""
    n = len(sig)
    output = []
    for k in range(n):
        s = complex(0)
        for t in range(n):
            angle = 2j * cmath.pi * t * k / n
            s += sig[t] * cmath.exp(-angle)
        output.append(s)
    return output


def compute_dft_real_pair(inreal, inimag):
    """Direct DFT using only real arithmetic (reference :58-78) — the same
    formulation the MXU backend evaluates as two matmuls."""
    assert len(inreal) == len(inimag)
    n = len(inreal)
    outreal = []
    outimag = []
    for k in range(n):
        sr = 0.0
        si = 0.0
        for t in range(n):
            angle = 2 * math.pi * t * k / n
            sr += inreal[t] * math.cos(angle) + inimag[t] * math.sin(angle)
            si += -inreal[t] * math.sin(angle) + inimag[t] * math.cos(angle)
        outreal.append(sr)
        outimag.append(si)
    return outreal, outimag


def ForwardDFT(fnList):
    """1/N-normalized forward DFT (reference :81-94)."""
    N = len(fnList)
    return [sum(fnList[n] * cmath.exp(-1j * pi2 * m * n / N)
                for n in range(N)) / N for m in range(N)]


def InverseDFT(FmList):
    """Inverse of :func:`ForwardDFT` (reference :96-104)."""
    N = len(FmList)
    return [sum(FmList[m] * cmath.exp(1j * pi2 * m * n / N)
                for m in range(N)) for n in range(N)]


def dft(x, sign=-1):
    """DFT via the W^{nk mod N} twiddle table (reference :108-121)."""
    N = len(x)
    W = [np.exp(sign * 2j * np.pi * i / N) for i in range(N)]
    return [sum(W[n * k % N] * x[k] for k in range(N)) for n in range(N)]


def idft(X):
    """Inverse DFT normalized by N (reference :124-133)."""
    N = len(X)
    x = dft(X, sign=1)
    return [v / float(N) for v in x]


def complex_dft(xr, xi, n):
    """Separate-real-arrays DFT (reference :175-188)."""
    rex = [0.0] * n
    imx = [0.0] * n
    for k in range(n):
        for i in range(n):
            sr = math.cos(2 * math.pi * k * i / n)
            si = -math.sin(2 * math.pi * k * i / n)
            rex[k] += xr[i] * sr - xi[i] * si
            imx[k] += xr[i] * si + xi[i] * sr
    return rex, imx


def fft_basic(rex, imx, n):
    """In-place radix-2 decimation-in-time FFT with bit-reversal sorting.

    The butterfly the reference sketches at ``dft.py:191-229`` (py2, broken),
    made correct: this is the classic scalar algorithm whose work the MXU
    backend restructures into matmul stages.
    """
    m = int(math.log2(n))
    if 1 << m != n:
        raise ValueError("fft_basic requires a power-of-two length")

    # bit-reversal sorting
    j = n // 2
    for i in range(1, n - 1):
        if i < j:
            rex[i], rex[j] = rex[j], rex[i]
            imx[i], imx[j] = imx[j], imx[i]
        k = n // 2
        while k <= j:
            j -= k
            k //= 2
        j += k

    for l in range(1, m + 1):
        le = 1 << l
        le2 = le // 2
        ur, ui = 1.0, 0.0
        sr = math.cos(math.pi / le2)
        si = -math.sin(math.pi / le2)
        for jj in range(1, le2 + 1):
            for i in range(jj - 1, n, le):
                ip = i + le2
                tr = rex[ip] * ur - imx[ip] * ui
                ti = rex[ip] * ui + imx[ip] * ur
                rex[ip] = rex[i] - tr
                imx[ip] = imx[i] - ti
                rex[i] += tr
                imx[i] += ti
            tr = ur
            ur = tr * sr - ui * si
            ui = tr * si + ui * sr


def bitrev(x):
    """Bit-reversal permutation of a power-of-two-length sequence.

    The helper the reference's ``fft`` calls but never defines
    (``dft.py:268``).
    """
    n = len(x)
    m = n.bit_length() - 1
    if 1 << m != n:
        raise ValueError("bitrev requires a power-of-two length")
    out = list(x)
    for i in range(n):
        r = int(format(i, f"0{m}b")[::-1], 2) if m else 0
        out[r] = x[i]
    return out


def fft(x, sign=-1):
    """Iterative Cooley-Tukey FFT (reference :242-278, completed)."""
    N = len(x)
    if N & (N - 1):
        raise ValueError("fft requires a power-of-two length")
    W = [np.exp(sign * 2j * np.pi * i / N) for i in range(N)]
    x = bitrev(x)
    m = 2
    while m <= N:
        for s in range(0, N, m):
            for i in range(m // 2):
                n = i * N // m
                a, b = s + i, s + i + m // 2
                x[a], x[b] = x[a] + W[n % N] * x[b], x[a] - W[n % N] * x[b]
        m *= 2
    return x


def ifft(X):
    """Inverse FFT normalized by N (reference :281-290)."""
    N = len(X)
    x = fft(X, sign=1)
    return [v / float(N) for v in x]


def test(rng=None, verbose=True):
    """Round-trip sine-wave demo (reference ``test``, dft.py:136-168,
    py3-fixed): random amplitude/frequency/phase, ForwardDFT, report the
    bins above threshold.  Returns ``(params, found)`` for assertions."""
    if rng is None:
        rng = np.random.default_rng()
    N = 360
    a = float(rng.integers(1, 101))
    f = float(rng.integers(1, 101))
    p = float(rng.integers(0, 361))
    if verbose:
        print("Input Sine Wave Signal:")
        print("frequency = " + str(f))
        print("amplitude = " + str(a))
        print("phase ang = " + str(p) + "\n")
    fnList = [a * math.sin(f * (float(n) / N * pi2) + p / 360 * pi2)
              for n in range(N)]
    FmList = ForwardDFT(fnList)
    found = []
    for i, Fm in enumerate(FmList):
        if abs(Fm) > 0.001:
            ph = int(((cmath.phase(Fm) + pi2 + pi2 / 4.0) % pi2)
                     / pi2 * 360 + 0.5)
            found.append((i, abs(Fm) * 2.0, ph))
            if verbose:
                print("frequency = " + str(i))
                print("amplitude = " + str(abs(Fm) * 2.0))
                print("phase ang = " + str(ph) + "\n")
    return (a, f, p), found


def print_list(l):
    """Bracketed element dump (reference ``print_list``, dft.py:231-236,
    py3-fixed)."""
    print("[%d]: {" % (len(l),))
    for v in l:
        print(v)
    print("}")
