// A register-radix Stockham FFT for one block's group of threads, the
// port's one FFT engine: kernels B (welch.cu for complex signals,
// welch_pair.cu for real ones, with kernel H), C (stft.cu), D (hilbert.cu)
// and E (welch_dft.cu) use it.
//
// An N-point transform (N = 2^LOGN, 16 <= N <= 16384) is run by T = N/16
// threads, each holding 16 complex points in registers.  The passes are
// radix 16, the last one takes the remainder (2, 4, 8 or 16): 16 at N = 16,
// 16.16.8 at N = 2048, 16.16.16.4 at N = 16384.  In the pass of radix R
// after passes that span Ns points, butterfly j (thread t runs j = t + b*T,
// b < 16/R) reads data[j + r*N/R], r < R, multiplies point r by
// W_N^(r*(j % Ns)*N/(Ns*R)), takes an in-register R-point FFT, and writes
// data[(j / Ns)*Ns*R + j % Ns + r*Ns] (Stockham's autosort: natural order
// in, natural order out, no bit reversal in memory).  The first pass reads
// its points from wherever the caller gets them (thread t's point r is
// sample t + r*T); between passes the points go through one shared-memory
// buffer, with a barrier before each pass's writes (the last reads are
// done) and one after them, and one float2 of padding after every 16 so
// that the strided writes of the first pass and the reads after it hit
// distinct banks; the last pass writes the spectrum to the buffer in
// natural order.
//
// Twiddles: W_N^m = tw[m] for m < N/2 and -tw[m - N/2] above, from the
// caller's table tw[m] = exp(-2 pi i m / N), m < N/2, rounded from float64
// (read through L1).  Inside a pass the R-point FFT is radix-2
// decimation in frequency on registers with the 16th roots of unity as
// constants; its bit reversal is a renaming of registers.
#pragma once

#include <cuda_runtime.h>

namespace fftreg {

constexpr int kPoints = 16;     // complex points a thread holds

// Shared-memory index of point i: one float2 of padding after every 16
// (so an N-point buffer takes pad(N) float2).
__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int num_passes(int logn) {
    return (logn + 3) / 4;
}

// Radix of pass p of an N = 2^logn transform.
__host__ __device__ constexpr int radix(int logn, int p) {
    return p + 1 < num_passes(logn) ? 16 : 1 << (logn - 4 * p);
}

// Points spanned by the passes before pass p.
__host__ __device__ constexpr int span(int p) { return 1 << (4 * p); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cos(2 pi q / 16) for any integer q (a constant once loops unroll).
__device__ __forceinline__ float cos16(int q) {
    constexpr float c1 = 0.923879532511286756f;   // cos(pi/8)
    constexpr float c2 = 0.707106781186547524f;   // cos(pi/4)
    constexpr float c3 = 0.382683432365089772f;   // cos(3 pi/8)
    switch (q & 15) {
        case 0: return 1.f;
        case 1: case 15: return c1;
        case 2: case 14: return c2;
        case 3: case 13: return c3;
        case 4: case 12: return 0.f;
        case 5: case 11: return -c3;
        case 6: case 10: return -c2;
        case 7: case 9: return -c1;
        default: return -1.f;
    }
}

// v * exp(-2 pi i q / 16); the quarter turns take no multiply.
__device__ __forceinline__ float2 rot16(float2 v, int q) {
    switch (q & 15) {
        case 0: return v;
        case 4: return make_float2(v.y, -v.x);
        case 8: return make_float2(-v.x, -v.y);
        case 12: return make_float2(-v.y, v.x);
        default: return cmul(v, make_float2(cos16(q), -cos16(q - 4)));
    }
}

// In-register R-point FFT (R = 2, 4, 8, 16) of v[0..R): natural order in
// and out.
template <int R>
__device__ __forceinline__ void fft_points(float2* v) {
#pragma unroll
    for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
            if (i & half) continue;
            const float2 a = v[i];
            const float2 b = v[i + half];
            v[i] = make_float2(a.x + b.x, a.y + b.y);
            v[i + half] = rot16(make_float2(a.x - b.x, a.y - b.y),
                                (i & (half - 1)) * 8 / half);
        }
    }
    float2 t[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        int rev = 0;
#pragma unroll
        for (int bit = 1, mirror = R / 2; bit < R; bit <<= 1, mirror >>= 1)
            if (k & bit) rev |= mirror;
        t[k] = v[rev];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = t[k];
}

// W_N^m, 0 <= m < N, from the half table tw (N/2 entries).
template <int N>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int m) {
    const float2 w = __ldg(tw + (m & (N / 2 - 1)));
    return m < N / 2 ? w : make_float2(-w.x, -w.y);
}

// Pass P of an N-point transform on thread t's registers v: twiddles, then
// the radix-R FFTs of its 16/R butterflies.
template <int LOGN, int P>
__device__ __forceinline__ void pass(float2 (&v)[kPoints],
                                     const float2* __restrict__ tw, int t) {
    constexpr int N = 1 << LOGN;
    constexpr int T = N / kPoints;
    constexpr int R = radix(LOGN, P);
    constexpr int Ns = span(P);
#pragma unroll
    for (int b = 0; b < kPoints / R; ++b) {
        if constexpr (P > 0) {
            const int k = (t + b * T) % Ns;
#pragma unroll
            for (int r = 1; r < R; ++r)
                v[b * R + r] = cmul(v[b * R + r],
                                    twiddle<N>(tw, r * k * (N / (Ns * R))));
        }
        fft_points<R>(v + b * R);
    }
}

// Pass P's outputs from thread t's registers to their natural places in
// `buf` (Stockham's write).
template <int LOGN, int P>
__device__ __forceinline__ void store_pass(const float2 (&v)[kPoints],
                                           float2* buf, int t) {
    constexpr int T = (1 << LOGN) / kPoints;
    constexpr int R = radix(LOGN, P);
    constexpr int Ns = span(P);
#pragma unroll
    for (int b = 0; b < kPoints / R; ++b) {
        const int j = t + b * T;
        const int d = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
        for (int r = 0; r < R; ++r) buf[pad(d + r * Ns)] = v[b * R + r];
    }
}

// Pass P's inputs from `buf` to thread t's registers (Stockham's read).
template <int LOGN, int P>
__device__ __forceinline__ void load_pass(float2 (&v)[kPoints],
                                          const float2* buf, int t) {
    constexpr int N = 1 << LOGN;
    constexpr int T = N / kPoints;
    constexpr int R = radix(LOGN, P);
#pragma unroll
    for (int b = 0; b < kPoints / R; ++b) {
#pragma unroll
        for (int r = 0; r < R; ++r)
            v[b * R + r] = buf[pad(t + b * T + r * (N / R))];
    }
}

// The power of two 2^e that brings a sequence whose sum of squares is ss
// into [0.5, 2) (ss / 4^e there), so that two real sequences sharing one
// transform each keep their own accuracy; 0 for a zero sequence.  Kept to
// +-100 so that 2^-e and a norm times 2^e stay in float range.
__device__ __forceinline__ int scale_exponent(double ss) {
    int e2 = 0;
    frexp(ss, &e2);
    const int e = e2 >> 1;
    return e < -100 ? -100 : e > 100 ? 100 : e;
}

// Passes P.. of the transform whose pass-P inputs thread t holds in v,
// through `buf` (pad(N) float2).  On return `buf` holds the spectrum in
// natural order and every thread of the block has passed the barrier after
// it.  Two barriers a pass: a second buffer would save one, but on an H100
// it was no faster at N = 2048 and slower at 4096, where it halves the
// blocks an SM holds.
template <int LOGN, int P = 0>
__device__ __forceinline__ void transform(float2 (&v)[kPoints], float2* buf,
                                          const float2* __restrict__ tw,
                                          int t) {
    pass<LOGN, P>(v, tw, t);
    __syncthreads();
    store_pass<LOGN, P>(v, buf, t);
    __syncthreads();
    if constexpr (P + 1 < num_passes(LOGN)) {
        load_pass<LOGN, P + 1>(v, buf, t);
        transform<LOGN, P + 1>(v, buf, tw, t);
    }
}

}  // namespace fftreg
