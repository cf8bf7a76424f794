// Segment staging and the in-place radix-2 FFT in shared memory, for the
// complex path of kernel B (welch.cu), its only user.  Kernels C, D, E and
// B's real path (stft.cu, hilbert.cu, welch_dft.cu, welch_pair.cu) run
// fft_reg.cuh's register-radix FFT instead.
#pragma once

#include <cuda_runtime.h>

#include "fir.cuh"

// Position of sample n in a bit-reversed buffer of N = 2^logN points.
__device__ __forceinline__ int bitrev(int n, int logN) {
    return static_cast<int>(__brev(static_cast<unsigned>(n)) >> (32 - logN));
}

// Stage component `comp` of the raw samples [start-(K-1), start-(K-1)+span)
// of one signal into `raw` (zeros before the signal starts).
__device__ __forceinline__ void stage(float* raw, const float* sig,
                                      int estride, int comp, long long start,
                                      int span, int K) {
    for (int j = threadIdx.x; j < span; j += blockDim.x) {
        const long long t = start - (K - 1) + j;
        raw[j] = t >= 0 ? __ldg(sig + t * estride + comp) : 0.f;
    }
}

// One part of a segment: v[n] = (fir(component `comp` of sig)[start + n]
// - mean) * win[n] goes to buf[bitrev(n)].x, with .y set to 0 (imag =
// false), or to buf[bitrev(n)].y (imag = true).  The raw samples pass
// through `raw`, so the two parts of one buffer are staged one after the
// other.  Ends with a __syncthreads.
__device__ inline void load_component(float2* buf, float* raw,
                                      const float* taps, int K,
                                      const float* sig, int estride, int comp,
                                      long long start, float mean,
                                      const float* __restrict__ win, int N,
                                      int logN, bool imag) {
    stage(raw, sig, estride, comp, start, N + K - 1, K);
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const float v = (fir_point(raw + n, taps, K) - mean) * __ldg(win + n);
        if (imag)
            buf[bitrev(n, logN)].y = v;
        else
            buf[bitrev(n, logN)] = make_float2(v, 0.f);
    }
    __syncthreads();
}

// buf[bitrev(n)] = (fir(sig) - mean) * win for one segment.
__device__ inline void load_segment(float2* buf, float* raw, const float* taps,
                                    int K, const float* sig, int estride,
                                    int cplx, float mean_re, float mean_im,
                                    const float* __restrict__ win,
                                    long long start, int N, int logN) {
    load_component(buf, raw, taps, K, sig, estride, 0, start, mean_re, win, N,
                   logN, false);
    if (cplx)
        load_component(buf, raw, taps, K, sig, estride, 1, start, mean_im,
                       win, N, logN, true);
}

// In-place radix-2 decimation-in-time FFT of a bit-reversed buffer.
// tw[m] = exp(-2 pi i m / N), m < N/2.  Ends with a __syncthreads.
__device__ inline void fft_radix2(float2* buf, const float2* __restrict__ tw,
                                  int N, int logN) {
    for (int s = 1; s <= logN; ++s) {
        const int half = 1 << (s - 1);
        const int tstep = N >> s;
        for (int i = threadIdx.x; i < (N >> 1); i += blockDim.x) {
            const int p = i & (half - 1);
            const int a = ((i - p) << 1) + p;
            const int b = a + half;
            const float2 w = __ldg(tw + p * tstep);
            const float2 u = buf[a];
            const float2 v = buf[b];
            const float tr = v.x * w.x - v.y * w.y;
            const float ti = v.x * w.y + v.y * w.x;
            buf[a] = make_float2(u.x + tr, u.y + ti);
            buf[b] = make_float2(u.x - tr, u.y - ti);
        }
        __syncthreads();
    }
}
