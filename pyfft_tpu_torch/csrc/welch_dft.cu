// Kernel E: Welch cross-powers at any segment length.
//
// Replaces pyfft_tpu/ops/pallas_welch.py::_accum_kernel (launched by
// _welch_power_call for welch_pallas_fused and welch_power_pallas), with
// the reference spectrum the JAX package computes in XLA beside it.
//
// For segment s (start s*hop, s < navr) of each signal the block forms
//   v[n] = (sig[start+n] - mean - slope*(start+n - tbar)) * win[n],
// n < N = nwins, takes its N-point DFT V and, for the first nfreq bins,
// accumulates
//   col 0:      |X|^2
//   col c + 1:  |Y_c|^2,  Re(Y_c conj X),  Im(Y_c conj X)
// where X is the reference signal's transform.  mean and slope (float64,
// from the caller's prologue) give the global mean (slope 0), the global
// least-squares line, or nothing (both 0).
//
// The DFT of any length: for N a power of two an N-point radix-2 FFT;
// otherwise Bluestein's algorithm on M-point radix-2 FFTs, M the least
// power of two >= 2N - 1.  With w[n] = exp(-i pi n^2 / N),
//   V[k] = w[k]/M * conj(FFT_M(conj(FFT_M(a) * F)))[k],
//   a[n] = v[n] * w[n] zero-padded to M,
// F the M-point FFT of the chirp filter conj(w[|m|]), |m| < N.  The caller
// builds pre[n] = win[n] * w[n] (window folded in), F and post[k] = w[k]/M
// in float64 on the host from the exact integer n^2 mod 2N, then rounds
// them to complex64.
//
// What bounds it on the card: per segment and signal two M-point FFTs,
// about 10*M*log2(M) flops through shared memory with one barrier per
// stage (TPU #7 instead did a dense (seg, N) @ (N, nfreq) product, O(N)
// flops per sample: 243 GFLOP at the heat-pulse geometry against 12 for
// the Bluestein FFTs), against one read of the signal.  As for kernels B
// and C, the shared-memory passes are the likely cost, not device memory.
// Design: two passes and a fixed-order sum.
//   1. dft_reference: one block per segment computes X and stores its
//      nfreq bins (complex64) in device memory, so X is computed once per
//      segment (kernel B recomputes it for every channel: about 45% of its
//      time at bench config 0).
//   2. dft_accumulate: grid (group of segments) x (column); column 0 sums
//      |X|^2 from the stored spectra, column c + 1 computes Y_c per segment
//      and sums against the stored X.  Sums are float64 registers, B bins
//      per thread; each block writes per-group partials.
//   3. sum_partials (reduce.cuh) adds the groups in order and scales by
//      `norm`: the result is deterministic.
// A block holds one M-point complex64 buffer in shared memory (128 KB at
// M = 16384: one block per SM).  The FFT is fft.cuh's radix-2 DIT (shared
// with kernels B, C and D); its inverse is conj(FFT(conj(.))), with the
// filter product, the conjugation and the bit-reversed reordering fused
// into one pass over shared memory, as in kernel D.
#include <cuda_runtime.h>

#include "fft.cuh"
#include "reduce.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 8192;
constexpr int kMaxM = 16384;

// The spectrum of one segment of `sig`, left in `buf` (M complex64): bin k
// is then spectrum_bin(buf, post, k, M != N).  Ends with a __syncthreads.
__device__ inline void segment_dft(float2* buf, const float* __restrict__ sig,
                                   long long start, double mean, double slope,
                                   double tbar,
                                   const float2* __restrict__ pre,
                                   const float2* __restrict__ filt,
                                   const float2* __restrict__ tw, int N, int M,
                                   int logM) {
    for (int n = threadIdx.x; n < M; n += blockDim.x) {
        float2 v = make_float2(0.f, 0.f);
        if (n < N) {
            const long long t = start + n;
            const double trend =
                mean + slope * (static_cast<double>(t) - tbar);
            const float d = __ldg(sig + t) - static_cast<float>(trend);
            const float2 p = __ldg(pre + n);
            v = make_float2(d * p.x, d * p.y);
        }
        buf[logM ? bitrev(n, logM) : n] = v;   // (bitrev needs logM >= 1)
    }
    __syncthreads();
    fft_radix2(buf, tw, M, logM);
    if (M == N) return;
    // conj(A * F) into bit-reversed order for the second FFT: the thread
    // with i <= bitrev(i) owns the pair (i, bitrev(i))
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const int j = bitrev(i, logM);
        if (i <= j) {
            const float2 a = buf[i];
            const float2 b = buf[j];
            const float2 fi = __ldg(filt + i);
            const float2 fj = __ldg(filt + j);
            buf[j] = make_float2(a.x * fi.x - a.y * fi.y,
                                 -(a.x * fi.y + a.y * fi.x));
            buf[i] = make_float2(b.x * fj.x - b.y * fj.y,
                                 -(b.x * fj.y + b.y * fj.x));
        }
    }
    __syncthreads();
    fft_radix2(buf, tw, M, logM);
}

// Bin k of the segment spectrum that segment_dft left in `buf`.
__device__ __forceinline__ float2 spectrum_bin(const float2* buf,
                                               const float2* __restrict__ post,
                                               int k, bool bluestein) {
    const float2 z = buf[k];
    if (!bluestein) return z;
    const float2 p = __ldg(post + k);
    // post[k] * conj(z)
    return make_float2(p.x * z.x + p.y * z.y, p.y * z.x - p.x * z.y);
}

// Pass 1: the reference spectrum of segment blockIdx.x into xs[s, :nfreq].
__global__ void __launch_bounds__(kMaxThreads)
dft_reference(const float* __restrict__ x, const double* __restrict__ mean,
              const double* __restrict__ slope, double tbar,
              const float2* __restrict__ pre, const float2* __restrict__ filt,
              const float2* __restrict__ post, const float2* __restrict__ tw,
              float2* __restrict__ xs, int N, int M, int logM, int hop,
              int nfreq) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* buf = reinterpret_cast<float2*>(smem);
    const int s = blockIdx.x;
    segment_dft(buf, x, static_cast<long long>(s) * hop, mean[0], slope[0],
                tbar, pre, filt, tw, N, M, logM);
    float2* row = xs + static_cast<long long>(s) * nfreq;
    for (int k = threadIdx.x; k < nfreq; k += blockDim.x)
        row[k] = spectrum_bin(buf, post, k, M != N);
}

// Pass 2.  B = bins per thread; bin k of thread t is t + b*blockDim.x.
template <int B>
__global__ void __launch_bounds__(kMaxThreads, 1)
dft_accumulate(const float* __restrict__ y, long long y_row_stride,
               const double* __restrict__ mean,
               const double* __restrict__ slope, double tbar,
               const float2* __restrict__ pre, const float2* __restrict__ filt,
               const float2* __restrict__ post, const float2* __restrict__ tw,
               const float2* __restrict__ xs, double* __restrict__ part,
               int N, int M, int logM, int hop, int navr, int seg_per_group,
               int nfreq) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* buf = reinterpret_cast<float2*>(smem);
    const int col = blockIdx.y;
    const int T = blockDim.x;
    const bool bluestein = M != N;
    const float* sig =
        col ? y + static_cast<long long>(col - 1) * y_row_stride : nullptr;

    double a0[B], a1[B], a2[B];
#pragma unroll
    for (int b = 0; b < B; ++b) a0[b] = a1[b] = a2[b] = 0.0;

    const int s0 = blockIdx.x * seg_per_group;
    const int s1 = min(navr, s0 + seg_per_group);
    for (int s = s0; s < s1; ++s) {
        const float2* xrow = xs + static_cast<long long>(s) * nfreq;
        if (col == 0) {
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const int k = threadIdx.x + b * T;
                if (k < nfreq) {
                    const float2 z = xrow[k];
                    a0[b] += static_cast<double>(z.x) * z.x +
                             static_cast<double>(z.y) * z.y;
                }
            }
            continue;
        }
        segment_dft(buf, sig, static_cast<long long>(s) * hop, mean[col],
                    slope[col], tbar, pre, filt, tw, N, M, logM);
#pragma unroll
        for (int b = 0; b < B; ++b) {
            const int k = threadIdx.x + b * T;
            if (k < nfreq) {
                const float2 z = spectrum_bin(buf, post, k, bluestein);
                const float2 xz = xrow[k];
                const double yr = z.x, yi = z.y;
                const double xr = xz.x, xi = xz.y;
                a0[b] += yr * yr + yi * yi;
                a1[b] += yr * xr + yi * xi;
                a2[b] += yi * xr - yr * xi;
            }
        }
        __syncthreads();  // before the next segment overwrites buf
    }

    double* out = part +
                  (static_cast<long long>(blockIdx.x) * gridDim.y + col) * 3 *
                      nfreq;
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int k = threadIdx.x + b * T;
        if (k < nfreq) {
            out[k] = a0[b];
            out[nfreq + k] = a1[b];
            out[2 * nfreq + k] = a2[b];
        }
    }
}

int threads_for(int M) {
    return M / 4 < 32 ? 32 : (M / 4 > kMaxThreads ? kMaxThreads : M / 4);
}

template <int B>
int launch_accumulate(dim3 grid, int threads, size_t smem,
                      cudaStream_t stream, const float* y,
                      long long y_row_stride, const double* mean,
                      const double* slope, double tbar, const float2* pre,
                      const float2* filt, const float2* post,
                      const float2* tw, const float2* xs, double* part, int N,
                      int M, int logM, int hop, int navr, int spg,
                      int nfreq) {
    cudaError_t e = cudaFuncSetAttribute(
        dft_accumulate<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dft_accumulate<B><<<grid, threads, smem, stream>>>(
        y, y_row_stride, mean, slope, tbar, pre, filt, post, tw, xs, part, N,
        M, logM, hop, navr, spg, nfreq);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: reference signal (float32, contiguous), y: nch signals with row
// stride `y_row_stride` floats.  mean, slope: (nch+1,) float64, reference
// first; tbar = (nt - 1) / 2.  pre: (nwins,) complex64 (window times
// chirp, or the window alone when M == nwins).  filt: (M,) and post:
// (nwins,) complex64, unused (may be null) when M == nwins.  tw: (M/2,)
// complex64, tw[m] = exp(-2 pi i m / M).  xs: (navr, nfreq) complex64
// scratch.  part: (ngroups, nch+1, 3, nfreq) float64 scratch.  out:
// (nch+1, 3, nfreq) float32.  Returns cudaGetLastError() after the last
// launch (or the first error).
extern "C" int pyfft_welch_dft(const float* x, const float* y,
                               long long y_row_stride, const double* mean,
                               const double* slope, double tbar,
                               const void* pre, const void* filt,
                               const void* post, const void* tw, void* xs,
                               double* part, float* out, int nch, int nwins,
                               int M, int hop, int navr, int ngroups,
                               int nfreq, double norm, void* stream_ptr) {
    const int N = nwins;
    const bool pow2 = (N & (N - 1)) == 0;
    if (N < 1 || N > kMaxN || M < 1 || M > kMaxM || (M & (M - 1)) ||
        (pow2 ? M != N : M < 2 * N - 1) || hop < 1 || navr < 1 ||
        ngroups < 1 || ngroups > navr || nch < 0 || nch + 1 > 65535 ||
        nfreq < 1 || nfreq > N / 2 + 1 || (M != N && (!filt || !post)))
        return static_cast<int>(cudaErrorInvalidValue);
    int logM = 0;
    while ((1 << logM) < M) ++logM;
    const int threads = threads_for(M);
    const size_t smem = sizeof(float2) * M;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float2* pref = static_cast<const float2*>(pre);
    const float2* filtf = static_cast<const float2*>(filt);
    const float2* postf = static_cast<const float2*>(post);
    const float2* twf = static_cast<const float2*>(tw);
    float2* xsf = static_cast<float2*>(xs);

    cudaError_t e = cudaFuncSetAttribute(
        dft_reference, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    dft_reference<<<static_cast<unsigned>(navr), threads, smem, stream>>>(
        x, mean, slope, tbar, pref, filtf, postf, twf, xsf, N, M, logM, hop,
        nfreq);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;

    const int spg = (navr + ngroups - 1) / ngroups;
    const dim3 grid(static_cast<unsigned>(ngroups),
                    static_cast<unsigned>(nch + 1));
    const int bins = (nfreq + threads - 1) / threads;
#define PYFFT_WELCH_DFT_ARGS                                                  \
    grid, threads, smem, stream, y, y_row_stride, mean, slope, tbar, pref,    \
        filtf, postf, twf, xsf, part, N, M, logM, hop, navr, spg, nfreq
    if (bins <= 1)
        rc = launch_accumulate<1>(PYFFT_WELCH_DFT_ARGS);
    else if (bins <= 2)
        rc = launch_accumulate<2>(PYFFT_WELCH_DFT_ARGS);
    else if (bins <= 3)
        rc = launch_accumulate<3>(PYFFT_WELCH_DFT_ARGS);
    else if (bins <= 5)
        rc = launch_accumulate<5>(PYFFT_WELCH_DFT_ARGS);
    else if (bins <= 9)
        rc = launch_accumulate<9>(PYFFT_WELCH_DFT_ARGS);
    else
        return static_cast<int>(cudaErrorInvalidValue);
#undef PYFFT_WELCH_DFT_ARGS
    if (rc != 0) return rc;
    const long long per_group = static_cast<long long>(nch + 1) * 3 * nfreq;
    return launch_sum_partials(part, out, ngroups, per_group, norm, stream);
}
