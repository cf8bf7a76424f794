// Kernel B for complex signals: fused causal FIR + global-mean detrend +
// two-sided Welch cross-powers.  Real signals take welch_pair.cu.
//
// Replaces, for complex (two-sided) signals, pyfft_tpu/ops/pallas_welch3.py::
// _v3_fused_kernel (with _assemble_rows and _chunk_math) and ::_v3_kernel,
// its sibling for an already-filtered signal (welch_pallas3_twosided); one
// kernel that takes any nt covers both.
//
// For segment s (start s*hop, s < navr) of each signal the block forms
//   v[n] = (fir(sig)[start+n] - mean) * win[n],   n < N = nwins,
// takes its N-point DFT V and accumulates, for the first nfreq bins,
//   col 0:      |X|^2
//   col c + 1:  |Y_c|^2,  Re(Y_c conj X),  Im(Y_c conj X)
// where X is the reference signal's transform.  Signals are interleaved
// complex64 and filter their real and imaginary parts separately
// (load_segment with cplx = 1).  The filtered signal never goes to device
// memory.  One segment of one signal per FFT; grid (group) x (column).
//
// What bounds it on the card: per segment and column about
// 5*N*log2(N) flops of FFT (twice for c >= 1, whose block recomputes X)
// plus 2*K flops of filter per sample and component, all through shared
// memory, against about two reads of the signal (50% overlap).  The
// radix-2 passes are bound by shared-memory traffic and the __syncthreads
// between them.  Design: grid (group of segments) x (column); per segment
// one block stages N+K-1 raw samples in shared memory, filters them with
// fir_point (fir.cuh), subtracts the mean and windows them into a complex
// buffer in bit-reversed order, and runs an in-place radix-2 FFT with
// twiddles from a float64 host table (load_segment and fft_radix2,
// fft.cuh).  A column c >= 1 keeps its bins of X in registers while the
// buffer is reused for Y_c.  Sums over segments are held in float64
// registers; each block writes per-group partials in the (column, 3,
// nfreq) layout, which sum_partials (reduce.cuh) sums in a fixed order and
// scales by `norm`.
#include <cuda_runtime.h>

#include "fft.cuh"
#include "reduce.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinN = 16;
constexpr int kMaxN = 16384;

// Bin k's sums into this block's (columns, 3, nfreq) slice of `part`.
__device__ __forceinline__ void store(double* out, int nfreq, int k,
                                      const double* v) {
    out[k] = v[0];
    out[nfreq + k] = v[1];
    out[2 * nfreq + k] = v[2];
}

// B = bins per thread: bin k of thread t is t + b*blockDim.x.
template <int B>
__global__ void __launch_bounds__(kMaxThreads, (B <= 4) ? 2 : 1)
welch_kernel(const float* __restrict__ x, const float* __restrict__ y,
             long long y_row_stride, const float* __restrict__ taps_g, int K,
             const float* __restrict__ means, const float* __restrict__ win,
             const float2* __restrict__ tw, double* __restrict__ part, int N,
             int logN, int hop, int navr, int per_group, int nfreq) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* buf = reinterpret_cast<float2*>(smem);
    float* raw = reinterpret_cast<float*>(buf + N);
    float* taps = raw + N + K - 1;
    const int col = blockIdx.y;
    const int T = blockDim.x;
    for (int k = threadIdx.x; k < K; k += T) taps[k] = taps_g[k];
    // (load_component synchronises before the first read of `taps`)

    const float mx_re = means[0];
    const float mx_im = means[1];
    const float* ysig =
        col ? y + static_cast<long long>(col - 1) * y_row_stride : nullptr;
    const float my_re = col ? means[2 * col] : 0.f;
    const float my_im = col ? means[2 * col + 1] : 0.f;

    double acc[B][3];
    float xre[B], xim[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
        acc[b][0] = acc[b][1] = acc[b][2] = 0.0;
        xre[b] = xim[b] = 0.f;
    }

    const int f0 = blockIdx.x * per_group;
    const int f1 = min(navr, f0 + per_group);
    for (int f = f0; f < f1; ++f) {
        const long long start = static_cast<long long>(f) * hop;
        load_segment(buf, raw, taps, K, x, 2, 1, mx_re, mx_im, win, start, N,
                     logN);
        fft_radix2(buf, tw, N, logN);
        if (col == 0) {
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const int k = threadIdx.x + b * T;
                if (k < nfreq) {
                    const float2 z = buf[k];
                    acc[b][0] += static_cast<double>(z.x) * z.x +
                                 static_cast<double>(z.y) * z.y;
                }
            }
            __syncthreads();
            continue;
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
            const int k = threadIdx.x + b * T;
            if (k < nfreq) {
                xre[b] = buf[k].x;
                xim[b] = buf[k].y;
            }
        }
        __syncthreads();
        load_segment(buf, raw, taps, K, ysig, 2, 1, my_re, my_im, win, start,
                     N, logN);
        fft_radix2(buf, tw, N, logN);
#pragma unroll
        for (int b = 0; b < B; ++b) {
            const int k = threadIdx.x + b * T;
            if (k < nfreq) {
                const double yr = buf[k].x, yi = buf[k].y;
                const double xr = xre[b], xi = xim[b];
                acc[b][0] += yr * yr + yi * yi;
                acc[b][1] += yr * xr + yi * xi;
                acc[b][2] += yi * xr - yr * xi;
            }
        }
        __syncthreads();
    }

    double* out =
        part + (static_cast<long long>(blockIdx.x) * gridDim.y + col) * 3 *
                   nfreq;
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int k = threadIdx.x + b * T;
        if (k < nfreq) store(out, nfreq, k, acc[b]);
    }
}

struct Geometry {
    int threads, bins, logN;
    size_t smem;
};

Geometry geometry(int N, int K) {
    Geometry g;
    g.threads = N / 4 < 32 ? 32 : (N / 4 > kMaxThreads ? kMaxThreads : N / 4);
    g.bins = (N + g.threads - 1) / g.threads;
    g.logN = 0;
    while ((1 << g.logN) < N) ++g.logN;
    g.smem = sizeof(float2) * N + sizeof(float) * (N + K - 1) +
             sizeof(float) * K;
    return g;
}

template <int B>
int launch(const Geometry& geo, dim3 grid, cudaStream_t stream,
           const float* x, const float* y, long long y_row_stride,
           const float* taps, int K,
           const float* means, const float* win, const float2* tw,
           double* part, int N, int hop, int navr, int per_group, int nfreq) {
    cudaError_t e = cudaFuncSetAttribute(
        welch_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(geo.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    welch_kernel<B><<<grid, geo.threads, geo.smem, stream>>>(
        x, y, y_row_stride, taps, K, means, win, tw, part, N,
        geo.logN, hop, navr, per_group, nfreq);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: reference signal, y: nch signals with row stride `y_row_stride`
// floats, interleaved complex64.  means: (nch+1) * 2 float32 (re, im),
// reference first.  win: (nwins,) float32.  tw: (nwins/2,) complex64.
// part: (ngroups, nch+1, 3, nfreq) float64 scratch.  out: (nch+1, 3,
// nfreq) float32.  Returns cudaGetLastError() after the second launch (or
// the first error).
extern "C" int pyfft_welch(const float* x, const float* y,
                           long long y_row_stride, const float* taps, int K,
                           const float* means, const float* win,
                           const void* tw, double* part, float* out, int nch,
                           int nwins, int hop, int navr, int ngroups,
                           int nfreq, double norm, void* stream_ptr) {
    const int N = nwins;
    if (N < kMinN || N > kMaxN || (N & (N - 1)) || K < 1 || K > kFirMaxTaps ||
        hop < 1 || hop > N || navr < 1 || ngroups < 1 || nch < 0 ||
        nch + 1 > 65535 || nfreq < 1 || nfreq > N)
        return static_cast<int>(cudaErrorInvalidValue);
    const Geometry geo = geometry(N, K);
    const int per_group = (navr + ngroups - 1) / ngroups;
    const dim3 grid(static_cast<unsigned>(ngroups),
                    static_cast<unsigned>(nch + 1));
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float2* twf = static_cast<const float2*>(tw);
    int rc;
    switch (geo.bins) {
#define PYFFT_WELCH_CASE(BV)                                                 \
    case BV:                                                                 \
        rc = launch<BV>(geo, grid, stream, x, y, y_row_stride, taps, K,      \
                        means, win, twf, part, N, hop, navr, per_group,      \
                        nfreq);                                              \
        break;
        PYFFT_WELCH_CASE(1)
        PYFFT_WELCH_CASE(2)
        PYFFT_WELCH_CASE(4)
        PYFFT_WELCH_CASE(8)
        PYFFT_WELCH_CASE(16)
        PYFFT_WELCH_CASE(32)
#undef PYFFT_WELCH_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
    const long long per_part = static_cast<long long>(nch + 1) * 3 * nfreq;
    return launch_sum_partials(part, out, ngroups, per_part, norm, stream);
}
