// Kernel B: fused causal FIR + global-mean detrend + Welch cross-powers,
// and in its packed modes kernel H, the same for one real signal or one
// real pair with two real sequences per complex FFT.
//
// Replaces pyfft_tpu/ops/pallas_welch3.py::_v3_fused_kernel (with
// _assemble_rows and _chunk_math) and ::_v3_kernel, its sibling for an
// already-filtered signal; one kernel that takes any nt covers both.  It
// also replaces pyfft_tpu/ops/pallas_welch.py::_factored_kernel (the v2
// kernel, at the geometries v3's gate refuses): its domain covers them.
// The packed modes replace _v3_fused_kernel's lane-packing modes (vmask,
// paircross with _pair_reduce), reached from welch_auto_packed and
// welch_pair_packed.
//
// For segment s (start s*hop, s < navr) of each signal the block forms
//   v[n] = (fir(sig)[start+n] - mean) * win[n],   n < N = nwins,
// takes its N-point DFT V and accumulates, for the first nfreq bins,
//   col 0:      |X|^2
//   col c + 1:  |Y_c|^2,  Re(Y_c conj X),  Im(Y_c conj X)
// where X is the reference signal's transform.  Real signals (cplx = 0) are
// rows of float32; complex ones (cplx = 1) are interleaved complex64 and
// filter their real and imaginary parts separately.  The filtered signal
// never goes to device memory.
//
// Modes (how segments map to FFTs):
//   kOne:  one segment of one signal per FFT; grid (group) x (column).
//   kAuto: nch = 0, real: Z = FFT(a + i b) for segments a = 2p and
//          b = 2p + 1 of x, and |A_k|^2 + |B_k|^2 = (|Z_k|^2 +
//          |Z_{N-k}|^2) / 2.  An odd navr leaves the last segment alone
//          with a zero imaginary part, where the same formula gives |A_k|^2.
//   kPair: nch = 1, real: Z = FFT(x_s + i y_s), X_k = (Z_k + conj Z_{N-k})
//          / 2, Y_k = (Z_k - conj Z_{N-k}) / (2i); sums of |X|^2, |Y|^2 and
//          Y conj X.
// The packed modes run half the FFTs of kOne at nch = 0 or 1 (a third at
// nch = 1, where kOne's column 1 recomputes X) and keep bins 0..N/2.
//
// What bounds it on the card: per segment and column about
// 5*N*log2(N) flops of FFT (twice for c >= 1, whose block recomputes X)
// plus 2*K flops of filter per sample, all through shared memory, against
// about two reads of the signal (50% overlap).  The radix-2 passes are
// bound by shared-memory traffic and the __syncthreads between them.
// Design: grid (group of transforms) x (column); per transform one block
// stages N+K-1 raw samples in shared memory, filters them with fir_point
// (fir.cuh), subtracts the mean and windows them into a complex buffer in
// bit-reversed order, and runs an in-place radix-2 FFT with twiddles from a
// float64 host table (load_component, load_segment and fft_radix2,
// fft.cuh, shared with kernel C).  kOne keeps its bins of X in registers
// while the buffer is reused for Y_c.  The packed modes stage their two
// sequences one after the other through the one raw buffer (so nwins =
// 16384 fits beside the 128 KB complex buffer); thread t owns the bin pairs
// (j, N - j), j = t + b*blockDim.x < N/2 (bin 0 pairs with itself), and the
// thread of j = 0 also owns bin N/2, which pairs with itself.  Sums over
// segments are held in float64 registers; each block writes per-group
// partials in kOne's (column, 3, nfreq) layout, which sum_partials
// (reduce.cuh) sums in a fixed order and scales by `norm`.
#include <cuda_runtime.h>

#include "fft.cuh"
#include "reduce.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinN = 16;
constexpr int kMaxN = 16384;

constexpr int kOne = 0;
constexpr int kAuto = 1;
constexpr int kPair = 2;

// Sums per bin: kOne (a0, a1, a2) as written to its column; kAuto |X|^2;
// kPair |X|^2, |Y|^2, Re(Y conj X), Im(Y conj X).
template <int MODE>
struct Sums {
    static constexpr int n = MODE == kOne ? 3 : (MODE == kAuto ? 1 : 4);
};

// A packed mode's terms of bin k, from z = Z_k and w = Z_{N-k}.
template <int MODE>
__device__ __forceinline__ void accumulate_split(double* acc, float2 z,
                                                 float2 w) {
    const double zr = z.x, zi = z.y, wr = w.x, wi = w.y;
    if constexpr (MODE == kPair) {
        const double xr = 0.5 * (zr + wr), xi = 0.5 * (zi - wi);
        const double yr = 0.5 * (zi + wi), yi = 0.5 * (wr - zr);
        acc[0] += xr * xr + xi * xi;
        acc[1] += yr * yr + yi * yi;
        acc[2] += yr * xr + yi * xi;
        acc[3] += yi * xr - yr * xi;
    } else {
        acc[0] += 0.5 * (zr * zr + zi * zi + wr * wr + wi * wi);
    }
}

// Bin k's sums into this block's (columns, 3, nfreq) slice of `part`.
template <int MODE>
__device__ __forceinline__ void store(double* out, int nfreq, int k,
                                      const double* v) {
    if constexpr (MODE == kOne) {
        out[k] = v[0];
        out[nfreq + k] = v[1];
        out[2 * nfreq + k] = v[2];
    } else {
        out[k] = v[0];
        out[nfreq + k] = 0.0;
        out[2 * nfreq + k] = 0.0;
    }
    if constexpr (MODE == kPair) {
        out[3 * nfreq + k] = v[1];
        out[4 * nfreq + k] = v[2];
        out[5 * nfreq + k] = v[3];
    }
}

// B = bins per thread (kOne: bin k of thread t is t + b*blockDim.x) or bin
// pairs per thread (packed modes).
template <int B, int MODE>
__global__ void __launch_bounds__(kMaxThreads, (B <= 4) ? 2 : 1)
welch_kernel(const float* __restrict__ x, const float* __restrict__ y,
             long long y_row_stride, int estride, int cplx,
             const float* __restrict__ taps_g, int K,
             const float* __restrict__ means, const float* __restrict__ win,
             const float2* __restrict__ tw, double* __restrict__ part, int N,
             int logN, int hop, int navr, int per_group, int nfreq) {
    constexpr int R = Sums<MODE>::n;
    extern __shared__ __align__(16) unsigned char smem[];
    float2* buf = reinterpret_cast<float2*>(smem);
    float* raw = reinterpret_cast<float*>(buf + N);
    float* taps = raw + N + K - 1;
    const int col = blockIdx.y;
    const int T = blockDim.x;
    const int half = N >> 1;
    for (int k = threadIdx.x; k < K; k += T) taps[k] = taps_g[k];
    // (load_component synchronises before the first read of `taps`)

    // the other signal of this block: column `col`'s, or the pair's
    const int other = MODE == kPair ? 1 : col;
    const int nc = cplx ? 2 : 1;
    const float mx_re = means[0];
    const float mx_im = cplx ? means[1] : 0.f;
    const float* ysig =
        other ? y + static_cast<long long>(other - 1) * y_row_stride : nullptr;
    const float my_re = other ? means[nc * other] : 0.f;
    const float my_im = (other && cplx) ? means[nc * other + 1] : 0.f;

    double acc[B][R], nyq[R];
    float xre[B], xim[B];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        nyq[r] = 0.0;
#pragma unroll
        for (int b = 0; b < B; ++b) acc[b][r] = 0.0;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) xre[b] = xim[b] = 0.f;

    const int nffts = MODE == kAuto ? (navr + 1) / 2 : navr;
    const int f0 = blockIdx.x * per_group;
    const int f1 = min(nffts, f0 + per_group);
    for (int f = f0; f < f1; ++f) {
        if constexpr (MODE != kOne) {
            const long long start =
                static_cast<long long>(MODE == kAuto ? 2 * f : f) * hop;
            load_component(buf, raw, taps, K, x, 1, 0, start, mx_re, win, N,
                           logN, false);
            if (MODE == kPair)
                load_component(buf, raw, taps, K, ysig, 1, 0, start, my_re,
                               win, N, logN, true);
            else if (2 * f + 1 < navr)
                load_component(buf, raw, taps, K, x, 1, 0, start + hop, mx_re,
                               win, N, logN, true);
            fft_radix2(buf, tw, N, logN);
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const int j = threadIdx.x + b * T;
                if (j < half)
                    accumulate_split<MODE>(acc[b], buf[j],
                                           buf[(N - j) & (N - 1)]);
            }
            if (threadIdx.x == 0)
                accumulate_split<MODE>(nyq, buf[half], buf[half]);
            __syncthreads();
        } else {
            const long long start = static_cast<long long>(f) * hop;
            load_segment(buf, raw, taps, K, x, estride, cplx, mx_re, mx_im, win,
                         start, N, logN);
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
            load_segment(buf, raw, taps, K, ysig, estride, cplx, my_re, my_im,
                         win, start, N, logN);
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
    }

    constexpr int kCols = MODE == kPair ? 2 : 1;
    double* out =
        part + (static_cast<long long>(blockIdx.x) * gridDim.y * kCols + col) *
                   3 * nfreq;
    const int nown = MODE == kOne ? nfreq : half;
#pragma unroll
    for (int b = 0; b < B; ++b) {
        const int k = threadIdx.x + b * T;
        if (k < nown && k < nfreq) store<MODE>(out, nfreq, k, acc[b]);
    }
    if (MODE != kOne && threadIdx.x == 0 && half < nfreq)
        store<MODE>(out, nfreq, half, nyq);
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

template <int B, int MODE>
int launch(const Geometry& geo, dim3 grid, cudaStream_t stream,
           const float* x, const float* y, long long y_row_stride,
           int estride, int cplx, const float* taps, int K,
           const float* means, const float* win, const float2* tw,
           double* part, int N, int hop, int navr, int per_group, int nfreq) {
    cudaError_t e = cudaFuncSetAttribute(
        welch_kernel<B, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(geo.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    welch_kernel<B, MODE><<<grid, geo.threads, geo.smem, stream>>>(
        x, y, y_row_stride, estride, cplx, taps, K, means, win, tw, part, N,
        geo.logN, hop, navr, per_group, nfreq);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one block of welch_kernel needs.
extern "C" long long pyfft_welch_smem_bytes(int nwins, int K) {
    return static_cast<long long>(geometry(nwins, K).smem);
}

// x: reference signal, y: nch signals with row stride `y_row_stride`
// floats; `estride` is 1 (float32 rows) or 2 (interleaved complex64, with
// cplx = 1).  means: (nch+1) * (1 + cplx) float32, reference first.
// win: (nwins,) float32.  tw: (nwins/2,) complex64.  part: (ngroups,
// nch+1, 3, nfreq) float64 scratch.  out: (nch+1, 3, nfreq) float32.
// packed = 1 runs kAuto (nch = 0) or kPair (nch = 1) on real signals, with
// nfreq <= nwins/2 + 1 and ngroups groups of transforms (ceil(navr/2) of
// them for kAuto, navr for kPair).  Returns cudaGetLastError() after the
// second launch (or the first error).
extern "C" int pyfft_welch(const float* x, const float* y,
                           long long y_row_stride, int estride, int cplx,
                           const float* taps, int K, const float* means,
                           const float* win, const void* tw, double* part,
                           float* out, int nch, int nwins, int hop, int navr,
                           int ngroups, int nfreq, int packed, double norm,
                           void* stream_ptr) {
    const int N = nwins;
    if (N < kMinN || N > kMaxN || (N & (N - 1)) || K < 1 || K > kFirMaxTaps ||
        hop < 1 || hop > N || navr < 1 || ngroups < 1 || nch < 0 ||
        nch + 1 > 65535 || nfreq < 1 || nfreq > N ||
        estride != 1 + (cplx ? 1 : 0) || (packed != 0 && packed != 1) ||
        (packed && (cplx || nch > 1 || nfreq > N / 2 + 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Geometry geo = geometry(N, K);
    const int mode = packed ? (nch ? kPair : kAuto) : kOne;
    // packed modes: bin pairs per thread, so that B * threads >= N/2
    const int B = packed ? (geo.bins > 1 ? geo.bins / 2 : 1) : geo.bins;
    const int nffts = mode == kAuto ? (navr + 1) / 2 : navr;
    const int per_group = (nffts + ngroups - 1) / ngroups;
    const dim3 grid(static_cast<unsigned>(ngroups),
                    static_cast<unsigned>(packed ? 1 : nch + 1));
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float2* twf = static_cast<const float2*>(tw);
    int rc;
    switch (B * 4 + mode) {
#define PYFFT_WELCH_CASE(BV, MV)                                             \
    case BV * 4 + MV:                                                        \
        rc = launch<BV, MV>(geo, grid, stream, x, y, y_row_stride, estride,  \
                            cplx, taps, K, means, win, twf, part, N, hop,    \
                            navr, per_group, nfreq);                         \
        break;
        PYFFT_WELCH_CASE(1, kOne)
        PYFFT_WELCH_CASE(2, kOne)
        PYFFT_WELCH_CASE(4, kOne)
        PYFFT_WELCH_CASE(8, kOne)
        PYFFT_WELCH_CASE(16, kOne)
        PYFFT_WELCH_CASE(32, kOne)
        PYFFT_WELCH_CASE(1, kAuto)
        PYFFT_WELCH_CASE(2, kAuto)
        PYFFT_WELCH_CASE(4, kAuto)
        PYFFT_WELCH_CASE(8, kAuto)
        PYFFT_WELCH_CASE(16, kAuto)
        PYFFT_WELCH_CASE(1, kPair)
        PYFFT_WELCH_CASE(2, kPair)
        PYFFT_WELCH_CASE(4, kPair)
        PYFFT_WELCH_CASE(8, kPair)
        PYFFT_WELCH_CASE(16, kPair)
#undef PYFFT_WELCH_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
    const long long per_part = static_cast<long long>(nch + 1) * 3 * nfreq;
    return launch_sum_partials(part, out, ngroups, per_part, norm, stream);
}
