// Kernel B for complex signals: fused causal FIR + global-mean detrend +
// two-sided Welch cross-powers.  Real signals take welch_pair.cu.
//
// Replaces, for complex (two-sided) signals, pyfft_tpu/ops/pallas_welch3.py::
// _v3_fused_kernel (with _assemble_rows and _chunk_math, cplx=True) and
// ::_v3_kernel, its sibling for an already-filtered signal
// (welch_pallas3_twosided); one kernel that takes any nt covers both.
//
// For segment s (start s*hop, s < navr) of each complex signal it forms
//   v[n] = (fir(sig)[start+n] - mean) * win[n],   n < N = nwins,
// the real taps filtering the real and imaginary parts apart, and
// accumulates, for the first nfreq bins of the N-point DFTs,
//   col 0:      |X|^2
//   col c + 1:  |Y_c|^2,  Re(Y_c conj X),  Im(Y_c conj X)
// where X is the reference x's transform.  The filtered signal never goes
// to device memory.
//
// A unit is two transforms, A and B:
//   pair (nch >= 1): unit s of channel c is A = x_s, B = y_{c,s}.  Every
//     channel's items transform x again (2 nch transforms a segment); only
//     channel 1's keep |X|^2.
//   auto (nch = 0): unit p is A = x_{2p}, B = x_{2p+1}, both powers added;
//     an odd navr leaves the last segment alone (B = 0).
// A complex sequence fills its transform alone, so, unlike welch_pair.cu,
// no sequence needs a scale of its own.
//
// What bounds it on the card.  At the Doppler IQ geometry (9 complex
// signals of 2^24 samples, N = 4096, hop 2048, no taps) the signals take
// 1.2 GB, 0.36 ms at 3.35 TB/s; the 131k transforms of 4096 points (2 nch
// a segment) and their float64 sums take 13 times that, through shared
// memory and the barriers between the passes, one block an SM (PERF.md).
// Design:
// - up to N = 8192 a block of 2 N/16 threads runs A and B side by side, the
//   first N/16 threads A and the others B, each on fft_reg.cuh's
//   register-radix Stockham FFT (16 points a thread) through a pad(N)
//   buffer of its own, so no spectrum is held while the other is made;
//   then each thread of the block reads A_k and B_k of its 8 bins k = i +
//   b*2N/16 from the two buffers and adds the terms to float64 sums: |B|^2,
//   Re and Im in registers (24 a thread), |A|^2 in shared memory (N float64
//   a block, each thread its own bins; on an H100 1.4-4% faster than all 32
//   in registers, which spilled 368-380 bytes at N = 2048 and 4096).
//   ptxas: 128 registers, 252-256 bytes spilled at N = 2048 and 4096 (2
//   and 1 blocks an SM), 64 registers and 912 at 8192.
// - at N = 16384 (1024 threads a transform, no room for two buffers) the
//   block runs A, holds its 16 bins a thread in registers, runs B through
//   the same buffer, and keeps the float64 sums in the item's slice of
//   `part` in device memory (64 registers, 1408 bytes spilled).
// - persistent blocks over (segment group, channel) items, as many as the
//   card holds at once (found once per device and taps count); the
//   channels of one group run side by side and share x in L2.
// - without taps (K = 1) thread t's point r is sample start + t + r*N/16,
//   read as a float2 straight into the first pass's registers while the
//   last unit's sums are made (on an H100 9% less device time at N =
//   4096), the tap, the mean and the window applied there; with taps each
//   unit stages its sequences' whole spans (N + K - 1 samples, real and
//   imaginary parts apart) over the FFT buffers and filters them with
//   fir.cuh's fir_pair, fir_point's products in fir_point's order.
// - each item writes its group's partials in the (ngroups, nch + 1, 3,
//   nfreq) layout, which sum_partials (reduce.cuh) sums in a fixed order
//   and scales by `norm`.
#include <cuda_runtime.h>

#include <climits>

#include "fft_reg.cuh"
#include "fir.cuh"
#include "reduce.cuh"

namespace {

constexpr int kMinLogN = 4;
constexpr int kMaxLogN = 14;
constexpr int kSideMaxLogN = 13;   // the largest N run side by side
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr bool side_by_side(int logn) {
    return logn <= kSideMaxLogN;
}

// N/16 threads a transform; two transforms a block where they fit.
__host__ __device__ constexpr int block_threads(int logn) {
    return ((1 << logn) / fftreg::kPoints) * (side_by_side(logn) ? 2 : 1);
}

// Blocks an SM should hold: about 16 warps (a thread keeps 32 float64 sums
// and 16 complex points, about 128 registers; a block of fewer than 32
// threads still takes a warp's registers).
__host__ __device__ constexpr int min_blocks(int logn) {
    return block_threads(logn) >= 512 ? 1
           : block_threads(logn) <= 32 ? 16
                                       : 512 / block_threads(logn);
}

// Floats one staged sequence takes: N + K - 1 samples, rounded to 16 bytes.
__host__ __device__ constexpr int seq_floats(int logn, int K) {
    return ((1 << logn) + K + 2) & ~3;
}

// Floats of the region that holds the FFT buffers (pad(N) float2 a
// transform) and, with taps, before each transform the staged spans (the
// real and the imaginary part of each sequence).
__host__ __device__ constexpr int region_floats(int logn, int K) {
    return (side_by_side(logn) ? 2 : 1) *
           (K > 1 && 2 * seq_floats(logn, K) > 2 * fftreg::pad(1 << logn)
                ? 2 * seq_floats(logn, K)
                : 2 * fftreg::pad(1 << logn));
}

// Floats of the |X|^2 sums a block keeps in shared memory (N float64 side
// by side, none at 16384).
__host__ __device__ constexpr int xx_floats(int logn) {
    return side_by_side(logn) ? 2 << logn : 0;
}

// Shared memory: the region, the |X|^2 sums, then the taps (with taps).
size_t smem_bytes(int logn, int K) {
    return sizeof(float) *
           (region_floats(logn, K) + xx_floats(logn) + (K > 1 ? K : 0));
}

// re[j], im[j] = sig[from - (K - 1) + j] for j < count, zeros before the
// signal; by the T threads of one transform (index t).
template <int T>
__device__ __forceinline__ void stage(float* re, float* im, const float2* sig,
                                      long long from, int count, int K,
                                      int t) {
    const long long first = from - (K - 1);
    for (int j = t; j < count; j += T) {
        const long long i = first + j;
        const float2 z = i >= 0 ? __ldg(sig + i) : make_float2(0.f, 0.f);
        re[j] = z.x;
        im[j] = z.y;
    }
}

// Thread t's pass-0 samples of one sequence, start + t + r*T of sig, as
// they are (K = 1).
template <int T>
__device__ __forceinline__ void load_points(float2 (&v)[fftreg::kPoints],
                                            const float2* sig,
                                            long long start, int t) {
#pragma unroll
    for (int r = 0; r < fftreg::kPoints; ++r)
        v[r] = __ldg(sig + start + t + r * T);
}

// Thread t's pass-0 points of one sequence, v[r] = (fir(sig)[start + n] -
// mean) * win[n], n = t + r*T: with K = 1 from its samples in v (the one
// product rounded as fir_point rounds it), else fir_pair of the staged
// span (re, im).
template <int T>
__device__ __forceinline__ void points(float2 (&v)[fftreg::kPoints],
                                       const float* re, const float* im,
                                       const float* taps, float tap0, int K,
                                       float2 mean,
                                       const float* __restrict__ win, int t) {
    constexpr int P = fftreg::kPoints;
    if (K == 1) {
#pragma unroll
        for (int r = 0; r < P; ++r)
            v[r] = make_float2(__fmul_rn(tap0, v[r].x),
                               __fmul_rn(tap0, v[r].y));
    } else {
#pragma unroll
        for (int r = 0; r < P; ++r)
            v[r] = fir_pair(re + t + r * T, im + t + r * T, taps, K);
    }
#pragma unroll
    for (int r = 0; r < P; ++r) {
        const float w = __ldg(win + t + r * T);
        v[r] = make_float2((v[r].x - mean.x) * w, (v[r].y - mean.y) * w);
    }
}

// One bin's terms from a = A_k and b = B_k.  pair: |A|^2 into sxx (kept by
// channel 1's items alone), |B|^2, Re and Im of B conj A; auto: |A|^2 +
// |B|^2 into sxx.
__device__ __forceinline__ void accumulate(double& sxx, double& syy,
                                           double& sre, double& sim, float2 a,
                                           float2 b, bool pair, bool keep_x) {
    const double ar = a.x, ai = a.y, br = b.x, bi = b.y;
    const double aa = ar * ar + ai * ai;
    const double bb = br * br + bi * bi;
    if (pair) {
        if (keep_x) sxx += aa;
        syy += bb;
        sre += br * ar + bi * ai;
        sim += bi * ar - br * ai;
    } else {
        sxx += aa + bb;
    }
}

template <int LOGN>
__global__ void __launch_bounds__(block_threads(LOGN), min_blocks(LOGN))
welch_kernel(const float2* __restrict__ x, const float2* __restrict__ y,
             long long y_row_stride, const float* __restrict__ taps_g, int K,
             const float* __restrict__ means, const float* __restrict__ win,
             const float2* __restrict__ tw, double* __restrict__ part,
             int hop, int navr, int nch, int ngroups, int nfreq) {
    constexpr int N = 1 << LOGN;
    constexpr int P = fftreg::kPoints;
    constexpr int T = N / P;
    constexpr bool kSide = side_by_side(LOGN);
    constexpr int BT = block_threads(LOGN);
    constexpr int B = N / BT;   // bins a thread sums: k = i + b*BT
    constexpr int PN = fftreg::pad(N);
    extern __shared__ __align__(16) unsigned char smem[];
    float2* bufs = reinterpret_cast<float2*>(smem);   // A's, then B's
    float* raw = reinterpret_cast<float*>(smem);      // before a transform
    double* sxx = reinterpret_cast<double*>(raw + region_floats(LOGN, K));
    float* taps = raw + region_floats(LOGN, K) + xx_floats(LOGN);
    const int i = threadIdx.x;
    const int h = kSide ? i / T : 0;   // side by side: 0 runs A, 1 runs B
    const int t = i - h * T;
    const int seq = seq_floats(LOGN, K);
    if (K > 1)
        for (int k = i; k < K; k += BT) taps[k] = taps_g[k];
    // (the first read of taps follows a unit's first barrier)
    const float tap0 = __ldg(taps_g);

    const bool pair = nch > 0;
    const int ncols = pair ? nch : 1;
    const int nunits = pair ? navr : (navr + 1) / 2;
    const int per_group = (nunits + ngroups - 1) / ngroups;
    const int nitems = ngroups * ncols;
    const float2 ma = make_float2(means[0], means[1]);
    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
        // the channels of one group run side by side and share x in L2
        const int g = item / ncols;
        const int c = pair ? 1 + item % ncols : 0;
        const bool keep_x = !pair || c == 1;
        const float2* sig_b = pair ? y + (c - 1) * y_row_stride : x;
        const float2 mb = make_float2(means[2 * c], means[2 * c + 1]);
        const long long row = static_cast<long long>(g) * (nch + 1);
        double* out_x = part + row * 3 * nfreq;         // |X|^2, 0, 0
        double* out_c = part + (row + c) * 3 * nfreq;   // |Y|^2, Re, Im
        const int u0 = g * per_group;
        const int u1 = min(nunits, u0 + per_group);
        if constexpr (kSide) {
            // |Y|^2, Re and Im in registers; |X|^2 (kept by channel 1's
            // items alone) in shared memory, each thread its own bins
            double acc[B][3];
#pragma unroll
            for (int b = 0; b < B; ++b) {
#pragma unroll
                for (int r = 0; r < 3; ++r) acc[b][r] = 0.0;
                if (keep_x) sxx[i + b * BT] = 0.0;
            }
            // this thread's sequence: A (x at sa) or B (sig_b at sa, or at
            // sa + hop for nch = 0; none for a lone last segment)
            const float2* sig = h ? sig_b : x;
            const long long shift = h && !pair ? hop : 0;
            float* re = raw + 2 * h * seq;
            float* im = re + seq;
            float2 v[P];
            if (K == 1 && u0 < u1 && (!h || pair || 2 * u0 + 1 < navr))
                load_points<T>(v, sig,
                               static_cast<long long>(pair ? u0 : 2 * u0) *
                                       hop + shift, t);
            for (int u = u0; u < u1; ++u) {
                const long long start =
                    static_cast<long long>(pair ? u : 2 * u) * hop + shift;
                const bool live = !h || pair || 2 * u + 1 < navr;
                if (K > 1) {
                    __syncthreads();   // the last unit's reads are done
                    if (live) stage<T>(re, im, sig, start, N + K - 1, K, t);
                    __syncthreads();
                }
                if (live) {
                    points<T>(v, re, im, taps, tap0, K, h ? mb : ma, win, t);
                } else {
#pragma unroll
                    for (int r = 0; r < P; ++r) v[r] = make_float2(0.f, 0.f);
                }
                fftreg::transform<LOGN>(v, bufs + h * PN, tw, t);
                // K = 1: the next unit's samples load while the sums are made
                if (K == 1 && u + 1 < u1 && (!h || pair || 2 * u + 3 < navr))
                    load_points<T>(v, sig,
                                   start + (pair ? hop : 2 * hop), t);
#pragma unroll
                for (int b = 0; b < B; ++b) {
                    const int k = i + b * BT;
                    accumulate(sxx[k], acc[b][0], acc[b][1], acc[b][2],
                               bufs[fftreg::pad(k)],
                               bufs[PN + fftreg::pad(k)], pair, keep_x);
                }
            }
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const int k = i + b * BT;
                if (k >= nfreq) continue;
                if (pair) {
                    out_c[k] = acc[b][0];
                    out_c[nfreq + k] = acc[b][1];
                    out_c[2 * nfreq + k] = acc[b][2];
                }
                if (keep_x) {
                    out_x[k] = sxx[k];
                    out_x[nfreq + k] = 0.0;
                    out_x[2 * nfreq + k] = 0.0;
                }
            }
        } else {
            // the sums live in part: this thread's bins start at zero
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const int k = t + b * T;
                if (k >= nfreq) continue;
                for (int r = 0; r < 3; ++r) {
                    if (pair) out_c[r * nfreq + k] = 0.0;
                    if (keep_x) out_x[r * nfreq + k] = 0.0;
                }
            }
            float* re = raw;
            float* im = raw + seq;
            for (int u = u0; u < u1; ++u) {
                const long long sa =
                    static_cast<long long>(pair ? u : 2 * u) * hop;
                const long long sb = pair ? sa : sa + hop;
                const bool has_b = pair || 2 * u + 1 < navr;
                float2 v[P], a[P];
                if (K > 1) {
                    __syncthreads();   // the last unit's reads are done
                    stage<T>(re, im, x, sa, N + K - 1, K, t);
                    __syncthreads();
                }
                if (K == 1) load_points<T>(v, x, sa, t);
                points<T>(v, re, im, taps, tap0, K, ma, win, t);
                fftreg::transform<LOGN>(v, bufs, tw, t);
#pragma unroll
                for (int b = 0; b < B; ++b)
                    a[b] = bufs[fftreg::pad(t + b * T)];
                if (has_b) {
                    if (K > 1) {
                        __syncthreads();   // A's bins are read
                        stage<T>(re, im, sig_b, sb, N + K - 1, K, t);
                        __syncthreads();
                    }
                    if (K == 1) load_points<T>(v, sig_b, sb, t);
                    points<T>(v, re, im, taps, tap0, K, mb, win, t);
                    fftreg::transform<LOGN>(v, bufs, tw, t);
                }
#pragma unroll
                for (int b = 0; b < B; ++b) {
                    const int k = t + b * T;
                    if (k >= nfreq) continue;
                    double s[4] = {0.0, 0.0, 0.0, 0.0};   // this unit's terms
                    accumulate(s[0], s[1], s[2], s[3], a[b],
                               has_b ? bufs[fftreg::pad(k)]
                                     : make_float2(0.f, 0.f),
                               pair, keep_x);
                    if (keep_x) out_x[k] += s[0];
                    if (pair) {
                        out_c[k] += s[1];
                        out_c[nfreq + k] += s[2];
                        out_c[2 * nfreq + k] += s[3];
                    }
                }
            }
        }
    }
}

// Resident blocks of welch_kernel<LOGN> on the current device for K taps
// (cached per device, N and K); sets the kernel's shared-memory limit on
// first use.
template <int LOGN>
cudaError_t resident(int K, int* out) {
    static int cached_k[kMaxDevices] = {};
    static int cached_n[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (cached_k[dev] != K) {
        auto kernel = welch_kernel<LOGN>;
        int sms = 0, per_sm = 0;
        if ((e = cudaFuncSetAttribute(
                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 static_cast<int>(smem_bytes(LOGN, kFirMaxTaps)))) !=
                cudaSuccess ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kernel, block_threads(LOGN),
                 smem_bytes(LOGN, K))) != cudaSuccess)
            return e;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        cached_n[dev] = per_sm * sms;
        cached_k[dev] = K;
    }
    *out = cached_n[dev];
    return cudaSuccess;
}

template <int LOGN>
cudaError_t launch(const float2* x, const float2* y, long long y_row_stride,
                   const float* taps, int K, const float* means,
                   const float* win, const float2* tw, double* part, int hop,
                   int navr, int nch, int ngroups, int nfreq,
                   cudaStream_t stream) {
    int cap = 0;
    cudaError_t e = resident<LOGN>(K, &cap);
    if (e != cudaSuccess) return e;
    const long long items =
        static_cast<long long>(ngroups) * (nch > 0 ? nch : 1);
    welch_kernel<LOGN>
        <<<static_cast<unsigned>(items < cap ? items : cap),
           block_threads(LOGN), smem_bytes(LOGN, K), stream>>>(
            x, y, y_row_stride, taps, K, means, win, tw, part, hop, navr, nch,
            ngroups, nfreq);
    return cudaGetLastError();
}

int log2_of(int nwins) {
    int logN = 0;
    while ((1 << logN) < nwins && logN <= kMaxLogN) ++logN;
    return (1 << logN) == nwins && logN >= kMinLogN && logN <= kMaxLogN
               ? logN : -1;
}

}  // namespace

// Blocks of the kernel the current device holds at once for nwins and K
// taps (the wrapper sizes its segment groups by it); a negative CUDA error
// code on failure.
extern "C" int pyfft_welch_resident(int nwins, int K) {
    const int logN = log2_of(nwins);
    if (logN < 0 || K < 1 || K > kFirMaxTaps)
        return -static_cast<int>(cudaErrorInvalidValue);
    int n = 0;
    cudaError_t e = cudaErrorInvalidValue;
    switch (logN) {
#define PYFFT_RESIDENT_CASE(L) \
    case L: e = resident<L>(K, &n); break;
        PYFFT_RESIDENT_CASE(4) PYFFT_RESIDENT_CASE(5) PYFFT_RESIDENT_CASE(6)
        PYFFT_RESIDENT_CASE(7) PYFFT_RESIDENT_CASE(8) PYFFT_RESIDENT_CASE(9)
        PYFFT_RESIDENT_CASE(10) PYFFT_RESIDENT_CASE(11)
        PYFFT_RESIDENT_CASE(12) PYFFT_RESIDENT_CASE(13)
        PYFFT_RESIDENT_CASE(14)
#undef PYFFT_RESIDENT_CASE
        default: break;
    }
    return e == cudaSuccess ? n : -static_cast<int>(e);
}

// x: reference signal, y: nch signals with row stride `y_row_stride`
// floats (even), interleaved complex64 (nch = 0: x alone, segments paired
// with each other).  taps: (K,) float32.  means: (nch + 1) * 2 float32 (re,
// im), reference first.  win: (nwins,) float32.  tw: (nwins/2,) complex64,
// exp(-2 pi i m / nwins).  part: (ngroups, nch + 1, 3, nfreq) float64
// scratch.  out: (nch + 1, 3, nfreq) float32, nfreq <= nwins.  The caller
// checks that the segments fit the signal.  Returns cudaGetLastError()
// after the second launch (or the first error).
extern "C" int pyfft_welch(const float* x, const float* y,
                           long long y_row_stride, const float* taps, int K,
                           const float* means, const float* win,
                           const void* tw, double* part, float* out, int nch,
                           int nwins, int hop, int navr, int ngroups,
                           int nfreq, double norm, void* stream_ptr) {
    const int logN = log2_of(nwins);
    if (logN < 0 || K < 1 || K > kFirMaxTaps || hop < 1 || hop > nwins ||
        navr < 1 || ngroups < 1 || nch < 0 || nch + 1 > 65535 || nfreq < 1 ||
        nfreq > nwins || y_row_stride % 2 ||
        static_cast<long long>(ngroups) * (nch > 0 ? nch : 1) > INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const float2* xc = reinterpret_cast<const float2*>(x);
    const float2* yc = reinterpret_cast<const float2*>(y);
    const float2* t = static_cast<const float2*>(tw);
    const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t e = cudaErrorInvalidValue;
    switch (logN) {
#define PYFFT_WELCH_CASE(L)                                                   \
    case L:                                                                   \
        e = launch<L>(xc, yc, y_row_stride / 2, taps, K, means, win, t, part, \
                      hop, navr, nch, ngroups, nfreq, s);                     \
        break;
        PYFFT_WELCH_CASE(4) PYFFT_WELCH_CASE(5) PYFFT_WELCH_CASE(6)
        PYFFT_WELCH_CASE(7) PYFFT_WELCH_CASE(8) PYFFT_WELCH_CASE(9)
        PYFFT_WELCH_CASE(10) PYFFT_WELCH_CASE(11) PYFFT_WELCH_CASE(12)
        PYFFT_WELCH_CASE(13) PYFFT_WELCH_CASE(14)
#undef PYFFT_WELCH_CASE
        default: break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long per_part = static_cast<long long>(nch + 1) * 3 * nfreq;
    return launch_sum_partials(part, out, ngroups, per_part, norm, s);
}
