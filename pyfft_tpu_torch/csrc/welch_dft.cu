// Kernel E: Welch cross-powers at any segment length.
//
// Replaces pyfft_tpu/ops/pallas_welch.py::_accum_kernel (launched by
// _welch_power_call for welch_pallas_fused and welch_power_pallas), with
// the reference spectrum the JAX package computes in XLA beside it.
//
// For segment s (start s*hop, s < navr) of each signal it forms
//   v[n] = (sig[start+n] - mean - slope*(start+n - tbar)) * win[n],
// n < N = nwins, takes the first nfreq bins of its N-point DFT V and sums
// over segments
//   col 0:      |X|^2
//   col c + 1:  |Y_c|^2,  Re(Y_c conj X),  Im(Y_c conj X)
// where X is the reference signal's transform.  mean and slope (float64,
// from the caller's prologue) give the global mean (slope 0), the global
// least-squares line, or nothing (both 0).
//
// The DFT of any length: for N a power of two >= 16 an N-point FFT;
// otherwise Bluestein's algorithm on M-point FFTs cut to the kept bins.
// With w[n] = exp(-i pi n^2 / N),
//   V[k] = w[k]/M * conj(FFT_M(conj(FFT_M(a) * F)))[k],   k < nfreq,
//   a[n] = v[n] * w[n] zero-padded to M,
// F the M-point FFT of the chirp filter b[m mod M] = conj(w[|m|]) for
// -(N-1) < m < nfreq.  Bins k < nfreq need only those taps, so M is the
// least power of two >= max(16, N + nfreq - 1) (8192 at N = 4871 and
// nfreq = 2436, not 16384 as for all N bins); no code reads a bin >=
// nfreq.  The caller builds pre[n] = win[n] * w[n] (window folded in), F
// and post[k] = w[k]/M in float64 on the host from the exact integer n^2
// mod 2N, then rounds them to complex64.
//
// What bounds it on the card: per segment and signal two M-point FFTs,
// about 10*M*log2(M) flops (5.4 GFLOP at the heat-pulse geometry, 0.08 ms
// at the float32 book rate) through shared memory, against one read of
// the signals and a 100 MB round trip of the kept spectra.  Design:
//   1. dft_spectra: one transform per (signal, segment) item of a chunk,
//      on fft_reg.cuh's register-radix Stockham FFT (M/16 threads with 16
//      points each, log16(M) passes, natural order in and out), the
//      detrend and `pre` applied on load, the filter product and the
//      conjugation in registers between the two transforms; the nfreq
//      kept bins go to the chunk's scratch, complex64.  Below M = 2048 a
//      block of 128 threads runs several transforms.  Shared memory is
//      pad(M) float2 a transform (68 KB at M = 8192); about 1024 threads
//      an SM (two blocks at M = 8192), so at most 64 registers a thread.
//   2. dft_sums: |X|^2, |Y|^2, Re and Im of Y conj X summed in float64
//      over groups of segments: a block takes 32 bins of one column and
//      one group, each of its 8 warps every 8th segment of the group in
//      order, then adds the warps in order (a group is at least 16
//      segments, and there are enough groups for about 8 blocks an SM, so
//      a call with few bins or columns and many segments still fills the
//      card).
//   3. dft_combine: each output adds its groups in order, then the earlier
//      chunks' sums (acc), and writes acc or, after the last chunk, out =
//      norm * sums: the result does not depend on the order in which
//      blocks ran.  The caller chunks the segments (and, for very many
//      channels, the channels) so that the scratch stays under a fixed
//      cap; each channel group also transforms x again.
#include <cuda_runtime.h>

#include "fft_reg.cuh"

namespace {

constexpr int kMinLogM = 4;
constexpr int kMaxLogM = 14;
constexpr int kMaxN = 8192;
constexpr int kSumBins = 32;         // bins of a dft_sums block (a warp)
constexpr int kSumLanes = 8;         // its segment lanes (warps)
constexpr int kCombineThreads = 256;

// Threads of a block: one transform of M/16 threads, or several up to 128.
__host__ __device__ constexpr int block_threads(int logm) {
    return (1 << logm) / fftreg::kPoints > 128
               ? (1 << logm) / fftreg::kPoints : 128;
}

__host__ __device__ constexpr int transforms_per_block(int logm) {
    return block_threads(logm) / ((1 << logm) / fftreg::kPoints);
}

__host__ __device__ constexpr size_t smem_bytes(int logm) {
    return sizeof(float2) * transforms_per_block(logm) *
           fftreg::pad(1 << logm);
}

// Blocks an SM should hold at once: about 1024 threads.
__host__ __device__ constexpr int min_blocks(int logm) {
    return block_threads(logm) >= 1024 ? 1 : 1024 / block_threads(logm);
}

// Pass 1.  Item i*ns + s of the chunk is segment s0 + s of signal i: x
// for i = 0, channel c0 + i - 1 above.  Its nfreq kept bins go to
// spec[(i*ns + s)*nfreq + k].  blue: Bluestein (filt and post given).
template <int LOGM>
__global__ void __launch_bounds__(block_threads(LOGM), min_blocks(LOGM))
dft_spectra(const float* __restrict__ x, const float* __restrict__ y,
            long long y_row_stride, const double* __restrict__ mean,
            const double* __restrict__ slope, double tbar,
            const float2* __restrict__ pre, const float2* __restrict__ filt,
            const float2* __restrict__ post, const float2* __restrict__ tw,
            float2* __restrict__ spec, int blue, int c0, int nsig, int s0,
            int ns, int N, int hop, int nfreq) {
    constexpr int M = 1 << LOGM;
    constexpr int P = fftreg::kPoints;
    constexpr int T = M / P;
    constexpr int F = transforms_per_block(LOGM);
    extern __shared__ __align__(16) unsigned char smem[];
    const int slot = threadIdx.x / T;
    const int t = threadIdx.x % T;
    float2* buf = reinterpret_cast<float2*>(smem) + slot * fftreg::pad(M);

    const long long item = static_cast<long long>(blockIdx.x) * F + slot;
    const bool active = item < static_cast<long long>(nsig) * ns;
    const int i = active ? static_cast<int>(item / ns) : 0;
    const int col = i ? c0 + i : 0;   // row of mean and slope
    const float* sig =
        i ? y + static_cast<long long>(c0 + i - 1) * y_row_stride : x;
    const long long start =
        static_cast<long long>(s0 + (active ? item % ns : 0)) * hop;
    const double m = mean[col], sl = slope[col];

    // thread t's point r is sample t + r*T (the first pass's order)
    float2 v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
        const int n = t + r * T;
        v[r] = make_float2(0.f, 0.f);
        if (active && n < N) {
            const long long tt = start + n;
            const double trend = m + sl * (static_cast<double>(tt) - tbar);
            const float d = __ldg(sig + tt) - static_cast<float>(trend);
            const float2 p = __ldg(pre + n);
            v[r] = make_float2(d * p.x, d * p.y);
        }
    }
    for (int round = 0;; ++round) {
        fftreg::transform<LOGM>(v, buf, tw, t);
        if (!blue || round) break;
        // conj(A * F) in natural order, the second transform's input
#pragma unroll
        for (int r = 0; r < P; ++r) {
            const int n = t + r * T;
            const float2 a = buf[fftreg::pad(n)];
            const float2 f = __ldg(filt + n);
            v[r] = make_float2(a.x * f.x - a.y * f.y,
                               -(a.x * f.y + a.y * f.x));
        }
    }
    if (!active) return;
    float2* row = spec + item * nfreq;
    for (int k = t; k < nfreq; k += T) {
        const float2 z = buf[fftreg::pad(k)];
        if (blue) {
            const float2 p = __ldg(post + k);
            // post[k] * conj(z)
            row[k] = make_float2(p.x * z.x + p.y * z.y,
                                 p.y * z.x - p.x * z.y);
        } else {
            row[k] = z;
        }
    }
}

// Pass 2.  Block (bin tile, sum column j, segment group g): signal i = j +
// skip_x of the chunk (x for i = 0, whose column sums |X|^2 alone), bins k
// of the tile, segments [g*spg, min(ns, (g+1)*spg)).  Warp y of the block
// sums segments g*spg + y, + kSumLanes, ... in that order in float64; the
// lanes are then added in order into part[((g*ncols + j)*3 + q)*nfreq + k]
// (q: |Y|^2 or |X|^2, Re and Im of Y conj X).
__global__ void __launch_bounds__(kSumBins * kSumLanes)
dft_sums(const float2* __restrict__ spec, double* __restrict__ part,
         int skip_x, int ns, int spg, int nfreq) {
    __shared__ double red[3][kSumLanes][kSumBins];
    const int b = threadIdx.x % kSumBins;
    const int lane = threadIdx.x / kSumBins;
    const int k = blockIdx.x * kSumBins + b;
    const int j = blockIdx.y;
    const int i = j + skip_x;
    const int g = blockIdx.z;
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
    if (k < nfreq) {
        const float2* xs = spec + k;
        const float2* ys = spec + static_cast<long long>(i) * ns * nfreq + k;
        const int s1 = min(ns, (g + 1) * spg);
        for (int s = g * spg + lane; s < s1; s += kSumLanes) {
            const float2 xz = xs[static_cast<long long>(s) * nfreq];
            const double xr = xz.x, xi = xz.y;
            if (i == 0) {
                a0 += xr * xr + xi * xi;
            } else {
                const float2 yz = ys[static_cast<long long>(s) * nfreq];
                const double yr = yz.x, yi = yz.y;
                a0 += yr * yr + yi * yi;
                a1 += yr * xr + yi * xi;
                a2 += yi * xr - yr * xi;
            }
        }
    }
    red[0][lane][b] = a0;
    red[1][lane][b] = a1;
    red[2][lane][b] = a2;
    __syncthreads();
    if (lane < 3 && k < nfreq) {   // warp q adds output q's lanes
        double sum = 0.0;
#pragma unroll
        for (int l = 0; l < kSumLanes; ++l) sum += red[lane][l][b];
        part[(static_cast<long long>(g * gridDim.y + j) * 3 + lane) * nfreq +
             k] = sum;
    }
}

// Pass 3.  Element e of the chunk's (ncols, 3, nfreq) sums: the groups'
// partials added in group order, then the earlier chunks' sums (acc,
// unless `first`); written to acc, or after the last chunk (`last`) to out
// scaled by norm.  Sum column j is out's column 0 for x (j + skip_x = 0),
// c0 + j + skip_x for a channel.
__global__ void __launch_bounds__(kCombineThreads)
dft_combine(const double* __restrict__ part, double* __restrict__ acc,
            float* __restrict__ out, int ngroups, int ncols, int skip_x,
            int c0, int nfreq, int first, int last, double norm) {
    const long long per = static_cast<long long>(ncols) * 3 * nfreq;
    const long long e =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= per) return;
    double a = 0.0;
    for (int g = 0; g < ngroups; ++g) a += part[g * per + e];
    const int i = static_cast<int>(e / (3 * nfreq)) + skip_x;
    const long long o =
        static_cast<long long>(i ? c0 + i : 0) * 3 * nfreq + e % (3 * nfreq);
    if (!first) a += acc[o];
    if (last)
        out[o] = static_cast<float>(a * norm);
    else
        acc[o] = a;
}

template <int LOGM>
cudaError_t set_smem() {
    return smem_bytes(LOGM) > 48 * 1024
               ? cudaFuncSetAttribute(
                     dft_spectra<LOGM>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                     static_cast<int>(smem_bytes(LOGM)))
               : cudaSuccess;
}

template <int LOGM>
cudaError_t launch_spectra(const float* x, const float* y,
                           long long y_row_stride, const double* mean,
                           const double* slope, double tbar,
                           const float2* pre, const float2* filt,
                           const float2* post, const float2* tw,
                           float2* spec, int blue, int c0, int nsig, int s0,
                           int ns, int N, int hop, int nfreq,
                           cudaStream_t stream) {
    constexpr int F = transforms_per_block(LOGM);
    cudaError_t e = set_smem<LOGM>();
    if (e != cudaSuccess) return e;
    const long long blocks = (static_cast<long long>(nsig) * ns + F - 1) / F;
    dft_spectra<LOGM><<<static_cast<unsigned>(blocks), block_threads(LOGM),
                        smem_bytes(LOGM), stream>>>(
        x, y, y_row_stride, mean, slope, tbar, pre, filt, post, tw, spec,
        blue, c0, nsig, s0, ns, N, hop, nfreq);
    return cudaGetLastError();
}

template <int LOGM>
int blocks_per_sm() {
    cudaError_t e = set_smem<LOGM>();
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, dft_spectra<LOGM>, block_threads(LOGM),
            smem_bytes(LOGM));
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

int log2_of(int M) {
    int logM = 0;
    while ((1 << logM) < M && logM <= kMaxLogM) ++logM;
    return (1 << logM) == M && logM >= kMinLogM ? logM : -1;
}

}  // namespace

// One chunk of kernel E: segments [s0, s0 + ns) of x and of channels
// [c0, c0 + nc) (x's column only when c0 = 0).  x: reference signal
// (float32, contiguous), y: nch signals with row stride `y_row_stride`
// floats.  mean, slope: (nch+1,) float64, reference first; tbar = (nt -
// 1) / 2.  pre: (nwins,) complex64 (window times chirp, or the window
// alone when M == nwins).  filt: (M,) and post: (nfreq,) complex64, null
// when M == nwins.  tw: (M/2,) complex64, tw[m] = exp(-2 pi i m / M).
// spec: ((1 + nc) * ns, nfreq) complex64 scratch.  spg: segments a group
// of dft_sums.  part: (ceil(ns / spg), ncols, 3, nfreq) float64 scratch,
// ncols = 1 + nc, or nc when c0 > 0.  acc: (nch+1, 3, nfreq)
// float64, read unless s0 = 0 and written unless s0 + ns = navr (may be
// null when ns = navr).  out: (nch+1, 3, nfreq) float32, written by the
// last chunk of each channel group.  Returns cudaGetLastError() after the last launch
// (or the first error).
extern "C" int pyfft_welch_dft(const float* x, const float* y,
                               long long y_row_stride, const double* mean,
                               const double* slope, double tbar,
                               const void* pre, const void* filt,
                               const void* post, const void* tw, void* spec,
                               double* part, double* acc, float* out,
                               int nch, int c0, int nc, int s0, int ns,
                               int spg, int navr, int nwins, int M, int hop,
                               int nfreq, double norm, void* stream_ptr) {
    const int N = nwins;
    const bool direct = N >= 16 && (N & (N - 1)) == 0;
    const int logM = log2_of(M);
    const int first = s0 == 0, last = s0 + ns == navr;
    if (N < 1 || N > kMaxN || logM < 0 || hop < 1 || nfreq < 1 ||
        nfreq > N / 2 + 1 || (direct ? M != N : M < N + nfreq - 1) ||
        (!direct && (!filt || !post)) || nch < 0 || nch + 1 > 65535 ||
        c0 < 0 || nc < 0 || c0 + nc > nch || (c0 > 0 && nc < 1) ||
        (nch > 0 && nc < 1) || s0 < 0 || ns < 1 || s0 + ns > navr ||
        spg < 1 || ((!first || !last) && !acc))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float2* pref = static_cast<const float2*>(pre);
    const float2* filtf = static_cast<const float2*>(filt);
    const float2* postf = static_cast<const float2*>(post);
    const float2* twf = static_cast<const float2*>(tw);
    float2* specf = static_cast<float2*>(spec);
    const int blue = direct ? 0 : 1;
    const int nsig = 1 + nc;
    cudaError_t e = cudaErrorInvalidValue;
    switch (logM) {
#define PYFFT_WELCH_DFT_CASE(L)                                              \
    case L:                                                                  \
        e = launch_spectra<L>(x, y, y_row_stride, mean, slope, tbar, pref,   \
                              filtf, postf, twf, specf, blue, c0, nsig, s0,  \
                              ns, N, hop, nfreq, stream);                    \
        break;
        PYFFT_WELCH_DFT_CASE(4) PYFFT_WELCH_DFT_CASE(5)
        PYFFT_WELCH_DFT_CASE(6) PYFFT_WELCH_DFT_CASE(7)
        PYFFT_WELCH_DFT_CASE(8) PYFFT_WELCH_DFT_CASE(9)
        PYFFT_WELCH_DFT_CASE(10) PYFFT_WELCH_DFT_CASE(11)
        PYFFT_WELCH_DFT_CASE(12) PYFFT_WELCH_DFT_CASE(13)
        PYFFT_WELCH_DFT_CASE(14)
#undef PYFFT_WELCH_DFT_CASE
        default: break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const int skip_x = c0 > 0 ? 1 : 0;
    const int ncols = nsig - skip_x;
    const int ngroups = (ns + spg - 1) / spg;
    const dim3 grid((nfreq + kSumBins - 1) / kSumBins, ncols, ngroups);
    dft_sums<<<grid, kSumBins * kSumLanes, 0, stream>>>(specf, part, skip_x,
                                                        ns, spg, nfreq);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long per = static_cast<long long>(ncols) * 3 * nfreq;
    dft_combine<<<static_cast<unsigned>((per + kCombineThreads - 1) /
                                        kCombineThreads),
                  kCombineThreads, 0, stream>>>(part, acc, out, ngroups,
                                                ncols, skip_x, c0, nfreq,
                                                first, last, norm);
    return static_cast<int>(cudaGetLastError());
}

// Resident blocks of kernel E's transform pass per SM at M points (its
// occupancy), or minus the CUDA error code.
extern "C" int pyfft_welch_dft_blocks_per_sm(int M) {
    switch (log2_of(M)) {
#define PYFFT_WELCH_DFT_OCC(L) \
    case L: return blocks_per_sm<L>();
        PYFFT_WELCH_DFT_OCC(4) PYFFT_WELCH_DFT_OCC(5) PYFFT_WELCH_DFT_OCC(6)
        PYFFT_WELCH_DFT_OCC(7) PYFFT_WELCH_DFT_OCC(8) PYFFT_WELCH_DFT_OCC(9)
        PYFFT_WELCH_DFT_OCC(10) PYFFT_WELCH_DFT_OCC(11)
        PYFFT_WELCH_DFT_OCC(12) PYFFT_WELCH_DFT_OCC(13)
        PYFFT_WELCH_DFT_OCC(14)
#undef PYFFT_WELCH_DFT_OCC
        default: return -static_cast<int>(cudaErrorInvalidValue);
    }
}
