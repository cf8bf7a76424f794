// Kernel B's real path and kernel H: fused causal FIR + global-mean detrend
// + Welch cross-powers of real signals, two real sequences per complex FFT.
//
// Replaces, for real signals, pyfft_tpu/ops/pallas_welch3.py::
// _v3_fused_kernel (with _assemble_rows and _chunk_math) and ::_v3_kernel,
// its sibling for an already-filtered signal; _v3_fused_kernel's
// lane-packing modes (vmask, paircross with _pair_reduce), reached from
// welch_auto_packed and welch_pair_packed; and pyfft_tpu/ops/
// pallas_welch.py::_factored_kernel (the v2 kernel, e.g. nwins 2048 every
// 128).  Complex (two-sided) signals take welch.cu.
//
// For segment s (start s*hop, s < navr) of each real signal it forms
//   v[n] = (fir(sig)[start+n] - mean) * win[n],   n < N = nwins,
// and accumulates, for bins 0..N/2 of the transforms,
//   col 0:      |X|^2
//   col c + 1:  |Y_c|^2,  Re(Y_c conj X),  Im(Y_c conj X)
// where X is the reference x's transform.  The filtered channels never go
// to device memory.  With two or more channels and a filter, x is filtered
// once a call ahead of the kernel, by kernel A (fir.cu, fir4, the same
// products in the same order), into a row `xf` that the blocks read; else
// (xf null) each block filters x itself.
//
// How segments map to FFTs (one complex FFT per unit):
//   pair (nch >= 1): unit s of channel c is Z = FFT(x_s + i y_{c,s}),
//     X_k = (Z_k + conj Z_{N-k}) / 2, Y_k = (Z_k - conj Z_{N-k}) / (2i).
//     Every channel's blocks transform x again; only channel 1's keep |X|^2.
//     With xf, a channel's block reads x's span filtered and filters y_c
//     alone.
//   auto (nch = 0): unit p is Z = FFT(x_{2p} + i x_{2p+1}), split the same
//     way into two spectra whose powers are added.  An odd navr leaves the
//     last segment alone, with a zero imaginary part.
// Before the transform each sequence of a unit is scaled by its own power
// of two, 2^-a, to a sum of squares in [0.5, 2) (a float64 sum over the
// block), and its terms are scaled back exactly: 4^a on |X|^2, 4^b on
// |Y|^2, 2^(a+b) on the cross terms.  The float32 error of the transform
// follows |Z|; scaled, a quiet channel beside a loud reference keeps the
// accuracy it would have alone.
//
// What bounds it on the card.  At bench config 0 (8 channels of 2^25
// samples, N = 2048, hop 1024, 129 taps) each channel's blocks filter y_c
// once, hop * K FMAs a unit (3.5e10 in all, and 4.3e9 in kernel A for x;
// filtering x in every channel's blocks took 6.9e10), and run 262k
// transforms of 2048 points with their float64 sums; the signals, and
// filtered x, are read about once per channel, mostly from L2.
// Unblocked, the filter was bound by shared-memory loads (one or two per
// FMA); blocked, its instructions are still about 60% of a unit's issue
// slots (cheaper loads and an overlap-save fill moved nothing: PERF.md),
// so the lever is how many it issues.  Design:
// - blocks of N/16 threads (fft_reg.cuh's register-radix Stockham FFT: 16
//   points a thread, log16 N passes through padded shared memory, natural
//   order out); persistent blocks over (segment group, channel) items, as
//   many as the card holds at once (found once per device and taps count);
//   a block walks the consecutive units of its group.
// - the filtered, mean-removed samples of a block's two sequences live in a
//   shared ring indexed by time mod its length (pair: 2N a sequence; auto:
//   one ring of 4N, a unit's span being N + hop).  A unit filters only the
//   samples its predecessors did not (hop per sequence; the first unit of
//   a group its whole span) into slots no longer needed, so each sample of
//   a span is filtered once per block.  Where that is less than 4 outputs
//   a thread (hop < N/4, e.g. 128 at N = 2048) it filters ahead, several
//   units' samples at once, as far as the ring and the group reach.
//   Threads read the ring at consecutive times, so neighbouring threads hit
//   neighbouring banks and the ring needs no padding.  The raw samples of
//   the new span (up to N + K - 1 per sequence) are staged in the FFT's
//   buffer, which is free until the first pass stores.  With xf, x's new
//   slots are loaded from xf (coalesced) and only y_c is staged and
//   filtered.
// - the filter is register-blocked (fir.cuh::fir4, which kernels A and I
//   run too): a thread makes 4 consecutive outputs of both sequences from
//   16-byte loads, one of 4 taps (a broadcast) and one of 4 samples per
//   sequence for 32 FMAs, with fir_point's products in fir_point's order,
//   so the blocking changes no result.
// - at N = 16384 the ring (256 KB) and the FFT buffer (139 KB) do not fit
//   in the 227 KB of a block together: there each unit filters its whole
//   span (N + K - 1 staged samples a sequence) straight into the first
//   pass's registers with fir.cuh's fir_pair (with xf: x's span read from
//   xf, y's filtered with fir_point).
// - per-bin sums in float64 registers (8 bin pairs j, N - j a thread; bin
//   N/2 in shared memory, owned by thread 0); each item writes its
//   group's partials in the (ngroups, nch + 1, 3, nbins) layout, which
//   sum_partials (reduce.cuh) sums in a fixed order and scales by `norm`.
//   At N = 128, 256 and 1024 to 4096 nothing spills (128 registers); the
//   sums spill 608 bytes at N = 16384 (1024 threads, 64 registers a
//   thread), 100 at 8192, 104 at 512 and 120-340 at N <= 64 (ptxas, the
//   build.log).
#include <cuda_runtime.h>

#include <climits>

#include "fft_reg.cuh"
#include "fir.cuh"
#include "reduce.cuh"

namespace {

constexpr int kMinLogN = 4;
constexpr int kMaxLogN = 14;
constexpr int kRingMaxLogN = 13;   // the largest N whose ring fits
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int block_threads(int logn) {
    return (1 << logn) / fftreg::kPoints;
}

// Blocks an SM should hold: about 16 warps (a thread keeps 32 float64 sums
// and 16 complex points, about 128 registers; a block of fewer than 32
// threads still takes a warp's registers).
__host__ __device__ constexpr int min_blocks(int logn) {
    return block_threads(logn) >= 512 ? 1
           : block_threads(logn) <= 32 ? 16
                                       : 512 / block_threads(logn);
}

// Floats one sequence's raw samples take in the staging region: up to
// N + K - 1 staged, read up to 7 past them by fir4's 16-byte loads, rounded
// to 16 bytes.
__host__ __device__ constexpr int seq_floats(int logn, int K) {
    return ((1 << logn) + K + 10) & ~3;
}

// Floats of the region that holds the FFT buffer (pad(N) float2) and, before
// each transform, the raw samples of two sequences.
__host__ __device__ constexpr int stage_floats(int logn, int K) {
    return ((2 * fftreg::pad(1 << logn) > 2 * seq_floats(logn, K)
                 ? 2 * fftreg::pad(1 << logn)
                 : 2 * seq_floats(logn, K)) + 3) & ~3;
}

// Shared memory: the staging region, the ring where it fits, the taps
// reversed (padded to a multiple of 4) and the taps in order.
size_t smem_bytes(int logn, int K) {
    return sizeof(float) * (stage_floats(logn, K) +
                            (logn <= kRingMaxLogN ? 4 << logn : 0) +
                            ((K + 3) & ~3) + K);
}

// Sums a and b over the T threads of the block; every thread gets the same
// sums, bit for bit.  red: one double2 per warp.
template <int T>
__device__ __forceinline__ void block_sums(double& a, double& b,
                                           double2* red) {
    constexpr int W = T < 32 ? T : 32;
    constexpr unsigned mask = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
#pragma unroll
    for (int o = W / 2; o >= 1; o >>= 1) {
        a += __shfl_xor_sync(mask, a, o);
        b += __shfl_xor_sync(mask, b, o);
    }
    if constexpr (T > 32) {
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_double2(a, b);
        __syncthreads();
        a = 0.0;
        b = 0.0;
#pragma unroll
        for (int i = 0; i < T / 32; ++i) {
            a += red[i].x;
            b += red[i].y;
        }
    }
}

// raw[j] = sig[from - (K - 1) + j] for j < count, zero before the signal.
template <int T>
__device__ __forceinline__ void stage(float* raw, const float* sig,
                                      long long from, int count, int K) {
    const long long first = from - (K - 1);
    for (int j = threadIdx.x; j < count; j += T) {
        const long long i = first + j;
        raw[j] = i >= 0 ? __ldg(sig + i) : 0.f;
    }
}

// One bin's terms from z = Z_k and w = Z_{N-k} of scaled sequences, with
// fa = 4^a, fb = 4^b, fab = 2^(a+b).  pair: |X|^2, |Y|^2, Re and Im of
// Y conj X; auto: |X|^2 + |Y|^2 (|X|^2 alone for a lone segment).
__device__ __forceinline__ void accumulate(double* acc, float2 z, float2 w,
                                           double fa, double fb, double fab,
                                           bool pair, bool has_b) {
    const double zr = z.x, zi = z.y, wr = w.x, wi = w.y;
    const double xr = 0.5 * (zr + wr), xi = 0.5 * (zi - wi);
    const double yr = 0.5 * (zi + wi), yi = 0.5 * (wr - zr);
    const double xx = xr * xr + xi * xi;
    const double yy = yr * yr + yi * yi;
    if (pair) {
        acc[0] += fa * xx;
        acc[1] += fb * yy;
        acc[2] += fab * (yr * xr + yi * xi);
        acc[3] += fab * (yi * xr - yr * xi);
    } else {
        acc[0] += has_b ? fa * xx + fb * yy : fa * xx;
    }
}

// Bin k's sums of item (g, c) into `part` (ngroups, nch + 1, 3, nbins).
__device__ __forceinline__ void store(double* part, int g, int c, int nch,
                                      int nbins, int k, const double* acc,
                                      bool pair) {
    const long long row = static_cast<long long>(g) * (nch + 1);
    if (pair) {
        double* o = part + (row + c) * 3 * nbins;
        o[k] = acc[1];
        o[nbins + k] = acc[2];
        o[2 * nbins + k] = acc[3];
    }
    if (!pair || c == 1) {
        double* o = part + row * 3 * nbins;
        o[k] = acc[0];
        o[nbins + k] = 0.0;
        o[2 * nbins + k] = 0.0;
    }
}

template <int LOGN>
__global__ void __launch_bounds__(block_threads(LOGN), min_blocks(LOGN))
welch_pair_kernel(const float* __restrict__ x, const float* __restrict__ xf,
                  const float* __restrict__ y,
                  long long y_row_stride, const float* __restrict__ taps_g,
                  int K, const float* __restrict__ means,
                  const float* __restrict__ win,
                  const float2* __restrict__ tw, double* __restrict__ part,
                  int hop, int navr, int nch, int ngroups, int nbins) {
    constexpr int N = 1 << LOGN;
    constexpr int P = fftreg::kPoints;
    constexpr int T = N / P;
    constexpr int B = P / 2;   // bin pairs (j, N - j) a thread: j = t + b*T
    constexpr bool kRing = LOGN <= kRingMaxLogN;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double2 red[T > 32 ? T / 32 : 1];
    __shared__ double nyq[4];   // bin N/2's sums (thread 0)
    float2* buf = reinterpret_cast<float2*>(smem);
    float* raw = reinterpret_cast<float*>(smem);   // before the transform
    float* ring = raw + stage_floats(LOGN, K);
    float* rtaps = ring + (kRing ? 4 * N : 0);
    float* taps = rtaps + ((K + 3) & ~3);
    const int t = threadIdx.x;
    const int seq = seq_floats(LOGN, K);   // raw b follows raw a
    for (int k = t; k < K; k += T) {
        const float tap = taps_g[k];
        taps[k] = tap;
        rtaps[K - 1 - k] = tap;
    }
    // (the first read of taps follows an item's first barrier)

    const bool pair = nch > 0;
    // x filtered ahead (kernel A): its slots are read, only y_c filtered
    const bool xpre = pair && xf != nullptr;
    const int ncols = pair ? nch : 1;
    const int nunits = pair ? navr : (navr + 1) / 2;
    const int per_group = (nunits + ngroups - 1) / ngroups;
    const int nitems = ngroups * ncols;
    const float mx = means[0];
    for (int item = blockIdx.x; item < nitems; item += gridDim.x) {
        // the channels of one group run side by side and share x in L2
        const int g = item / ncols;
        const int c = pair ? 1 + item % ncols : 0;
        const float* sb_sig =
            pair ? y + static_cast<long long>(c - 1) * y_row_stride : x;
        const float mb = means[c];
        double acc[B][4];
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[b][r] = 0.0;
        if (t == 0)
            for (int r = 0; r < 4; ++r) nyq[r] = 0.0;
        const int u0 = g * per_group;
        const int u1 = min(nunits, u0 + per_group);
        // the end of the group's last span: filtering ahead stops there
        const int ul = u1 - 1;
        [[maybe_unused]] const long long group_hi =
            static_cast<long long>(pair ? ul : 2 * ul) * hop + N +
            (!pair && 2 * ul + 1 < navr ? hop : 0);
        [[maybe_unused]] long long filtered = 0;   // times already in the ring
        for (int u = u0; u < u1; ++u) {
            const long long sa = static_cast<long long>(pair ? u : 2 * u) * hop;
            const long long sb = pair ? sa : sa + hop;
            const bool has_b = pair || 2 * u + 1 < navr;
            float2 v[P];
            if constexpr (kRing) {
                // ring of len samples a sequence, indexed by time mod len
                const int len = pair ? 2 * N : 4 * N;
                const int mask = len - 1;
                float* ring_b = pair ? ring + 2 * N : ring;
                const long long hi = (has_b ? sb : sa) + N;
                if (u == u0) filtered = sa;
                if (filtered < hi) {
                    // the samples [from, to) of each sequence into the
                    // ring: this unit's new ones, and ahead of them at
                    // least 4 outputs a thread (at small hop, several
                    // units' worth), as far as the ring and the group reach
                    const long long from = filtered;
                    long long to = hi > from + 4 * T ? hi : from + 4 * T;
                    if (to > sa + len) to = sa + len;
                    if (to > group_hi) to = group_hi;
                    const int nnew = static_cast<int>(to - from);
                    if (xpre) {
                        // the previous unit's last barrier freed the slots
                        for (int j = t; j < nnew; j += T)
                            ring[static_cast<int>((from + j) & mask)] =
                                __ldg(xf + from + j) - mx;
                        stage<T>(raw, sb_sig, from, nnew + K - 1, K);
                    } else {
                        stage<T>(raw, x, from, nnew + K - 1, K);
                        if (pair)
                            stage<T>(raw + seq, sb_sig, from, nnew + K - 1,
                                     K);
                    }
                    __syncthreads();
                    for (int j0 = 4 * t; j0 < nnew; j0 += 4 * T) {
                        float fa[4], fb[4];
                        if (xpre)
                            fir4<false>(raw, raw, rtaps, K, j0, fb, fa);
                        else if (pair)
                            fir4<true>(raw, raw + seq, rtaps, K, j0, fa, fb);
                        else
                            fir4<false>(raw, raw, rtaps, K, j0, fa, fb);
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            if (j0 + i >= nnew) break;
                            const int slot =
                                static_cast<int>((from + j0 + i) & mask);
                            if (!xpre) ring[slot] = fa[i] - mx;
                            if (pair) ring_b[slot] = fb[i] - mb;
                        }
                    }
                    __syncthreads();
                    filtered = to;
                }
#pragma unroll
                for (int r = 0; r < P; ++r) {
                    const int n = t + r * T;
                    const float w = __ldg(win + n);
                    v[r] = make_float2(
                        ring[static_cast<int>((sa + n) & mask)] * w,
                        has_b ? ring_b[static_cast<int>((sb + n) & mask)] * w
                              : 0.f);
                }
            } else {
                // the whole span of each sequence, filtered into registers
                // (x's read from xf where it was filtered ahead)
                if (!xpre) stage<T>(raw, x, sa, N + K - 1, K);
                if (has_b) stage<T>(raw + seq, sb_sig, sb, N + K - 1, K);
                __syncthreads();
#pragma unroll
                for (int r = 0; r < P; ++r) {
                    const int n = t + r * T;
                    const float w = __ldg(win + n);
                    if (xpre) {
                        v[r] = make_float2(
                            (__ldg(xf + sa + n) - mx) * w,
                            (fir_point(raw + seq + n, taps, K) - mb) * w);
                    } else if (has_b) {
                        const float2 f =
                            fir_pair(raw + n, raw + seq + n, taps, K);
                        v[r] = make_float2((f.x - mx) * w, (f.y - mb) * w);
                    } else {
                        v[r] = make_float2(
                            (fir_point(raw + n, taps, K) - mx) * w, 0.f);
                    }
                }
            }

            // each sequence by its own power of two (exact)
            double ssa = 0.0, ssb = 0.0;
#pragma unroll
            for (int r = 0; r < P; ++r) {
                ssa += static_cast<double>(v[r].x) * v[r].x;
                ssb += static_cast<double>(v[r].y) * v[r].y;
            }
            block_sums<T>(ssa, ssb, red);
            const int ea = fftreg::scale_exponent(ssa);
            const int eb = fftreg::scale_exponent(ssb);
            const float ka = ldexpf(1.f, -ea), kb = ldexpf(1.f, -eb);
#pragma unroll
            for (int r = 0; r < P; ++r) {
                v[r].x *= ka;
                v[r].y *= kb;
            }

            fftreg::transform<LOGN>(v, buf, tw, t);

            const double fa = ldexp(1.0, 2 * ea), fb = ldexp(1.0, 2 * eb);
            const double fab = ldexp(1.0, ea + eb);
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const int j = t + b * T;
                accumulate(acc[b], buf[fftreg::pad(j)],
                           buf[fftreg::pad((N - j) & (N - 1))], fa, fb, fab,
                           pair, has_b);
            }
            if (t == 0) {
                const float2 z = buf[fftreg::pad(N / 2)];
                accumulate(nyq, z, z, fa, fb, fab, pair, has_b);
            }
            __syncthreads();   // the next unit stages into buf
        }

#pragma unroll
        for (int b = 0; b < B; ++b) {
            const int k = t + b * T;
            if (k < nbins) store(part, g, c, nch, nbins, k, acc[b], pair);
        }
        if (t == 0 && N / 2 < nbins) {
            double s[4];
            for (int r = 0; r < 4; ++r) s[r] = nyq[r];
            store(part, g, c, nch, nbins, N / 2, s, pair);
        }
    }
}

// Resident blocks of welch_pair_kernel<LOGN> on the current device for K
// taps (cached per device, N and K); sets the kernel's shared-memory limit
// on first use.
template <int LOGN>
cudaError_t resident(int K, int* out) {
    static int cached_k[kMaxDevices] = {};
    static int cached_n[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (cached_k[dev] != K) {
        auto kernel = welch_pair_kernel<LOGN>;
        const size_t smem = smem_bytes(LOGN, K);
        int sms = 0, per_sm = 0;
        if ((e = cudaFuncSetAttribute(
                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 static_cast<int>(smem_bytes(LOGN, kFirMaxTaps)))) !=
                cudaSuccess ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kernel, block_threads(LOGN), smem)) != cudaSuccess)
            return e;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        cached_n[dev] = per_sm * sms;
        cached_k[dev] = K;
    }
    *out = cached_n[dev];
    return cudaSuccess;
}

template <int LOGN>
cudaError_t launch(const float* x, const float* xf, const float* y,
                   long long y_row_stride,
                   const float* taps, int K, const float* means,
                   const float* win, const float2* tw, double* part, int hop,
                   int navr, int nch, int ngroups, int nbins,
                   cudaStream_t stream) {
    int cap = 0;
    cudaError_t e = resident<LOGN>(K, &cap);
    if (e != cudaSuccess) return e;
    const long long items =
        static_cast<long long>(ngroups) * (nch > 0 ? nch : 1);
    welch_pair_kernel<LOGN>
        <<<static_cast<unsigned>(items < cap ? items : cap),
           block_threads(LOGN), smem_bytes(LOGN, K), stream>>>(
            x, xf, y, y_row_stride, taps, K, means, win, tw, part, hop, navr,
            nch, ngroups, nbins);
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
extern "C" int pyfft_welch_pair_resident(int nwins, int K) {
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

// x: reference signal (nt,) float32; xf: null, or x filtered by the taps
// (nt,) float32 (kernel A's output; read for nch >= 1 only); y: nch real
// signals with row stride `y_row_stride` floats (nch = 0: x alone,
// segments paired with each other).  taps: (K,) float32.  means: (nch +
// 1,) float32, reference first.  win: (nwins,) float32.  tw: (nwins/2,)
// complex64, exp(-2 pi i m / nwins).  part: (ngroups, nch + 1, 3, nbins)
// float64 scratch.  out: (nch + 1, 3, nbins) float32, nbins <= nwins/2 +
// 1.  The caller checks that the segments fit the signal.  Returns
// cudaGetLastError() after the second launch (or the first error).
extern "C" int pyfft_welch_pair(const float* x, const float* xf,
                                const float* y,
                                long long y_row_stride, const float* taps,
                                int K, const float* means, const float* win,
                                const void* tw, double* part, float* out,
                                int nch, int nwins, int hop, int navr,
                                int ngroups, int nbins, double norm,
                                void* stream_ptr) {
    const int logN = log2_of(nwins);
    if (logN < 0 || K < 1 || K > kFirMaxTaps || hop < 1 || hop > nwins ||
        navr < 1 || ngroups < 1 || nch < 0 || nch + 1 > 65535 || nbins < 1 ||
        nbins > nwins / 2 + 1 ||
        static_cast<long long>(ngroups) * (nch > 0 ? nch : 1) > INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const float2* t = static_cast<const float2*>(tw);
    const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t e = cudaErrorInvalidValue;
    switch (logN) {
#define PYFFT_WELCH_PAIR_CASE(L)                                              \
    case L:                                                                   \
        e = launch<L>(x, xf, y, y_row_stride, taps, K, means, win, t, part,  \
                      hop, navr, nch, ngroups, nbins, s);                     \
        break;
        PYFFT_WELCH_PAIR_CASE(4) PYFFT_WELCH_PAIR_CASE(5)
        PYFFT_WELCH_PAIR_CASE(6) PYFFT_WELCH_PAIR_CASE(7)
        PYFFT_WELCH_PAIR_CASE(8) PYFFT_WELCH_PAIR_CASE(9)
        PYFFT_WELCH_PAIR_CASE(10) PYFFT_WELCH_PAIR_CASE(11)
        PYFFT_WELCH_PAIR_CASE(12) PYFFT_WELCH_PAIR_CASE(13)
        PYFFT_WELCH_PAIR_CASE(14)
#undef PYFFT_WELCH_PAIR_CASE
        default: break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long per_part = static_cast<long long>(nch + 1) * 3 * nbins;
    return launch_sum_partials(part, out, ngroups, per_part, norm, s);
}
