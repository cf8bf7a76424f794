// Kernel C: per-segment STFT after global-mean detrend and window.
//
// Replaces pyfft_tpu/ops/pallas_welch3.py::_v3_fused_stft_kernel and
// ::_v3_stft_kernel, its sibling for a padded, interleaved signal
// (nt % 128 != 0); one kernel that takes any nt covers both.  There is no
// filter on this path (the JAX pipeline runs it with m = 0, nbands = 0).
//
// For signal c and segment s (start s*hop, s < navr) it forms
//   v[n] = (sig_c[start+n] - mean_c) * win[n],   n < N = nwins,
// and writes norm * DFT(v) for all N bins, in natural order, to
// out[c, s, :].  Real signals (cplx = 0) are rows of float32; complex ones
// (cplx = 1) are interleaved complex64 with one (re, im) mean pair.
//
// What bounds it on the card: device memory.  At the shape of bench config
// 2 (2^24 samples, N = 2048, hop 1024) it reads the 64 MB signal and writes
// 268 MB of spectra, about 0.1 ms at 3.35 TB/s; the FFTs are about 0.9
// GFLOP (0.014 ms at the float32 peak) and their shared-memory traffic a
// few hundred MB.  So the design keeps enough transforms in flight to
// stream the output at the memory's rate, with little arithmetic or
// synchronisation between a load and its stores:
// - two real segments per complex FFT: segments 2p and 2p+1 of one signal
//   go in as Z = a + i b, and each bin of both comes out of the one
//   spectrum, A_k = (Z_k + conj Z_{N-k}) / 2, B_k = (Z_k - conj Z_{N-k}) /
//   2i (float32).  Each thread writes bin k of both segments, so both
//   stores run in natural order.  With an odd navr the last segment goes
//   alone (zero imaginary part); complex signals take one segment per FFT.
//   Pairs never cross signals.  Before the transform each segment of a
//   pair is scaled by a power of two to a sum of squares near 1 (one
//   reduction over the transform's threads), and its bins are scaled back
//   on the way out, so a quiet segment beside a loud one keeps the
//   accuracy it would have alone.
// - the FFT is fft_reg.cuh's register-radix Stockham transform: N/16
//   threads with 16 points each, log16(N) passes (16.16.8 at N = 2048)
//   through padded shared memory, twiddles from a float64 table read
//   through L1, natural order out.
// - the first pass loads its 16 points per thread straight from device
//   memory in its own stride (sample t + r*N/16, coalesced across
//   threads), with the mean and the window applied on the way in; each
//   thread stores two adjacent bins at a time, coalesced 16-byte streaming
//   stores (__stcs: nothing reads the spectra back here).
// - persistent blocks of max(N/16, 128) threads (several transforms per
//   block below N = 2048) walk over the (signal, pair) items; several
//   blocks share an SM.  Shared memory is 17*N/16 float2 per transform
//   (136 KB at N = 16384).
#include <cuda_runtime.h>

#include "fft_reg.cuh"

namespace {

constexpr int kMinLogN = 4;
constexpr int kMaxLogN = 14;
constexpr int kMaxDevices = 64;

// Threads of a block: one transform of N/16 threads, or several of them
// up to 128.
__host__ __device__ constexpr int block_threads(int logn) {
    return (1 << logn) / fftreg::kPoints > 128
               ? (1 << logn) / fftreg::kPoints : 128;
}

__host__ __device__ constexpr size_t smem_bytes(int logn) {
    return sizeof(float2) *
           (block_threads(logn) / ((1 << logn) / fftreg::kPoints)) *
           fftreg::pad(1 << logn);
}

// Blocks an SM should hold at once: about 768 threads.
__host__ __device__ constexpr int min_blocks(int logn) {
    return block_threads(logn) >= 768 ? 1 : 768 / block_threads(logn);
}

// Sums a and b over the T threads of each transform; every thread of a
// transform gets the same sums, bit for bit (the butterfly adds each pair
// in both orders, and above a warp all threads read the same partials in
// the same order).  red: one double2 per warp of the block.
template <int T>
__device__ __forceinline__ void transform_sums(double& a, double& b,
                                               double2* red) {
    constexpr int W = T < 32 ? T : 32;
#pragma unroll
    for (int o = W / 2; o >= 1; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if constexpr (T > 32) {
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_double2(a, b);
        __syncthreads();
        const double2* r = red + (threadIdx.x / T) * (T / 32);
        a = 0.0;
        b = 0.0;
#pragma unroll
        for (int i = 0; i < T / 32; ++i) {
            a += r[i].x;
            b += r[i].y;
        }
    }
}

template <int LOGN>
__global__ void __launch_bounds__(block_threads(LOGN), min_blocks(LOGN))
stft_kernel(const float* __restrict__ x, const float* __restrict__ y,
            long long y_row_stride, int cplx, int nsig,
            const float* __restrict__ means, const float* __restrict__ win,
            const float2* __restrict__ tw, float2* __restrict__ out, int hop,
            int navr, float norm) {
    constexpr int N = 1 << LOGN;
    constexpr int P = fftreg::kPoints;
    constexpr int T = N / P;
    constexpr int F = block_threads(LOGN) / T;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double2 red[block_threads(LOGN) / 32];
    const int slot = threadIdx.x / T;
    const int t = threadIdx.x % T;
    float2* spec = reinterpret_cast<float2*>(smem) + slot * fftreg::pad(N);
    const float half_norm = 0.5f * norm;

    // items: (signal, segment pair) for real signals, the last segment of
    // an odd navr alone; (signal, segment) for complex ones
    const int per_sig = cplx ? navr : (navr + 1) / 2;
    const long long items = static_cast<long long>(nsig) * per_sig;
    for (long long base = static_cast<long long>(blockIdx.x) * F;
         base < items; base += static_cast<long long>(gridDim.x) * F) {
        const long long item = base + slot;
        const bool active = item < items;
        const int c = active ? static_cast<int>(item / per_sig) : 0;
        const int p = active ? static_cast<int>(item % per_sig) : 0;
        const int s = cplx ? p : 2 * p;
        const bool pair = !cplx && s + 1 < navr;
        const float* sig =
            c ? y + static_cast<long long>(c - 1) * y_row_stride : x;
        const long long start = static_cast<long long>(s) * hop;

        float2 v[P];
        if (!active) {
#pragma unroll
            for (int r = 0; r < P; ++r) v[r] = make_float2(0.f, 0.f);
        } else if (cplx) {
            const float2* z = reinterpret_cast<const float2*>(sig) + start;
            const float m_re = means[2 * c], m_im = means[2 * c + 1];
#pragma unroll
            for (int r = 0; r < P; ++r) {
                const int n = t + r * T;
                const float w = __ldg(win + n);
                const float2 u = __ldg(z + n);
                v[r] = make_float2((u.x - m_re) * w, (u.y - m_im) * w);
            }
        } else {
            const float* a = sig + start;
            const float m = means[c];
#pragma unroll
            for (int r = 0; r < P; ++r) {
                const int n = t + r * T;
                const float w = __ldg(win + n);
                v[r] = make_float2((__ldg(a + n) - m) * w,
                                   pair ? (__ldg(a + hop + n) - m) * w : 0.f);
            }
        }

        // Each real segment of a pair is scaled by its own power of two,
        // 2^-ea and 2^-eb (exact), to a sum of squares in [0.5, 2), and its
        // bins by 2^ea or 2^eb on the way out.  The transform's rounding
        // error follows |Z|: unscaled, a quiet segment beside a loud one
        // would carry the loud one's error; scaled, each segment's error
        // follows its own size, as if it went alone.
        int ea = 0, eb = 0;
        if (!cplx) {
            double sa = 0.0, sb = 0.0;
#pragma unroll
            for (int r = 0; r < P; ++r) {
                sa += static_cast<double>(v[r].x) * v[r].x;
                sb += static_cast<double>(v[r].y) * v[r].y;
            }
            transform_sums<T>(sa, sb, red);
            ea = fftreg::scale_exponent(sa);
            eb = fftreg::scale_exponent(sb);
            const float ka = ldexpf(1.f, -ea), kb = ldexpf(1.f, -eb);
#pragma unroll
            for (int r = 0; r < P; ++r) {
                v[r].x *= ka;
                v[r].y *= kb;
            }
        }

        fftreg::transform<LOGN>(v, spec, tw, t);

        // bins k and k + 1 of both segments (of the one), 16-byte stores
        if (active) {
            float2* o = out + (static_cast<long long>(c) * navr + s) * N;
            const float ga = ldexpf(pair ? half_norm : norm, ea);
            const float gb = ldexpf(half_norm, eb);
#pragma unroll
            for (int r = 0; r < P / 2; ++r) {
                const int k = 2 * (t + r * T);
                const float2 z0 = spec[fftreg::pad(k)];
                const float2 z1 = spec[fftreg::pad(k + 1)];
                float4* oa = reinterpret_cast<float4*>(o + k);
                if (pair) {
                    const float2 m0 = spec[fftreg::pad((N - k) & (N - 1))];
                    const float2 m1 = spec[fftreg::pad(N - k - 1)];
                    __stcs(oa, make_float4((z0.x + m0.x) * ga,
                                           (z0.y - m0.y) * ga,
                                           (z1.x + m1.x) * ga,
                                           (z1.y - m1.y) * ga));
                    __stcs(reinterpret_cast<float4*>(o + N + k),
                           make_float4((z0.y + m0.y) * gb,
                                       (m0.x - z0.x) * gb,
                                       (z1.y + m1.y) * gb,
                                       (m1.x - z1.x) * gb));
                } else {
                    __stcs(oa, make_float4(z0.x * ga, z0.y * ga,
                                           z1.x * ga, z1.y * ga));
                }
            }
        }
    }
}

template <int LOGN>
cudaError_t launch(const float* x, const float* y, long long y_row_stride,
                   int cplx, int nsig, const float* means, const float* win,
                   const float2* tw, float2* out, int hop, int navr,
                   float norm, cudaStream_t stream) {
    constexpr int threads = block_threads(LOGN);
    constexpr int F = threads / ((1 << LOGN) / fftreg::kPoints);
    constexpr size_t smem = smem_bytes(LOGN);
    auto kernel = stft_kernel<LOGN>;
    // resident blocks on the whole card, found once per device (the
    // launch's host work is a good part of a call's time)
    static int resident[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int sms = 0, per_sm = 0;
        if ((e = cudaFuncSetAttribute(
                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 static_cast<int>(smem))) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kernel, threads, smem)) != cudaSuccess)
            return e;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        resident[dev] = per_sm * sms;
    }
    const long long per_sig = cplx ? navr : (navr + 1) / 2;
    const long long blocks = (nsig * per_sig + F - 1) / F;
    const long long cap = resident[dev];
    kernel<<<static_cast<unsigned>(blocks < cap ? blocks : cap), threads,
             smem, stream>>>(x, y, y_row_stride, cplx, nsig, means, win, tw,
                             out, hop, navr, norm);
    return cudaGetLastError();
}

}  // namespace

// x: first signal, y: nsig-1 further signals with row stride `y_row_stride`
// floats (complex rows: twice the complex stride).  cplx 0: float32 rows;
// cplx 1: interleaved complex64 rows, 8-byte aligned.  means: nsig *
// (1 + cplx) float32, first signal first.  win: (nwins,) float32.  tw:
// (nwins/2,) complex64, exp(-2 pi i m / nwins).  out: (nsig, navr, nwins)
// complex64.  Returns cudaGetLastError() after the launch (or the first
// error).
extern "C" int pyfft_stft(const float* x, const float* y,
                          long long y_row_stride, int cplx, int nsig,
                          const float* means, const float* win,
                          const void* tw, void* out, int nwins, int hop,
                          int navr, float norm, void* stream_ptr) {
    int logN = 0;
    while ((1 << logN) < nwins && logN <= kMaxLogN) ++logN;
    if ((1 << logN) != nwins || logN < kMinLogN || logN > kMaxLogN ||
        hop < 1 || hop > nwins || navr < 1 || nsig < 1 || nsig > 65535 ||
        (cplx != 0 && cplx != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const float2* t = static_cast<const float2*>(tw);
    float2* o = static_cast<float2*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t e = cudaErrorInvalidValue;
    switch (logN) {
#define PYFFT_STFT_CASE(L)                                                  \
    case L:                                                                 \
        e = launch<L>(x, y, y_row_stride, cplx, nsig, means, win, t, o, hop, \
                      navr, norm, s);                                       \
        break;
        PYFFT_STFT_CASE(4) PYFFT_STFT_CASE(5) PYFFT_STFT_CASE(6)
        PYFFT_STFT_CASE(7) PYFFT_STFT_CASE(8) PYFFT_STFT_CASE(9)
        PYFFT_STFT_CASE(10) PYFFT_STFT_CASE(11) PYFFT_STFT_CASE(12)
        PYFFT_STFT_CASE(13) PYFFT_STFT_CASE(14)
#undef PYFFT_STFT_CASE
        default: break;
    }
    return static_cast<int>(e);
}
