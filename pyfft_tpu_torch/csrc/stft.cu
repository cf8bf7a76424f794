// Kernel C: per-segment STFT after global-mean detrend and window.
//
// Replaces pyfft_tpu/ops/pallas_welch3.py::_v3_fused_stft_kernel and
// ::_v3_stft_kernel, its sibling for a padded, interleaved signal
// (nt % 128 != 0); one kernel that takes any nt covers both.  There is no
// filter on this path (the JAX pipeline runs it with m = 0, nbands = 0).
//
// For signal c and segment s (start s*hop, s < navr) the block forms
//   v[n] = (sig_c[start+n] - mean_c) * win[n],   n < N = nwins,
// and writes norm * DFT(v) for all N bins, in natural order, to
// out[c, s, :].  Real signals (cplx = 0) are rows of float32; complex ones
// (cplx = 1) are interleaved complex64 with one (re, im) mean pair.
//
// What bounds it on the card: per segment about 5*N*log2(N) flops of FFT,
// all through shared memory with one barrier per radix-2 stage, against
// reading N samples and writing 8*N bytes.  At the shape of bench config 2
// (2^24 samples, N = 2048, hop 1024) the result is 268 MB, more than four
// times the 64 MB signal, so device memory is the floor (about 0.1 ms at
// 3.35 TB/s) and the shared-memory passes (11 stages of N/2 butterflies)
// are the likely cost.
// Design: grid (group of segments) x (signal); per segment one block loads
// the windowed, detrended samples straight from device memory into a
// complex shared buffer in bit-reversed order, runs fft_radix2 (fft.cuh,
// shared with kernel B; twiddles from a float64 host table) and stores the
// N bins with coalesced 8-byte stores.  Nothing is accumulated, so there
// is no second pass.  Shared memory is 8*N bytes, at most 128 KB.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinN = 16;
constexpr int kMaxN = 16384;

__global__ void __launch_bounds__(kMaxThreads)
stft_kernel(const float* __restrict__ x, const float* __restrict__ y,
            long long y_row_stride, int cplx,
            const float* __restrict__ means, const float* __restrict__ win,
            const float2* __restrict__ tw, float2* __restrict__ out, int N,
            int logN, int hop, int navr, int seg_per_group, float norm) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* buf = reinterpret_cast<float2*>(smem);
    const int c = blockIdx.y;
    const int T = blockDim.x;
    const int estride = cplx ? 2 : 1;
    const float* sig =
        c ? y + static_cast<long long>(c - 1) * y_row_stride : x;
    const float m_re = means[estride * c];
    const float m_im = cplx ? means[2 * c + 1] : 0.f;

    const int s0 = blockIdx.x * seg_per_group;
    const int s1 = min(navr, s0 + seg_per_group);
    for (int s = s0; s < s1; ++s) {
        const long long start = static_cast<long long>(s) * hop;
        if (cplx) {
            const float2* z = reinterpret_cast<const float2*>(sig) + start;
            for (int n = threadIdx.x; n < N; n += T) {
                const float w = __ldg(win + n);
                const float2 v = __ldg(z + n);
                buf[bitrev(n, logN)] =
                    make_float2((v.x - m_re) * w, (v.y - m_im) * w);
            }
        } else {
            const float* r = sig + start;
            for (int n = threadIdx.x; n < N; n += T) {
                buf[bitrev(n, logN)] =
                    make_float2((__ldg(r + n) - m_re) * __ldg(win + n), 0.f);
            }
        }
        __syncthreads();
        fft_radix2(buf, tw, N, logN);
        float2* o = out + (static_cast<long long>(c) * navr + s) * N;
        for (int k = threadIdx.x; k < N; k += T) {
            const float2 z = buf[k];
            o[k] = make_float2(z.x * norm, z.y * norm);
        }
        __syncthreads();
    }
}

int threads_for(int N) {
    return N / 4 < 32 ? 32 : (N / 4 > kMaxThreads ? kMaxThreads : N / 4);
}

}  // namespace

// x: first signal, y: nsig-1 further signals with row stride `y_row_stride`
// floats (complex rows: twice the complex stride).  cplx 0: float32 rows;
// cplx 1: interleaved complex64 rows, 8-byte aligned.  means: nsig *
// (1 + cplx) float32, first signal first.  win: (nwins,) float32.  tw:
// (nwins/2,) complex64.  out: (nsig, navr, nwins) complex64.
// Returns cudaGetLastError() after the launch (or the first error).
extern "C" int pyfft_stft(const float* x, const float* y,
                          long long y_row_stride, int cplx, int nsig,
                          const float* means, const float* win,
                          const void* tw, void* out, int nwins, int hop,
                          int navr, int ngroups, float norm,
                          void* stream_ptr) {
    const int N = nwins;
    if (N < kMinN || N > kMaxN || (N & (N - 1)) || hop < 1 || hop > N ||
        navr < 1 || ngroups < 1 || nsig < 1 || nsig > 65535 ||
        (cplx != 0 && cplx != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    int logN = 0;
    while ((1 << logN) < N) ++logN;
    const size_t smem = sizeof(float2) * N;
    cudaError_t e = cudaFuncSetAttribute(
        stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int spg = (navr + ngroups - 1) / ngroups;
    const dim3 grid(static_cast<unsigned>((navr + spg - 1) / spg),
                    static_cast<unsigned>(nsig));
    stft_kernel<<<grid, threads_for(N), smem,
                  static_cast<cudaStream_t>(stream_ptr)>>>(
        x, y, y_row_stride, cplx, means, win, static_cast<const float2*>(tw),
        static_cast<float2*>(out), N, logN, hop, navr, spg, norm);
    return static_cast<int>(cudaGetLastError());
}
