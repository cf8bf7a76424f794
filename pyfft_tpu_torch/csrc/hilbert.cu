// Kernel D: the middle section of the factored analytic-signal transform.
//
// Replaces pyfft_tpu/hilbert.py::_hilb_slab_kernel (launched by
// _analytic_factored_slab).  The transform of N = n1 * M samples is split
// as a four-step FFT: the caller (ops/hilbert.py) runs the outer n1-point
// DFT over the strided columns of x viewed as (n1, M) with torch.fft, as
// the JAX package leaves its outer stage to XLA, and the inverse n1-point
// DFT after this kernel.  For row k1 of the outer spectrum A (n1, M) one
// block computes
//   v[m]  = A[k1, m] * W_N^(m k1)                 (twiddle)
//   X[k'] = sum_m v[m] W_M^(m k')                  (M-point FFT)
//   X[k'] *= h(k1 + n1 k')                         (analytic mask)
//   u[m]  = sum_k' X[k'] W_M^(-m k')               (inverse M-point FFT)
//   B[k1, m] = u[m] * W_N^(-m k1) / M              (conjugate twiddle)
// where h(k) is 1 at k = 0 and at the Nyquist bin, 2 below it and 0 above
// (reference hilbert.py:105-109).  The outer inverse DFT's 1/n1 completes
// the 1/N of the inverse transform.
//
// What bounds it on the card: per row one load and one store of 8*M bytes
// (256 MB in all at N = 2^24) against two M-point radix-2 FFTs, about
// 10*M*log2(M) flops, all through shared memory with one barrier per
// stage, and two float64 sincospi per sample for the twiddles.  As with
// kernel C the shared-memory passes, not device memory, are the likely
// cost.
// Design: the TPU kernel holds a (n2, n3) slab per k1 in VMEM (512 KB at
// N = 2^24), which does not fit a block's 227 KB of shared memory, so the
// split is re-derived for the card: one row of M <= 16384 complex64
// samples (128 KB) per block.  The wrapper's split takes rows of 8192
// (64 KB: three blocks per SM against one at 16384, and faster on the
// card at config 4).  The forward FFT is fft.cuh's radix-2 DIT
// (shared with kernels B and C); the inverse reuses it through
// conj(FFT(conj(.))), with the mask, the conjugation and the bit-reversed
// reordering fused into one pass over shared memory.  Twiddles W_N^(m k1)
// come from an exact integer reduction m*k1 mod N and a float64 sincospi.
// The TPU kernel's bf16x3 split, half-width stage-3 tables with their
// rank-1 Nyquist correction, and hoisted twiddles were workarounds for the
// MXU and Mosaic; a full-width row FFT needs none of them.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinM = 16;
constexpr int kMaxM = 16384;

// exp(-2 pi i r / N) for 0 <= r < N, in float64 then rounded.
__device__ __forceinline__ float2 twiddle_n(long long r, long long N) {
    double s, c;
    sincospi(2.0 * static_cast<double>(r) / static_cast<double>(N), &s, &c);
    return make_float2(static_cast<float>(c), static_cast<float>(-s));
}

__device__ __forceinline__ float mask_gain(long long k, long long nyq) {
    return (k == 0 || k == nyq) ? 1.f : (k < nyq ? 2.f : 0.f);
}

__global__ void __launch_bounds__(kMaxThreads)
hilbert_kernel(const float2* __restrict__ in, float2* __restrict__ out,
               const float2* __restrict__ tw, int M, int logM, int n1,
               long long N, long long nyq, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* buf = reinterpret_cast<float2*>(smem);
    const int k1 = blockIdx.x;
    const int T = blockDim.x;
    const long long row = static_cast<long long>(k1) * M;

    // twiddle, into bit-reversed order for the DIT FFT
    for (int m = threadIdx.x; m < M; m += T) {
        const float2 v = __ldg(in + row + m);
        const float2 w = twiddle_n((static_cast<long long>(m) * k1) % N, N);
        buf[bitrev(m, logM)] =
            make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
    }
    __syncthreads();
    fft_radix2(buf, tw, M, logM);           // X[k'] in natural order

    // mask and conjugate, and reorder bit-reversed for the inverse: the
    // thread with i <= bitrev(i) owns the pair (i, bitrev(i))
    for (int i = threadIdx.x; i < M; i += T) {
        const int j = bitrev(i, logM);
        if (i <= j) {
            const float2 a = buf[i];
            const float2 b = buf[j];
            const long long k = k1 + static_cast<long long>(n1) * i;
            const float hi = mask_gain(k, nyq);
            const float hj = mask_gain(k1 + static_cast<long long>(n1) * j,
                                       nyq);
            buf[i] = make_float2(b.x * hj, -b.y * hj);
            buf[j] = make_float2(a.x * hi, -a.y * hi);
        }
    }
    __syncthreads();
    fft_radix2(buf, tw, M, logM);           // conj of the inverse FFT

    // conjugate back, conjugate twiddle, 1/M
    for (int m = threadIdx.x; m < M; m += T) {
        const float2 z = buf[m];
        const float2 w = twiddle_n((static_cast<long long>(m) * k1) % N, N);
        // conj(z) * conj(w) = conj(z * w)
        out[row + m] = make_float2((z.x * w.x - z.y * w.y) * scale,
                                   -(z.x * w.y + z.y * w.x) * scale);
    }
}

int threads_for(int M) {
    return M / 4 < 32 ? 32 : (M / 4 > kMaxThreads ? kMaxThreads : M / 4);
}

bool bad_row(int M) {
    return M < kMinM || M > kMaxM || (M & (M - 1));
}

cudaError_t set_smem(int M) {
    return cudaFuncSetAttribute(hilbert_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(sizeof(float2) * M));
}

}  // namespace

// in, out: (n1, M) complex64 rows, contiguous, distinct.  tw: (M/2,)
// complex64, tw[m] = exp(-2 pi i m / M).  M a power of two in 16..16384,
// n1 >= 1.  Returns cudaGetLastError() after the launch (or the first
// error).
extern "C" int pyfft_hilbert(const void* in, void* out, const void* tw,
                             int n1, int M, void* stream_ptr) {
    if (bad_row(M) || n1 < 1) return static_cast<int>(cudaErrorInvalidValue);
    int logM = 0;
    while ((1 << logM) < M) ++logM;
    const long long N = static_cast<long long>(n1) * M;
    const long long nyq = N % 2 ? (N + 1) / 2 : N / 2;
    cudaError_t e = set_smem(M);
    if (e != cudaSuccess) return static_cast<int>(e);
    hilbert_kernel<<<static_cast<unsigned>(n1), threads_for(M),
                     sizeof(float2) * M,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
        static_cast<const float2*>(in), static_cast<float2*>(out),
        static_cast<const float2*>(tw), M, logM, n1, N, nyq,
        1.f / static_cast<float>(M));
    return static_cast<int>(cudaGetLastError());
}

// Resident blocks of kernel D per SM for rows of M points (its occupancy),
// or minus the CUDA error code.
extern "C" int pyfft_hilbert_blocks_per_sm(int M) {
    if (bad_row(M)) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = set_smem(M);
    if (e != cudaSuccess) return -static_cast<int>(e);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, hilbert_kernel, threads_for(M), sizeof(float2) * M);
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
