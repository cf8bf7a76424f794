// Kernel D: the middle section of the factored analytic-signal transform.
//
// Replaces pyfft_tpu/hilbert.py::_hilb_slab_kernel (launched by
// _analytic_factored_slab).  The transform of N = n1 * M samples is split
// as a four-step FFT: the caller (ops/hilbert.py) runs the outer n1-point
// DFT over the strided columns of x viewed as (n1, M) with torch.fft, as
// the JAX package leaves its outer stage to XLA, and the inverse n1-point
// DFT after this kernel.  For row k1 of the outer spectrum A (n1, M) it
// computes
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
// (256 MB in all at N = 2^24, 0.08 ms at 3.35 TB/s) against two M-point
// FFTs, about 10*M*log2(M) flops (0.03 ms at the float32 book rate), so
// device memory, if the transforms' shared-memory passes and barriers keep
// out of its way.  Design:
//   - one row per M/16 threads on fft_reg.cuh's register-radix Stockham
//     FFT, 16 points a thread, log16(M) passes (16.16.16.2 at M = 8192);
//     below M = 2048 a block of 128 threads takes several rows.  Shared
//     memory is pad(M) float2 a row (68 KB at M = 8192).
//   - thread t's point r is sample m = t + r*T (T = M/16), the first
//     pass's order, read straight from device memory (coalesced) and
//     twiddled in registers: no bit reversal, no staging pass.
//   - the mask, the factor 1/M (exact: a power of two) and the
//     conjugation (the inverse as conj(FFT(conj(.)))) are applied as each
//     thread reads its inverse's first-pass points from the spectrum that
//     the forward transform leaves in shared memory, and the outputs are
//     read back in the same order and stored coalesced.  Both transforms
//     run through one copy of fftreg::transform.  A handoff in registers
//     (the last pass's outputs are the next first pass's points after a
//     renaming of registers) saves two shared-memory passes but measured
//     slower on an H100: the permutation is carried across the loop and
//     spills (PERF.md, kernel D).
//   - twiddles: W_N^(m k1) for m = t + r*T is W_N^(t k1) * W_N^(r T k1),
//     two factors with exact integer exponents below N, each from a
//     float64 sincospi rounded to complex64, multiplied in float32: one
//     sincospi a thread for its base and 16 a row for the steps (in
//     shared memory).  One sincospi a sample for each twiddle (2^25 at
//     N = 2^24) measured 0.25 ms slower; these cost about 6% of the
//     kernel, so no host table.
//   - about 1024 threads an SM (two blocks at M = 8192, 64 registers):
//     at 1536 (40 registers) the transforms spill and run slower.
// The TPU kernel's (n2, n3) slab (512 KB at N = 2^24, more than a block's
// 227 KB of shared memory), its bf16x3 split and its half-width stage-3
// tables with their rank-1 Nyquist correction were workarounds for VMEM,
// the MXU and Mosaic; a full-width row FFT needs none of them.
#include <cuda_runtime.h>

#include "fft_reg.cuh"

namespace {

constexpr int kMinLogM = 4;
constexpr int kMaxLogM = 14;
constexpr int kMinThreads = 128;     // below M = 2048 a block takes rows
constexpr int kThreadsPerSM = 1024;  // blocks an SM should hold at once

__host__ __device__ constexpr int row_threads(int logm) {
    return (1 << logm) / fftreg::kPoints;
}

__host__ __device__ constexpr int block_threads(int logm) {
    return row_threads(logm) > kMinThreads ? row_threads(logm) : kMinThreads;
}

__host__ __device__ constexpr int rows_per_block(int logm) {
    return block_threads(logm) / row_threads(logm);
}

__host__ __device__ constexpr size_t smem_bytes(int logm) {
    return sizeof(float2) * rows_per_block(logm) * fftreg::pad(1 << logm);
}

__host__ __device__ constexpr int min_blocks(int logm) {
    return block_threads(logm) >= kThreadsPerSM
               ? 1 : kThreadsPerSM / block_threads(logm);
}

// exp(-2 pi i e / N) from e * (2/N) in float64 (e < N, an exact integer),
// then rounded.
__device__ __forceinline__ float2 twiddle_n(long long e, double two_over_n) {
    double s, c;
    sincospi(static_cast<double>(e) * two_over_n, &s, &c);
    return make_float2(static_cast<float>(c), static_cast<float>(-s));
}

// Rows k1 = blockIdx.x * F + slot, slot < F = rows_per_block(LOGM).
template <int LOGM>
__global__ void __launch_bounds__(block_threads(LOGM), min_blocks(LOGM))
hilbert_kernel(const float2* __restrict__ in, float2* __restrict__ out,
               const float2* __restrict__ tw, int n1, double two_over_n) {
    constexpr int M = 1 << LOGM;
    constexpr int P = fftreg::kPoints;
    constexpr int T = M / P;
    constexpr int F = rows_per_block(LOGM);
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float2 steps[F][P];
    const int slot = threadIdx.x / T;
    const int t = threadIdx.x % T;
    float2* buf = reinterpret_cast<float2*>(smem) + slot * fftreg::pad(M);
    const int k1 = blockIdx.x * F + slot;
    const bool active = k1 < n1;
    const long long row = static_cast<long long>(active ? k1 : 0) * M;

    // W_N^(m k1), m = t + r*T: the row's steps W_N^(r T k1), then this
    // thread's base W_N^(t k1).  Both exponents are below N (t < T, r <
    // 16, k1 < n1): no reduction mod N.
    for (int r = t; r < P; r += T)
        steps[slot][r] =
            twiddle_n(static_cast<long long>(r) * T * k1, two_over_n);
    const float2 base = twiddle_n(static_cast<long long>(t) * k1, two_over_n);
    __syncthreads();

    float2 v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
        const float2 a = active ? __ldg(in + row + t + r * T)
                                : make_float2(0.f, 0.f);
        v[r] = fftreg::cmul(a, fftreg::cmul(base, steps[slot][r]));
    }
    // Both transforms run one copy of the code: unrolled, the compiler kept
    // the forward passes' twiddles for the inverse's, and spilled them.
#pragma unroll 1
    for (int round = 0;; ++round) {
        fftreg::transform<LOGM>(v, buf, tw, t);
        if (round) break;
        // The spectrum in natural order: bin n = t + q*T is the inverse's
        // point q.  Mask, 1/M and the conjugation of conj(FFT(conj(.))).
        // N is even (M >= 16) and k1 < n1, so the bin k = k1 + n1*n is
        // below N/2 exactly when n < M/2, that is q < 8, and k is 0 or N/2
        // only in row 0 at n = 0 and n = M/2 (t = 0, q = 0 and 8): gain 2
        // below q = 8, 0 above it, 1 at those two bins.
        const bool edge = t == 0 && k1 == 0;
#pragma unroll
        for (int q = 0; q < P; ++q) {
            const float2 x = buf[fftreg::pad(t + q * T)];
            const float h = q == 0 ? (edge ? 1.f / M : 2.f / M)
                            : q == P / 2 ? (edge ? 1.f / M : 0.f)
                            : q < P / 2 ? 2.f / M : 0.f;
            v[q] = make_float2(x.x * h, -x.y * h);
        }
    }
    if (!active) return;

    // conj(M * ifft) at m = t + q*T: out = conj(z * W_N^(m k1))
#pragma unroll
    for (int q = 0; q < P; ++q) {
        const float2 z = fftreg::cmul(buf[fftreg::pad(t + q * T)],
                                      fftreg::cmul(base, steps[slot][q]));
        out[row + t + q * T] = make_float2(z.x, -z.y);
    }
}

template <int LOGM>
cudaError_t set_smem() {
    return smem_bytes(LOGM) > 48 * 1024
               ? cudaFuncSetAttribute(
                     hilbert_kernel<LOGM>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                     static_cast<int>(smem_bytes(LOGM)))
               : cudaSuccess;
}

template <int LOGM>
cudaError_t launch(const float2* in, float2* out, const float2* tw, int n1,
                   cudaStream_t stream) {
    constexpr int F = rows_per_block(LOGM);
    cudaError_t e = set_smem<LOGM>();
    if (e != cudaSuccess) return e;
    const double N = static_cast<double>(n1) * (1 << LOGM);
    hilbert_kernel<LOGM><<<static_cast<unsigned>((n1 + F - 1LL) / F),
                           block_threads(LOGM), smem_bytes(LOGM), stream>>>(
        in, out, tw, n1, 2.0 / N);
    return cudaGetLastError();
}

template <int LOGM>
int blocks_per_sm() {
    cudaError_t e = set_smem<LOGM>();
    int blocks = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, hilbert_kernel<LOGM>, block_threads(LOGM),
            smem_bytes(LOGM));
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

int log2_of(int M) {
    int logM = 0;
    while ((1 << logM) < M && logM <= kMaxLogM) ++logM;
    return (1 << logM) == M && logM >= kMinLogM ? logM : -1;
}

}  // namespace

// in, out: (n1, M) complex64 rows, contiguous, distinct.  tw: (M/2,)
// complex64, tw[m] = exp(-2 pi i m / M).  M a power of two in 16..16384,
// n1 >= 1.  Returns cudaGetLastError() after the launch (or the first
// error).
extern "C" int pyfft_hilbert(const void* in, void* out, const void* tw,
                             int n1, int M, void* stream_ptr) {
    const float2* inf = static_cast<const float2*>(in);
    float2* outf = static_cast<float2*>(out);
    const float2* twf = static_cast<const float2*>(tw);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (n1 < 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (log2_of(M)) {
#define PYFFT_HILBERT_CASE(L) \
    case L: return static_cast<int>(launch<L>(inf, outf, twf, n1, stream));
        PYFFT_HILBERT_CASE(4) PYFFT_HILBERT_CASE(5) PYFFT_HILBERT_CASE(6)
        PYFFT_HILBERT_CASE(7) PYFFT_HILBERT_CASE(8) PYFFT_HILBERT_CASE(9)
        PYFFT_HILBERT_CASE(10) PYFFT_HILBERT_CASE(11)
        PYFFT_HILBERT_CASE(12) PYFFT_HILBERT_CASE(13)
        PYFFT_HILBERT_CASE(14)
#undef PYFFT_HILBERT_CASE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Resident blocks of kernel D per SM for rows of M points (its occupancy),
// or minus the CUDA error code.
extern "C" int pyfft_hilbert_blocks_per_sm(int M) {
    switch (log2_of(M)) {
#define PYFFT_HILBERT_OCC(L) \
    case L: return blocks_per_sm<L>();
        PYFFT_HILBERT_OCC(4) PYFFT_HILBERT_OCC(5) PYFFT_HILBERT_OCC(6)
        PYFFT_HILBERT_OCC(7) PYFFT_HILBERT_OCC(8) PYFFT_HILBERT_OCC(9)
        PYFFT_HILBERT_OCC(10) PYFFT_HILBERT_OCC(11)
        PYFFT_HILBERT_OCC(12) PYFFT_HILBERT_OCC(13)
        PYFFT_HILBERT_OCC(14)
#undef PYFFT_HILBERT_OCC
        default: return -static_cast<int>(cudaErrorInvalidValue);
    }
}
