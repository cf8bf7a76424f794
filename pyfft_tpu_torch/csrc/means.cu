// Kernel B's means operand: the global mean of each filtered signal, for
// kernel B (welch_pair.cu, welch.cu) and kernel H, in one launch a call.
//
// Replaces no TPU kernel: the JAX package computes these means in XLA
// ahead of its kernel (pyfft_tpu/ops/pallas_welch3.py, the detrend moments
// of the filtered span).  The port's torch form of the same float64
// arithmetic (ops/welch.py::_moment_means, run once for x and once for y)
// is about 30 small device operations and 45 host dispatches a call, and
// the card waits on the host between them.  With this kernel the host
// enqueues the two float32 row sums and one launch, and the rest of the
// call's enqueue runs while the card sums.
//
// Row r (x, then the nch rows of y), part p (re and im of a complex
// signal; a real signal has one part), nt samples, K float64 taps t, and
// blk the float32 sums of the row's nb = nt / 4096 whole blocks of 4096
// samples (torch's sum, which the caller enqueues just before):
//   S    = sum_b blk[b] + sum_{i >= 4096 nb} row[i]            (float64)
//   T_0  = 0,  T_k = T_{k-1} + row[nt - k]   (0 where nt - k < 0),  k < K
//   mean = (sum_k (S - T_k) t_k) / nt,  at K = 1: S t_0 / nt
// the mean of conv(row, t, 'full')[:nt] by the moment identity
// sum(conv(row, t)[:nt]) = sum_k t_k (S - T_k).  The sums over the blocks
// and over the remainder are each kThreads strided partials, a shuffle
// tree in each warp, then the warps in order; the tail and the tap dot are
// one loop in k order, which warp 0 runs on groups of 32 taps and tail
// samples (a load a lane, then the group from shuffles, the same sums in
// every lane).  Every addition and product is rounded on its own (no FMA
// contraction), so tests/test_torch_welch_means.py's NumPy model repeats
// each float64 step.  The torch twin (ops/welch.py::_means_plain) does the
// same float64 arithmetic in a different order (torch's float64 sums, a
// BLAS dot for the taps): the two are equal after the float32 cast on the
// tested inputs, which the order alone does not guarantee for every input.
//
// What bounds it: the tail loop, one chain of dependent float64 steps a
// tap (9 us at K = 129, 38 us at K = 1024 on an H100), while the host
// enqueues the rest of the call.  A row reads nb block sums, the nt % 4096
// remainder and K - 1 tail samples (8,192 + 128 at bench config 0), one
// block a (row, part).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumBlock = 4096;      // ops/welch.py _SUM_BLOCK

// The float64 sum of v(i), i < n, over the block, in a fixed order:
// thread j adds v(j), v(j + kThreads), ... in turn; each warp's 32
// partials go down a shuffle tree (offsets 16, 8, 4, 2, 1); the warps'
// sums are added in warp order.  Every thread returns it.
template <typename F>
__device__ double block_sum(F v, long long n, double* s_warp) {
    double acc = 0.0;
    for (long long i = threadIdx.x; i < n; i += kThreads)
        acc = __dadd_rn(acc, v(i));
#pragma unroll
    for (int off = 16; off; off >>= 1)
        acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
    __syncthreads();
    double total = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total = __dadd_rn(total, s_warp[w]);
    __syncthreads();                  // s_warp is written again next call
    return total;
}

// grid (parts, nch + 1): block (p, r) writes means[r * parts + p].
__global__ void __launch_bounds__(kThreads)
means_kernel(const float* __restrict__ x, const float* __restrict__ y,
             long long y_row_stride, const float* __restrict__ x_blk,
             const float* __restrict__ y_blk, long long nt,
             const double* __restrict__ taps, int K,
             float* __restrict__ means) {
    __shared__ double s_warp[kWarps];
    const int parts = gridDim.x;
    const int p = blockIdx.x;
    const int r = blockIdx.y;
    const long long nb = nt / kSumBlock;
    const long long m = nb * kSumBlock;
    const float* row = (r ? y + (r - 1) * y_row_stride : x) + p;
    const float* blk = (r ? y_blk + (r - 1) * nb * parts : x_blk) + p;
    const double sb = block_sum(
        [&](long long b) { return static_cast<double>(blk[b * parts]); },
        nb, s_warp);
    const double sr = block_sum(
        [&](long long i) {
            return static_cast<double>(row[(m + i) * parts]);
        },
        nt - m, s_warp);
    if (threadIdx.x >= 32) return;
    // warp 0: each lane loads one tap and one tail sample of a group of
    // 32; every lane then adds the group in k order from the shuffles
    // (T_0 and the samples before the signal add 0), and lane 0 writes
    const int lane = threadIdx.x;
    const double S = __dadd_rn(sb, sr);
    double acc;
    if (K == 1) {
        acc = __dmul_rn(S, taps[0]);
    } else {
        double T = 0.0;
        acc = 0.0;
        for (int k0 = 0; k0 < K; k0 += 32) {
            const int k = k0 + lane;
            const double t = k < K ? taps[k] : 0.0;
            const double v = k >= 1 && k <= nt && k < K
                                 ? static_cast<double>(row[(nt - k) * parts])
                                 : 0.0;
            const int n = min(32, K - k0);
            for (int j = 0; j < n; ++j) {
                const double tj = __shfl_sync(0xffffffffu, t, j);
                T = __dadd_rn(T, __shfl_sync(0xffffffffu, v, j));
                acc = __dadd_rn(acc, __dmul_rn(__dsub_rn(S, T), tj));
            }
        }
    }
    if (lane == 0)
        means[r * parts + p] =
            static_cast<float>(__ddiv_rn(acc, static_cast<double>(nt)));
}

}  // namespace

// x: (nt,) float32, or complex64 as (re, im) pairs (parts 2); y: nch rows
// of nt such values, row stride y_row_stride floats (unused when nch = 0).
// x_blk: (nt / 4096,) and y_blk: (nch, nt / 4096) float32 block sums (as
// pairs for parts 2; unused when nt < 4096, y_blk also when nch = 0).
// taps: (K,) float64.  means: ((nch + 1) * parts,) float32, x first.
// Returns cudaGetLastError() after the launch.
extern "C" int pyfft_welch_means(const float* x, const float* y,
                                 long long y_row_stride, const float* x_blk,
                                 const float* y_blk, long long nt,
                                 const double* taps, int K, int nch,
                                 int parts, float* means, void* stream) {
    if (nt < 1 || K < 1 || nch < 0 || nch + 1 > 65535 ||
        parts < 1 || parts > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    means_kernel<<<dim3(static_cast<unsigned>(parts),
                        static_cast<unsigned>(nch + 1)),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, y_row_stride, x_blk, y_blk, nt, taps, K, means);
    return static_cast<int>(cudaGetLastError());
}
