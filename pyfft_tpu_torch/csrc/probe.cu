// Kernels F and G: the two probes of measure_pipeline_overlap
// (pyfft_tpu_torch/utils/profiling.py).
//
// Kernel F replaces pyfft_tpu/utils/profiling.py::mem_kernel: the column
// sums of x (nrows, N) float32, streamed in blocks of rows_blk rows, in
// float32 (one (1, N) result).  What bounds it: one read of x and nothing
// else, so device memory (it is the probe of the achieved read rate).
// Design: the TPU grid's step b (row block b) becomes blockIdx.y; a block
// of 32 x 8 threads takes 128 columns of its row block, each warp streaming
// every eighth row with 16-byte loads (one coalesced 512-byte row segment
// per warp), float32 sums in registers, then across the 8 warps in shared
// memory.  Each block writes its partial row; sum_partials (reduce.cuh)
// adds the row blocks in order.  N must be a multiple of 4.
//
// Kernel G replaces pyfft_tpu/utils/profiling.py::fused_kernel: for every
// 128-row group of a row block, `passes` chained products y <- bf16(T @ y)
// with T (128, 128) bf16, float32 accumulation and the result rounded to
// bf16 between passes (y starts as bf16(x)), then the column sums of the
// groups' results, added over the groups and the row blocks.  In stream
// mode row block b is read at step b; in resident mode every step reads
// row block 0 (the TPU probe's compute-only case).  What bounds it: the
// products, 2 * 128 * 128 * N flops per group and pass, done here on the
// CUDA cores: a simple shared-memory tile loop (T, 32 KB, and a 128 x 64
// bf16 tile of y, 16 KB), each of 256 threads holding an 8 x 4 block of
// outputs in float32 registers.  wgmma/mma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kColTile = 128;   // kernel F: columns per block
constexpr int kRowLanes = 8;    // kernel F: warps per block
constexpr int kG = 128;         // kernel G: rows of a group and of T
constexpr int kW = 64;          // kernel G: columns per block
constexpr int kThreadsG = 256;

__global__ void __launch_bounds__(32 * kRowLanes)
colsum_kernel(const float* __restrict__ x, float* __restrict__ part, int N,
              int rows_blk) {
    __shared__ float4 red[kRowLanes][32];
    const int b = blockIdx.y;
    const int c = blockIdx.x * kColTile + threadIdx.x * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < N) {
        const float* base =
            x + static_cast<long long>(b) * rows_blk * N + c;
#pragma unroll 8
        for (int r = threadIdx.y; r < rows_blk; r += kRowLanes) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                base + static_cast<long long>(r) * N));
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
        }
    }
    red[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && c < N) {
        float4 s = red[0][threadIdx.x];
        for (int w = 1; w < kRowLanes; ++w) {
            const float4 v = red[w][threadIdx.x];
            s.x += v.x;
            s.y += v.y;
            s.z += v.z;
            s.w += v.w;
        }
        *reinterpret_cast<float4*>(part + static_cast<long long>(b) * N + c) =
            s;
    }
}

__global__ void __launch_bounds__(kThreadsG)
chain_kernel(const float* __restrict__ x,
             const __nv_bfloat16* __restrict__ T, float* __restrict__ part,
             int N, int rows_blk, int passes, int resident) {
    __shared__ __align__(16) __nv_bfloat16 ts[kG * kG];
    __shared__ __align__(16) __nv_bfloat16 ys[kG * kW];
    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * kW;
    const int g = blockIdx.y;
    const int b = blockIdx.z;
    const long long row0 =
        static_cast<long long>(resident ? 0 : b) * rows_blk + g * kG;
    for (int i = tid; i < kG * kG; i += kThreadsG) ts[i] = T[i];
    for (int i = tid; i < kG * kW; i += kThreadsG) {
        const int r = i / kW;
        const int col = c0 + i % kW;
        ys[i] = __float2bfloat16(
            col < N ? __ldg(x + (row0 + r) * N + col) : 0.f);
    }
    __syncthreads();

    // thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3
    const int ty = tid / 16;
    const int tx = tid % 16;
    float out[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            out[i][j] = __bfloat162float(ys[(ty * 8 + i) * kW + tx * 4 + j]);
    for (int p = 0; p < passes; ++p) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
        for (int k = 0; k < kG; ++k) {
            float a[8], v[4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                a[i] = __bfloat162float(ts[(ty * 8 + i) * kG + k]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                v[j] = __bfloat162float(ys[k * kW + tx * 4 + j]);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    out[i][j] = fmaf(a[i], v[j], out[i][j]);
        }
        __syncthreads();  // every thread has read ys
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat16 r = __float2bfloat16(out[i][j]);
                ys[(ty * 8 + i) * kW + tx * 4 + j] = r;
                out[i][j] = __bfloat162float(r);
            }
        __syncthreads();
    }

    // column sums over the group's 128 rows, through ts (no longer read)
    float* red = reinterpret_cast<float*>(ts);   // (16, kW)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += out[i][j];
        red[ty * kW + tx * 4 + j] = s;
    }
    __syncthreads();
    if (tid < kW && c0 + tid < N) {
        float s = 0.f;
        for (int r = 0; r < kG / 8; ++r) s += red[r * kW + tid];
        part[(static_cast<long long>(b) * gridDim.y + g) * N + c0 + tid] = s;
    }
}

bool bad_shape(int nrows, int N, int rows_blk) {
    return nrows < 1 || N < 1 || rows_blk < 1 || nrows % rows_blk;
}

}  // namespace

// Kernel F.  x: (nrows, N) float32, contiguous, 16-byte aligned, N % 4 ==
// 0, nrows % rows_blk == 0.  part: (nrows / rows_blk, N) float32 scratch.
// out: (N,) float32.  Returns cudaGetLastError() after the last launch.
extern "C" int pyfft_colsum(const float* x, float* part, float* out,
                            int nrows, int N, int rows_blk,
                            void* stream_ptr) {
    if (bad_shape(nrows, N, rows_blk) || N % 4)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int nb = nrows / rows_blk;
    const dim3 grid(static_cast<unsigned>((N + kColTile - 1) / kColTile),
                    static_cast<unsigned>(nb));
    colsum_kernel<<<grid, dim3(32, kRowLanes), 0, stream>>>(x, part, N,
                                                             rows_blk);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    return launch_sum_partials(part, out, nb, N, 1.0, stream);
}

// Kernel G.  x: (nrows, N) float32, contiguous; T: (128, 128) bf16,
// contiguous; rows_blk a multiple of 128 dividing nrows.  part:
// (nrows / rows_blk * rows_blk / 128, N) float32 scratch.  out: (N,)
// float32.  resident != 0 reads row block 0 at every step.  Returns
// cudaGetLastError() after the last launch.
extern "C" int pyfft_chain(const float* x, const void* T, float* part,
                           float* out, int nrows, int N, int rows_blk,
                           int passes, int resident, void* stream_ptr) {
    if (bad_shape(nrows, N, rows_blk) || rows_blk % kG || passes < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int nb = nrows / rows_blk;
    const int groups = rows_blk / kG;
    const dim3 grid(static_cast<unsigned>((N + kW - 1) / kW),
                    static_cast<unsigned>(groups), static_cast<unsigned>(nb));
    chain_kernel<<<grid, kThreadsG, 0, stream>>>(
        x, static_cast<const __nv_bfloat16*>(T), part, N, rows_blk, passes,
        resident);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    return launch_sum_partials(part, out, nb * groups, N, 1.0, stream);
}
