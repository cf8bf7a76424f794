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
// bf16 (round to nearest even) after each pass (y starts as bf16(x)), then
// the column sums of the groups' results, added over the groups and the
// row blocks.  In stream mode row block b is read at step b; in resident
// mode every step reads row block 0 (the TPU probe's compute-only case).
// What bounds it: the products, 2 * 128 * 128 * N flops per group and pass
// (2.3e11 at 65536 x 1152 and 12 passes), which only the tensor cores do
// near the book rate; x is read once (302 MB), far below that.  Design:
// the chain runs transposed, y^T <- bf16(y^T T^T), on wgmma m64n128k16
// (bf16 in, float32 out) with y^T as the A operand in registers and T, as
// stored (K-major, 128-byte swizzle), as the B operand in shared memory,
// loaded once a block.  The accumulator fragment of one pass, rounded in
// pairs, is the next pass's A fragment as it lies, so y never leaves the
// registers between passes: no stores, no proxy fence, no barrier a pass,
// and each warpgroup runs its own chain while the others' products keep
// the tensor cores busy.  A warpgroup takes units of 128 rows (one group)
// x 64 columns in a fixed walk; while a unit runs its passes, cp.async
// stages the warpgroup's next unit of float32 x (32 KB; columns >= N are
// zero-filled, stay zero through the products and are not written out).
// Two blocks an SM.  Each unit's column sums (a quad of lanes holds a
// column) go to its own row of `part`; sum_partials (reduce.cuh) adds the
// rows in order, so the result does not depend on which block took which
// unit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int kColTile = 128;   // kernel F: columns per block
constexpr int kRowLanes = 8;    // kernel F: warps per block

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

constexpr int kG = 128;          // kernel G: rows of a group, of T and of K
constexpr int kU = 64;           // kernel G: columns a warpgroup takes (M)
constexpr int kThreadsG = 256;   // two warpgroups, each on its own columns
// kernel G's shared memory, in bytes from a 1024-byte-aligned base: T
// (two 64-wide K halves of 128 rows x 128 B, 128-byte swizzled) and each
// warpgroup's float32 staging of its next unit of x (128 x 64)
constexpr int kHalf = 128 * 128;
constexpr int kOffStage = 2 * kHalf;
constexpr int kStage = kG * kU * 4;
constexpr int kSmemG = kOffStage + 2 * kStage + 1024;   // + alignment slack

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of T[row][k] in its K-major 128-byte-swizzled layout: two
// 64-wide K halves of 128 rows x 128 bytes, 16-byte chunks XOR row mod 8.
__device__ __forceinline__ int t_offset(int row, int k) {
    return (k >> 6) * kHalf + row * 128 +
           ((((k & 63) >> 3) ^ (row & 7)) << 4) + (k & 7) * 2;
}

// Float index of x[k][m] in a warpgroup's staging (128 rows of 64): the
// index of m's 8-column group XOR (k / 2) mod 4, so that the fragment reads
// below (rows 2q + 0/1 for the four q of a quad) hit distinct banks.
__device__ __forceinline__ int stage_index(int k, int m) {
    return k * kU + (m ^ (((k >> 1) & 3) << 3));
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
           (1ull << 62);
}

// d (64 x 128, float32, accumulator fragment) (+)= A @ B: A (64 x 16)
// bf16 from registers (a0..a3, the mma.m16n8k16 A fragment of each warp's
// 16 rows), B (16 x 128) bf16 K-major from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
    return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
    return __uint_as_float(v & 0xFFFF0000u);
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, int src_bytes) {
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The 128 threads of a warpgroup (thread wt) start copying the unit's x
// (rows row0.., columns c0.. c0 + 63) into their staging; columns >= N are
// zero-filled.  vec: 16-byte copies (N % 4 == 0 and x 16-byte aligned).
__device__ __forceinline__ void stage_unit(uint32_t stage, const float* x,
                                           long long row0, int c0, int N,
                                           bool vec, int wt) {
    if (vec) {
        for (int q = wt; q < kG * kU / 4; q += 128) {
            const int k = q >> 4, m = (q & 15) * 4, col = c0 + m;
            const bool in = col < N;
            cp_async(stage + stage_index(k, m) * 4,
                     in ? x + (row0 + k) * N + col : x, 16, in ? 16 : 0);
        }
    } else {
        for (int q = wt; q < kG * kU; q += 128) {
            const int k = q >> 6, m = q & 63, col = c0 + m;
            const bool in = col < N;
            cp_async(stage + stage_index(k, m) * 4,
                     in ? x + (row0 + k) * N + col : x, 4, in ? 4 : 0);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wg_barrier(int wg) {
    asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// Kernel G.  A unit is 128 rows (one group) x 64 columns; the chain runs
// transposed, y^T <- bf16(y^T T^T): y^T (64 x 128) is the A operand, held
// in registers, T^T the B operand, T as stored (K-major).  The float32
// accumulator fragment of one pass, rounded in pairs, is the next pass's A
// fragment as it lies, so y never leaves the registers between passes.
__global__ void __launch_bounds__(kThreadsG, 2)
chain_kernel(const float* __restrict__ x,
             const __nv_bfloat16* __restrict__ T, float* __restrict__ part,
             int N, int rows_blk, int passes, int resident, int nunits,
             int vec) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
    const uint32_t base = smem_addr(smem);
    const int tid = threadIdx.x;
    const int wg = tid >> 7, wt = tid & 127, lane = tid & 31;
    const int ncol = (N + kU - 1) / kU;
    const int groups = rows_blk / kG;
    const uint32_t stage = base + kOffStage + wg * kStage;
    const float* stg =
        reinterpret_cast<const float*>(smem + kOffStage + wg * kStage);
    auto unit_row0 = [&](int unit) {
        const int p = unit / ncol;   // its row of part: block, group
        return static_cast<long long>(resident ? 0 : p / groups) * rows_blk +
               static_cast<long long>(p % groups) * kG;
    };
    const int stride = 2 * gridDim.x;
    int u = 2 * blockIdx.x + wg;
    if (u < nunits)
        stage_unit(stage, x, unit_row0(u), (u % ncol) * kU, N, vec, wt);
    // T, once a block: 16-byte chunks into the K-major swizzled layout
    for (int q = tid; q < kG * kG / 8; q += kThreadsG) {
        const int r = q >> 4, k = (q & 15) * 8;
        *reinterpret_cast<uint4*>(smem + t_offset(r, k)) =
            __ldg(reinterpret_cast<const uint4*>(T) + q);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // this thread's fragment: columns m0, m0 + 8 of the unit; A register
    // 4kb + r holds rows k, k + 1 with k = 16kb + 2q + 8(r / 2), column
    // m0 + 8(r % 2); accumulator entries 2i, 2i + 1 are A register i of
    // the next pass
    const int q4 = lane & 3;
    const int m0 = ((wt >> 5) << 4) + (lane >> 2);
    float d[64];
    uint32_t a[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;

    for (; u < nunits; u += stride) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        wg_barrier(wg);   // the unit's x has landed in the staging
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int k = 16 * (i >> 2) + 2 * q4 + 8 * ((i & 3) >> 1);
            const int m = m0 + 8 * (i & 1);
            a[i] = pack_bf16(stg[stage_index(k, m)],
                             stg[stage_index(k + 1, m)]);
        }
        wg_barrier(wg);   // every thread has read the staging
        const int un = u + stride;
        if (un < nunits)
            stage_unit(stage, x, unit_row0(un), (un % ncol) * kU, N, vec, wt);

        for (int p = 0; p < passes; ++p) {
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < kG / 16; ++kk)
                wgmma_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3],
                         gmma_desc(base + (kk >> 2) * kHalf + (kk & 3) * 32,
                                   16, 1024),
                         kk);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            // keep a live and d unread until the products are done
#pragma unroll
            for (int i = 0; i < 32; ++i)
                asm volatile("" : "+r"(a[i]) :: "memory");
#pragma unroll
            for (int i = 0; i < 64; ++i)
                asm volatile("" : "+f"(d[i]) :: "memory");
#pragma unroll
            for (int i = 0; i < 32; ++i)
                a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
        }

        // column sums of the final bf16 y: each thread its 32 rows of
        // columns m0 and m0 + 8 in register order, then the quad's four
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            float& s = (i & 1) ? s1 : s0;
            s += bf16_lo(a[i]);
            s += bf16_hi(a[i]);
        }
        s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        const int col = (u % ncol) * kU + m0;
        float* out = part + static_cast<long long>(u / ncol) * N;
        if (q4 == 0 && col < N) out[col] = s0;
        if (q4 == 0 && col + 8 < N) out[col + 8] = s1;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// contiguous, 16-byte aligned; rows_blk a multiple of 128 dividing nrows.
// part: (nrows / 128, N) float32 scratch.  out: (N,) float32.  resident
// != 0 reads row block 0 at every step.  Returns cudaGetLastError() after
// the last launch.
extern "C" int pyfft_chain(const float* x, const void* T, float* part,
                           float* out, int nrows, int N, int rows_blk,
                           int passes, int resident, void* stream_ptr) {
    if (bad_shape(nrows, N, rows_blk) || rows_blk % kG || passes < 0 ||
        reinterpret_cast<uintptr_t>(T) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    // per device, on its first launch: the shared-memory opt-in and how
    // many blocks its SMs hold
    static int blocks_on[64];
    if (!blocks_on[dev]) {
        cudaError_t e = cudaFuncSetAttribute(
            chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kSmemG);
        int sms = 0, per_sm = 0;
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, chain_kernel, kThreadsG, kSmemG);
        if (e != cudaSuccess) return static_cast<int>(e);
        blocks_on[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int nparts = nrows / kG;
    const long long nunits =
        static_cast<long long>(nparts) * ((N + kU - 1) / kU);
    if (nunits > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (nunits + 1) / 2;   // two warpgroups a block
    const int grid = static_cast<int>(
        blocks < blocks_on[dev] ? blocks : blocks_on[dev]);
    const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    chain_kernel<<<grid, kThreadsG, kSmemG, stream>>>(
        x, static_cast<const __nv_bfloat16*>(T), part, N, rows_blk, passes,
        resident, static_cast<int>(nunits), vec);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    return launch_sum_partials(part, out, nparts, N, 1.0, stream);
}
