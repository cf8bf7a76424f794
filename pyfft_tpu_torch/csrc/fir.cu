// Kernel A: causal multichannel FIR, y[c, n] = sum_{k<K} taps[k] x[c, n-k]
// with x[c, n<0] = 0, i.e. np.convolve(x[c], taps, 'full')[:nt].
//
// Replaces pyfft_tpu/ops/pallas_fir.py::_fir_kernel (launched from
// _fir_call), which computes the same filter as banded-Toeplitz matmuls on
// 128-lane rows with ceil((K-1)/128) halo rows.  It also feeds kernel B
// (welch_pair.cu) the filtered reference: with two or more real channels
// and a filter, ops/welch.py filters x here once a call and kernel B's
// channel blocks read that row instead of each filtering x again; fir4
// makes the products kernel B's ring fill would, in its order, so the
// spectra keep their bits.
//
// What bounds it on the card: 2*K flops per output against 8 bytes of
// device traffic (one read of x, one write of y), so for K >= 16 it is
// bound by the inner loop, not by HBM.  One output a thread (fir_point)
// takes one shared-memory load of a sample and one of a tap per FMA, and
// an SM serves about one shared-memory wavefront a clock against four
// warp-wide FMAs: that loop is bound by the loads.  Design: one block
// computes a tile of kTile outputs of one channel.  It stages the tile,
// the K-1 samples before it (zeros before the signal) and the taps
// reversed in shared memory, so every input sample is read from device
// memory about (kTile+K-1)/kTile times.  Each thread makes 4 consecutive
// outputs with fir.cuh::fir4: per 4 taps a warp loads 4 taps (one
// broadcast wavefront) and 4 samples a thread (16-byte loads at a 16-byte
// stride, 4 wavefronts without a bank conflict) for 16 FMAs, in float32
// with fir_point's products in fir_point's order (the same bits as one
// output a thread), and stores them with one 16-byte store where the row
// allows.  The direct form's 2*K flops an output stay: below the FMA rate
// only an overlap-save (FFT) form goes.
//
// Kernel I (fir_t_kernel below) replaces pyfft_tpu/ops/pallas_fir.py::
// _fir_t_kernel (launched from _fir_t_pipeline), the FIR-transpose feeder:
// the same filter of x and the rows of y, written straight into the
// channel-interleaved (nrows_out, C*128) layout, with an optional per-lane
// value subtracted from signal rows and zeros in the rows past the signal.
// It is kernel A's block with another output address: a thread's 4
// outputs lie in one 128-lane run (one 16-byte store), so its results are
// kernel A's bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "fir.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kPoints = 4;    // consecutive outputs a thread (fir4)
static_assert(kTile == kPoints * kThreads, "one group of 4 a thread");
constexpr int kLanes = 128;   // the interleaved layout's lane count

// Floats of the sample stage: the tile and its halo (kTile + K - 1), then
// at least 7 zeros (fir4's 16-byte loads read past the span), rounded to
// 16 bytes.
__host__ __device__ constexpr int stage_floats(int K) {
    return (kTile + K - 1 + 7 + 3) & ~3;
}
constexpr int kStageMax = stage_floats(kFirMaxTaps);

// The block's stage: s_x[j] = sig[n0 - (K-1) + j] for j < kTile + K - 1,
// zero before the signal, at or past nt and past the span; s_rt[d] =
// taps[K - 1 - d] for d < K, zero up to the next multiple of 4.  Ends with
// a barrier.
__device__ __forceinline__ void stage_tile(float* s_x, float* s_rt,
                                           const float* __restrict__ sig,
                                           const float* __restrict__ taps,
                                           long long n0, long long nt,
                                           int K) {
    const int kr = (K + 3) & ~3;
    for (int d = threadIdx.x; d < kr; d += kThreads)
        s_rt[d] = d < K ? __ldg(taps + (K - 1 - d)) : 0.f;
    const int span = kTile + K - 1;
    const int len = stage_floats(K);
    for (int j = threadIdx.x; j < len; j += kThreads) {
        const long long t = n0 - (K - 1) + j;
        s_x[j] = (j < span && t >= 0 && t < nt) ? __ldg(sig + t) : 0.f;
    }
    __syncthreads();
}

// vec: y is 16-byte aligned and nt % 4 == 0, so a group of 4 inside the
// row takes one 16-byte store.
__global__ void __launch_bounds__(kThreads)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long nt, int K, bool vec) {
    __shared__ __align__(16) float s_rt[kFirMaxTaps];
    __shared__ __align__(16) float s_x[kStageMax];
    const long long row = blockIdx.y;
    const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
    stage_tile(s_x, s_rt, x + row * nt, taps, n0, nt, K);
    const int j0 = kPoints * threadIdx.x;
    const long long t0 = n0 + j0;
    if (t0 >= nt) return;
    float o[kPoints], unused[kPoints];
    fir4<false>(s_x, s_x, s_rt, K, j0, o, unused);
    float* yr = y + row * nt + t0;
    if (vec && t0 + kPoints <= nt) {
        *reinterpret_cast<float4*>(yr) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
        for (int i = 0; i < kPoints; ++i)
            if (t0 + i < nt) yr[i] = o[i];
    }
}

// Kernel I: the same filter of C = nch + 1 signals (x, then the rows of y),
// written into the interleaved layout out[r, c*128 + l] = fir(sig_c)[128r
// + l] - sub[c*128 + l] (sub optional), rows r < nrows_out; samples at or
// past nt are exact zeros, so rows past the signal are zero.  grid.y = C.
// nt % 128 == 0, so a group of 4 is all signal or all past it; out is
// 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
fir_t_kernel(const float* __restrict__ x, const float* __restrict__ y,
             long long y_row_stride, const float* __restrict__ taps, int K,
             const float* __restrict__ sub, float* __restrict__ out,
             long long nt, long long nout) {
    __shared__ __align__(16) float s_rt[kFirMaxTaps];
    __shared__ __align__(16) float s_x[kStageMax];
    const int c = blockIdx.y;
    const int C = gridDim.y;
    const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
    const bool signal = n0 < nt;          // uniform over the block
    if (signal) {
        const float* xr = c ? y + (c - 1) * y_row_stride : x;
        stage_tile(s_x, s_rt, xr, taps, n0, nt, K);
    }
    const int j0 = kPoints * threadIdx.x;
    const long long t0 = n0 + j0;
    if (t0 >= nout) return;
    const int lane = static_cast<int>(t0 & (kLanes - 1));
    float o[kPoints] = {0.f, 0.f, 0.f, 0.f};
    if (t0 < nt) {
        float unused[kPoints];
        fir4<false>(s_x, s_x, s_rt, K, j0, o, unused);
        if (sub) {
#pragma unroll
            for (int i = 0; i < kPoints; ++i)
                o[i] -= __ldg(sub + c * kLanes + lane + i);
        }
    }
    *reinterpret_cast<float4*>(
        out + (t0 / kLanes) * (static_cast<long long>(C) * kLanes) +
        c * kLanes + lane) = make_float4(o[0], o[1], o[2], o[3]);
}

}  // namespace

extern "C" const char* pyfft_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (nch, nt) float32, contiguous.  taps: (K,) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int pyfft_fir(const float* x, const float* taps, float* y,
                         long long nch, long long nt, int K, void* stream) {
    if (K < 1 || K > kFirMaxTaps || nt <= 0 || nch <= 0 || nch > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((nt + kTile - 1) / kTile),
                    static_cast<unsigned>(nch));
    const bool vec =
        nt % kPoints == 0 && reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
    fir_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, taps, y, nt, K, vec);
    return static_cast<int>(cudaGetLastError());
}

// x: (nt,) float32; y: nch rows of nt float32 with row stride y_row_stride
// (unused when nch = 0).  taps: (K,) float32.  sub: (C*128,) float32 or
// null, C = nch + 1.  out: (nrows_out, C*128) float32, 16-byte aligned.
// nt % 128 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int pyfft_fir_t(const float* x, const float* y,
                           long long y_row_stride, int nch, const float* taps,
                           int K, const float* sub, float* out, long long nt,
                           long long nrows_out, void* stream) {
    if (K < 1 || K > kFirMaxTaps || nt <= 0 || nt % kLanes || nch < 0 ||
        nch + 1 > 65535 || nrows_out < 1 ||
        reinterpret_cast<std::uintptr_t>(out) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long nout = nrows_out * kLanes;
    const dim3 grid(static_cast<unsigned>((nout + kTile - 1) / kTile),
                    static_cast<unsigned>(nch + 1));
    fir_t_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, y_row_stride, taps, K, sub, out, nt, nout);
    return static_cast<int>(cudaGetLastError());
}
