// Kernel A: causal multichannel FIR, y[c, n] = sum_{k<K} taps[k] x[c, n-k]
// with x[c, n<0] = 0, i.e. np.convolve(x[c], taps, 'full')[:nt].
//
// Replaces pyfft_tpu/ops/pallas_fir.py::_fir_kernel (launched from
// _fir_call), which computes the same filter as banded-Toeplitz matmuls on
// 128-lane rows with ceil((K-1)/128) halo rows.
//
// What bounds it on the card: 2*K flops per output against 8 bytes of
// device traffic (one read of x, one write of y), so for K >= 16 it is
// bound by the instruction throughput of the inner loop (one FMA plus one
// shared-memory read per tap), not by HBM.  Design: one block computes a
// tile of kTile outputs of one channel.  It stages the tile, the K-1
// samples before it and the taps in shared memory, so every input sample
// is read from device memory about (kTile+K-1)/kTile times.  Each thread
// accumulates kTile/kThreads outputs in float32 with the shared fir_point
// loop.  Register blocking of the taps is work for a later change.
//
// Kernel I (fir_t_kernel below) replaces pyfft_tpu/ops/pallas_fir.py::
// _fir_t_kernel (launched from _fir_t_pipeline), the FIR-transpose feeder:
// the same filter of x and the rows of y, written straight into the
// channel-interleaved (nrows_out, C*128) layout, with an optional per-lane
// value subtracted from signal rows and zeros in the rows past the signal.
// It is kernel A's block with another output address: bound the same way,
// and its writes are 128-float runs, one per row and channel.
#include <cuda_runtime.h>

#include "fir.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kLanes = 128;   // the interleaved layout's lane count

__global__ void __launch_bounds__(kThreads)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long nt, int K) {
    __shared__ float s_taps[kFirMaxTaps];
    __shared__ float s_x[kTile + kFirMaxTaps - 1];
    const long long row = blockIdx.y;
    const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
    const float* xr = x + row * nt;
    for (int k = threadIdx.x; k < K; k += kThreads) s_taps[k] = taps[k];
    const int span = kTile + K - 1;
    for (int j = threadIdx.x; j < span; j += kThreads) {
        const long long t = n0 - (K - 1) + j;
        s_x[j] = (t >= 0 && t < nt) ? __ldg(xr + t) : 0.f;
    }
    __syncthreads();
    float* yr = y + row * nt;
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
        const long long t = n0 + j;
        if (t < nt) yr[t] = fir_point(s_x + j, s_taps, K);
    }
}

// Kernel I: the same filter of C = nch + 1 signals (x, then the rows of y),
// written into the interleaved layout out[r, c*128 + l] = fir(sig_c)[128r
// + l] - sub[c*128 + l] (sub optional), rows r < nrows_out; samples at or
// past nt are exact zeros, so rows past the signal are zero.  grid.y = C.
__global__ void __launch_bounds__(kThreads)
fir_t_kernel(const float* __restrict__ x, const float* __restrict__ y,
             long long y_row_stride, const float* __restrict__ taps, int K,
             const float* __restrict__ sub, float* __restrict__ out,
             long long nt, long long nout) {
    __shared__ float s_taps[kFirMaxTaps];
    __shared__ float s_x[kTile + kFirMaxTaps - 1];
    const int c = blockIdx.y;
    const int C = gridDim.y;
    const long long n0 = static_cast<long long>(blockIdx.x) * kTile;
    const bool signal = n0 < nt;          // uniform over the block
    if (signal) {
        const float* xr = c ? y + (c - 1) * y_row_stride : x;
        for (int k = threadIdx.x; k < K; k += kThreads) s_taps[k] = taps[k];
        const int span = kTile + K - 1;
        for (int j = threadIdx.x; j < span; j += kThreads) {
            const long long t = n0 - (K - 1) + j;
            s_x[j] = (t >= 0 && t < nt) ? __ldg(xr + t) : 0.f;
        }
        __syncthreads();
    }
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
        const long long t = n0 + j;
        if (t >= nout) break;
        const int lane = static_cast<int>(t & (kLanes - 1));
        float v = 0.f;
        if (t < nt) {
            v = fir_point(s_x + j, s_taps, K);
            if (sub) v -= __ldg(sub + c * kLanes + lane);
        }
        out[(t / kLanes) * (static_cast<long long>(C) * kLanes) +
            c * kLanes + lane] = v;
    }
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
    fir_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, taps, y, nt, K);
    return static_cast<int>(cudaGetLastError());
}

// x: (nt,) float32; y: nch rows of nt float32 with row stride y_row_stride
// (unused when nch = 0).  taps: (K,) float32.  sub: (C*128,) float32 or
// null, C = nch + 1.  out: (nrows_out, C*128) float32.  nt % 128 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int pyfft_fir_t(const float* x, const float* y,
                           long long y_row_stride, int nch, const float* taps,
                           int K, const float* sub, float* out, long long nt,
                           long long nrows_out, void* stream) {
    if (K < 1 || K > kFirMaxTaps || nt <= 0 || nt % kLanes || nch < 0 ||
        nch + 1 > 65535 || nrows_out < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long nout = nrows_out * kLanes;
    const dim3 grid(static_cast<unsigned>((nout + kTile - 1) / kTile),
                    static_cast<unsigned>(nch + 1));
    fir_t_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, y_row_stride, taps, K, sub, out, nt, nout);
    return static_cast<int>(cudaGetLastError());
}
