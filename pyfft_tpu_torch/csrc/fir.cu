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
#include <cuda_runtime.h>

#include "fir.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;

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
