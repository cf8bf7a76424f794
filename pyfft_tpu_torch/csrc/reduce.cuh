// The fixed-order sum of per-block partials that ends kernels B and H
// (welch.cu, welch_pair.cu), F and G (probe.cu): each block writes its
// own slice of `part`, and this pass adds the slices in slice order in
// float64, so a result does not depend on the order in which blocks ran.
#pragma once

#include <cuda_runtime.h>

namespace {

// out[i] = scale * sum_g part[g * per_part + i], summed in g order.
template <typename T>
__global__ void sum_partials(const T* __restrict__ part,
                             float* __restrict__ out, int nparts,
                             long long per_part, double scale) {
    const long long i =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= per_part) return;
    double acc = 0.0;
    for (int g = 0; g < nparts; ++g)
        acc += static_cast<double>(part[g * per_part + i]);
    out[i] = static_cast<float>(acc * scale);
}

// Launch sum_partials on `stream`; returns cudaGetLastError().
template <typename T>
int launch_sum_partials(const T* part, float* out, int nparts,
                        long long per_part, double scale,
                        cudaStream_t stream) {
    const int threads = 256;
    sum_partials<T><<<static_cast<unsigned>((per_part + threads - 1) /
                                            threads),
                      threads, 0, stream>>>(part, out, nparts, per_part,
                                            scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
