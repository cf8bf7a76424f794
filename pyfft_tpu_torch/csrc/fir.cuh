// Causal FIR inner loop shared by kernel A (fir.cu) and the filter stage of
// kernel B (welch.cu), so that kernel A's tests also cover kernel B's filter.
#pragma once

// Largest filter either kernel takes (the JAX package's PALLAS_FIR_MAX_TAPS).
constexpr int kFirMaxTaps = 1024;

// One output of y[n] = sum_{k<K} taps[k] * x[n-k].
// `s` points at x[n-(K-1)]: s[K-1] is the sample at the output's own time
// and s[0] the oldest one the filter reaches.  Both arrays live in shared
// memory; neighbouring threads pass neighbouring `s`, so the reads of `s`
// fall in distinct banks and the read of `taps[k]` is a broadcast.
// Accumulates in float32 (K <= 1024 terms).
__device__ __forceinline__ float fir_point(const float* s, const float* taps,
                                           int K) {
    const float* p = s + (K - 1);
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(taps[k], p[-k], acc);
    return acc;
}
