// Causal FIR inner loops shared by kernels A and I (fir.cu), the filter
// stage of kernel B on real signals and of kernel H (welch_pair.cu), and
// that of kernel B on complex signals (welch.cu), so that kernel A's tests
// also cover the others' filter.
//
// fir_point makes one output with one shared-memory load of a sample and
// one of a tap per FMA; fir_pair makes one output of each of two sequences
// with one load of each tap for both; fir4 makes 4 consecutive outputs
// with the same products in the same order from 16-byte loads, one of 4
// taps and one of 4 samples (per sequence) per 16 FMAs.  All three give
// the same bits.
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

// fir_point of two sequences at once: the same products in the same order
// per output, one load of each tap for both.
__device__ __forceinline__ float2 fir_pair(const float* a, const float* b,
                                           const float* taps, int K) {
    const float* p = a + (K - 1);
    const float* q = b + (K - 1);
    float sa = 0.f, sb = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
        const float w = taps[k];
        sa = fmaf(w, p[-k], sa);
        sb = fmaf(w, q[-k], sb);
    }
    return make_float2(sa, sb);
}

// o[i] += t * w[E + i], i < 4.
template <int E>
__device__ __forceinline__ void fma4(float (&o)[4], float t,
                                     const float (&w)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = fmaf(t, w[E + i], o[i]);
}

__device__ __forceinline__ void window8(float (&w)[8], float4 lo, float4 hi) {
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// Outputs j0 .. j0 + 3 (j0 a multiple of 4) of fir_point for sequence a
// (and b, with TWO), from raw samples at 16-byte-aligned a and b and the
// taps reversed in rt (rt[d] = taps[K - 1 - d], 16-byte aligned).  Output
// j sums rt[d] * s[j + d] for d from K - 1 down to 0, fir_point's products
// in fir_point's order.  Per 4 taps: one 16-byte load of taps (a
// broadcast) and one of samples per sequence, for 16 FMAs per sequence;
// the other 16 bytes of a thread's window of 8 samples carry over.
template <bool TWO>
__device__ __forceinline__ void fir4(const float* a, const float* b,
                                     const float* rt, int K, int j0,
                                     float (&oa)[4], float (&ob)[4]) {
    const float4* pa = reinterpret_cast<const float4*>(a + j0);
    const float4* pb = reinterpret_cast<const float4*>(b + j0);
    const float4* pt = reinterpret_cast<const float4*>(rt);
#pragma unroll
    for (int i = 0; i < 4; ++i) oa[i] = ob[i] = 0.f;
    int g = (K - 1) >> 2;   // the group of d = 4g .. 4g + 3
    float4 ha = pa[g + 1], hb = TWO ? pb[g + 1] : ha;
    float wa[8], wb[8];
    {
        // the top group holds d <= K - 1 only
        const float4 la = pa[g], lb = TWO ? pb[g] : la, t = pt[g];
        const int emax = K - 1 - 4 * g;
        window8(wa, la, ha);
        window8(wb, lb, hb);
        if (emax >= 3) {
            fma4<3>(oa, t.w, wa);
            if (TWO) fma4<3>(ob, t.w, wb);
        }
        if (emax >= 2) {
            fma4<2>(oa, t.z, wa);
            if (TWO) fma4<2>(ob, t.z, wb);
        }
        if (emax >= 1) {
            fma4<1>(oa, t.y, wa);
            if (TWO) fma4<1>(ob, t.y, wb);
        }
        fma4<0>(oa, t.x, wa);
        if (TWO) fma4<0>(ob, t.x, wb);
        ha = la;
        hb = lb;
    }
    for (--g; g >= 0; --g) {
        const float4 la = pa[g], lb = TWO ? pb[g] : la, t = pt[g];
        window8(wa, la, ha);
        window8(wb, lb, hb);
        fma4<3>(oa, t.w, wa);
        if (TWO) fma4<3>(ob, t.w, wb);
        fma4<2>(oa, t.z, wa);
        if (TWO) fma4<2>(ob, t.z, wb);
        fma4<1>(oa, t.y, wa);
        if (TWO) fma4<1>(ob, t.y, wb);
        fma4<0>(oa, t.x, wa);
        if (TWO) fma4<0>(ob, t.x, wb);
        ha = la;
        hb = lb;
    }
}
