// Helpers shared by the flash-attention forward (flash_fwd.cu) and backward
// (flash_bwd.cu) kernels: element conversion, 8-wide vector loads/stores,
// the masking constant and the tile geometry both directions use.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// x rounded to T's precision, back in fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

// 8 consecutive elements (16-byte aligned for bf16, 32 for fp32) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float2 x = __bfloat1622float2(h2[i]);
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
    }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(float* dst, const float* f) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Rows [nrows] x D of a [*, H, D] tensor (row stride H*D), starting at
// `src` (row 0, head h already applied), staged into shared memory as fp32
// with row stride `ld`; rows at or beyond `valid` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, size_t row_stride,
                                           int nrows, int valid, int tid, int nthreads) {
    constexpr int D8 = D / 8;
    for (int i = tid; i < nrows * D8; i += nthreads) {
        const int r = i / D8, d = (i % D8) * 8;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (r < valid) load8(src + (size_t)r * row_stride + d, f);
        store8(dst + r * ld + d, f);
    }
}

}  // namespace
