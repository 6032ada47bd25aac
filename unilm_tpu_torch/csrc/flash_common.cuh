// Helpers shared by the flash-attention forward (flash_fwd.cu, flash_tri.cu)
// and backward (flash_bwd.cu, flash_bwd_fused.cu) kernels: element
// conversion, 8-wide vector loads/stores, the masking constant, the tile
// geometry both directions use, and the turn-taking by which the fused
// backward's blocks add into one fp32 dq row tile in a fixed order.

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

// Does the (query rows t0 .. t0+rows-1, keys c0 .. c0+cols-1) tile hold a
// visible pair under causal with q_offset, window and the kv prefix
// `limit`? Conservative: never false for a visible pair.
__device__ __forceinline__ bool tile_visible(int t0, int rows, int c0, int cols, int q_offset,
                                             int limit, int causal, int window) {
    const int r0 = q_offset + t0;
    if (c0 >= limit) return false;
    if (causal && c0 > r0 + rows - 1) return false;
    if (window > 0 && c0 + cols - 1 < r0 - window + 1) return false;
    return true;
}

// One past the last key tile (of `cols` keys) that is tile_visible for the
// query rows t0 .. t0+rows-1 (q_offset >= 0). The visible key tiles of a
// row tile are contiguous, so those after key tile j are j+1 .. end-1.
__device__ __forceinline__ int key_tiles_end(int t0, int rows, int cols, int q_offset,
                                             int limit, int causal) {
    int end = (limit + cols - 1) / cols;
    if (causal) end = min(end, (q_offset + t0 + rows - 1) / cols + 1);
    return end;
}

// Turn-taking over one counter per dq row tile (kernel #8): the blocks that
// add into the tile do so in a fixed order, so the fp32 sum, and the bits,
// are the same in every run. A block waits until `target` blocks have
// passed (thread 0 polls with acquire loads; the barrier hands the turn to
// the block), adds with L2 loads and stores (__ldcg / __stcg: no stale L1
// line), then passes: every thread fences its stores, and after the
// barrier thread 0 adds one with release semantics. A wait that outlasts
// 10 s traps, so an ordering fault fails the launch instead of hanging the
// card.
__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

__device__ __forceinline__ void wait_turn(const int* counter, int target) {
    if (threadIdx.x == 0 && ld_acquire(counter) < target) {
        const unsigned long long t0 = globaltimer_ns();
        while (ld_acquire(counter) < target) {
            __nanosleep(100);
            if (globaltimer_ns() - t0 > 10000000000ull) __trap();
        }
    }
    __syncthreads();
}

__device__ __forceinline__ void pass_turn(int* counter) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(counter), "r"(1)
                     : "memory");
}

}  // namespace
