// One-token decode attention, shared by csrc/decode_attention.cu (contiguous
// page runs, bf16/fp32 or int8 pools) and csrc/paged_append_attention.cu
// (block tables). Hopper (sm_90a).
//
// One block per (sequence b, head h), 32 warps. Warps walk 32-token tiles
// of the sequence in parallel with an fp32 online softmax; each lane loads
// a whole K row of its token with vector loads and computes that token's
// score alone; V rows are read lane-contiguous, UB tokens' rows in flight at
// once; the warps' (max, sum, acc) states are merged through shared memory.
//
// Modes (the TPU kernel each one stands for is named in the .cu files):
//   RUN    tokens 0..L of a contiguous run from page bases[b]; the caller has
//          written row L; its probability enters the PV sum unrounded, the
//          pool tokens' are rounded to the storage type.
//   RUN_I8 int8 pool with per-token scales in the slab sidecar
//          [P/chunk, 8, chunk*page] f32 (row 0 K scales, row 1 V scales):
//          score = (q . float(k_i8)) * kscale[t]; the probability is
//          multiplied by vscale[t] and rounded to q's type before the PV
//          product with float(v_i8). Only tokens t < L are read (the caller
//          has written the quantized row L); the new token is merged
//          analytically from the UNQUANTIZED k_new / v_new.
//   TABLE  token t lives at page tables[b, t / page], offset t % page. The
//          block first writes the D columns of head h of the new row into
//          page tables[b, L / page] at L % page (it is the only block that
//          writes or reads those columns), then attends over 0..L; every
//          probability, the new token's too, is rounded to the pool type.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 32;
constexpr int UB = 8;  // tokens whose V rows are loaded together
constexpr unsigned FULL = 0xffffffffu;

enum Mode { RUN = 0, RUN_I8 = 1, TABLE = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// round an fp32 value to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

// 8 consecutive elements -> fp32 (16-byte loads for bf16, 8-byte for int8)
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
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)c[i];
}

struct DecodeArgs {
    const void* q;        // [B, H, D] pre-scaled, type T
    void* kp;             // [P, page, H*D] pool, type PT (written in TABLE mode)
    void* vp;
    const int* idx;       // RUN*: bases [B]; TABLE: tables [B, max_pages]
    const int* lengths;   // [B] tokens already in the cache
    const float* scales;  // RUN_I8: sidecar [P/chunk, 8, chunk*page]
    const void* knew;     // RUN_I8, TABLE: [B, H, D], type T
    const void* vnew;
    void* out;            // [B, H, D], type T
    int H, page, chunk, max_pages;
    long long pool_rows;  // P * page
};

template <typename T, typename PT, int D, int MODE>
__global__ void __launch_bounds__(NWARPS * 32) decode_kernel(DecodeArgs a) {
    constexpr int DPL = D / 32;
    __shared__ __align__(16) float qs[D];
    __shared__ float wm[NWARPS], wl[NWARPS];
    __shared__ float wacc[NWARPS][D];
    __shared__ float s_new_sh;

    const T* q = static_cast<const T*>(a.q);
    PT* kp = static_cast<PT*>(a.kp);
    PT* vp = static_cast<PT*>(a.vp);
    const int b = blockIdx.x, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t HD = (size_t)a.H * D;
    const size_t qoff = ((size_t)b * a.H + h) * D;
    const int L = a.lengths[b];
    const int page = a.page;
    const int* table = a.idx + (size_t)b * a.max_pages;
    const long long max_tokens = (long long)a.max_pages * page;

    long long row0 = 0, n;
    if constexpr (MODE == TABLE) {
        n = min((long long)L + 1, max_tokens);
        const int pg = L / page;
        if (pg < a.max_pages) {
            const long long r = (long long)table[pg] * page + L % page;
            if (r >= 0 && r < a.pool_rows) {
                const T* kn = static_cast<const T*>(a.knew) + qoff;
                const T* vn = static_cast<const T*>(a.vnew) + qoff;
                for (int d = tid; d < D; d += NWARPS * 32) {
                    kp[r * HD + (size_t)h * D + d] = from_f<PT>(to_f(kn[d]));
                    vp[r * HD + (size_t)h * D + d] = from_f<PT>(to_f(vn[d]));
                }
            }
        }
        // the block's own writes are visible to its threads after the barrier
    } else {
        row0 = (long long)a.idx[b] * page;
        n = min((long long)L + (MODE == RUN ? 1 : 0), max_tokens);
        n = min(n, a.pool_rows - row0);
    }

    for (int d = tid; d < D; d += NWARPS * 32) qs[d] = to_f(q[qoff + d]);
    __syncthreads();

    auto row_of = [&](long long t) -> long long {
        if constexpr (MODE == TABLE)
            return (long long)table[t / page] * page + t % page;
        else
            return row0 + t;
    };
    const int S = a.chunk * page;  // RUN_I8 slab length in tokens

    float m = NEG_INF, lpart = 0.f, acc[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

    for (long long t0 = (long long)warp * 32; t0 < n; t0 += NWARPS * 32) {
        const long long t = t0 + lane;
        const bool valid = t < n;
        const long long row = valid ? row_of(t) : 0;
        float s = NEG_INF, vsc = 1.f;
        if (valid) {
            const PT* kr = kp + (size_t)row * HD + (size_t)h * D;
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D; d += 8) {
                float f[8];
                load8(kr + d, f);
                const float4 qa = *reinterpret_cast<const float4*>(qs + d);
                const float4 qb = *reinterpret_cast<const float4*>(qs + d + 4);
                dot += qa.x * f[0] + qa.y * f[1] + qa.z * f[2] + qa.w * f[3] +
                       qb.x * f[4] + qb.y * f[5] + qb.z * f[6] + qb.w * f[7];
            }
            s = dot;
            if constexpr (MODE == RUN_I8) {
                const long long pid = row / page;
                const size_t si = (size_t)(pid / a.chunk) * 8 * S +
                                  (size_t)(pid % a.chunk) * page + row % page;
                s *= a.scales[si];
                vsc = a.scales[si + S];
            }
        }
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_new = fmaxf(m, mx);
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m - m_new);
        lpart = lpart * alpha + p;
        m = m_new;
        float pr;
        if constexpr (MODE == RUN)
            pr = (t == L) ? p : round_to<PT>(p);
        else if constexpr (MODE == RUN_I8)
            pr = round_to<T>(p * vsc);
        else
            pr = round_to<PT>(p);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[c] *= alpha;
        // PV over the tile, UB tokens at a time: their V loads are all
        // issued before the FMAs
        const int cnt = (int)min((long long)32, n - t0);
        for (int u0 = 0; u0 < cnt; u0 += UB) {
            float pu[UB], vv[UB][DPL];
#pragma unroll
            for (int u = 0; u < UB; ++u) {
                pu[u] = __shfl_sync(FULL, pr, u0 + u);  // 0 past the end
                const long long ru = __shfl_sync(FULL, row, u0 + u);
                const PT* vr = vp + (size_t)ru * HD + (size_t)h * D;
#pragma unroll
                for (int c = 0; c < DPL; ++c)
                    vv[u][c] = u0 + u < cnt ? to_f(vr[lane + 32 * c]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < UB; ++u)
#pragma unroll
                for (int c = 0; c < DPL; ++c) acc[c] += pu[u] * vv[u][c];
        }
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lpart += __shfl_xor_sync(FULL, lpart, o);
    if (lane == 0) {
        wm[warp] = m;
        wl[warp] = lpart;
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) wacc[warp][lane + 32 * c] = acc[c];
    if constexpr (MODE == RUN_I8) {
        if (warp == 0) {  // s_new = q . k_new, unquantized
            const T* kn = static_cast<const T*>(a.knew) + qoff;
            float part = 0.f;
            for (int d = lane; d < D; d += 32) part += qs[d] * to_f(kn[d]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
            if (lane == 0) s_new_sh = part;
        }
    }
    __syncthreads();

    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, wm[w]);
    float s_new = 0.f;
    if constexpr (MODE == RUN_I8) {
        s_new = s_new_sh;
        M = fmaxf(M, s_new);
    }
    float l = 0.f, sc[NWARPS];
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
        sc[w] = expf(wm[w] - M);
        l += wl[w] * sc[w];
    }
    float a_new = 0.f;
    if constexpr (MODE == RUN_I8) {
        a_new = expf(s_new - M);
        l += a_new;
    }
    const float denom = l > 0.f ? l : 1.f;
    T* out = static_cast<T*>(a.out);
    for (int d = tid; d < D; d += NWARPS * 32) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) o += wacc[w][d] * sc[w];
        if constexpr (MODE == RUN_I8)
            o += a_new * to_f(static_cast<const T*>(a.vnew)[qoff + d]);
        out[qoff + d] = from_f<T>(o / denom);
    }
}

template <typename T, typename PT, int MODE>
cudaError_t launch_decode(const DecodeArgs& a, int B, int D, cudaStream_t stream) {
    dim3 grid(B, a.H);
    switch (D) {
        case 64: decode_kernel<T, PT, 64, MODE><<<grid, NWARPS * 32, 0, stream>>>(a); break;
        case 96: decode_kernel<T, PT, 96, MODE><<<grid, NWARPS * 32, 0, stream>>>(a); break;
        case 128: decode_kernel<T, PT, 128, MODE><<<grid, NWARPS * 32, 0, stream>>>(a); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace
