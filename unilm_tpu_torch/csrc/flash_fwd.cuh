// The flash forward's CUDA-core body for one 64-row query tile, in fp32:
// kernel #1's fp32 path (csrc/flash_fwd.cu) runs it once per block, kernel
// #2's fp32 path (csrc/flash_tri.cu) twice per block, on a folded pair of
// query tiles. #1's bf16 path is the wgmma/TMA kernel in flash_fwd.cu.
//
// Contract: q pre-scaled, fp32 scores and online softmax, causal with a
// query offset, sliding window, valid-kv prefix (`limit`), per-key padding
// mask, additive bias broadcast over [B|1, H|1, T, S]; key tiles that lie
// wholly above the causal diagonal, below the window or beyond `limit` are
// skipped; fully masked rows give out = 0 and lse = 0 (NEG_INF = -1e30 plus
// the keep-guard, as the TPU kernel does). The probabilities are rounded to
// the storage type of V before the PV product, as the TPU kernel's
// `p.astype(v.dtype)` does.
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D]
// (row stride H*D), bias [Bb, Hb, T, S] with element strides `bias_sb`,
// `bias_sh` (0 = broadcast), mask [B, S] int32, lse [B, H, T] float32.
//
// Both products run on the fp32 CUDA cores: each warp owns 16 query rows and
// each lane two keys of the 64-key tile, so one K value loaded from shared
// memory feeds 16 FMAs and the q rows are read as float4 broadcasts; the K
// tile rows are padded by 4 floats so the per-lane float4 reads are bank
// conflict free; P goes through shared memory so the PV product reads it as
// float4 broadcasts instead of one shuffle per (row, key); the per-lane
// partial row sums are reduced once at the end, not per tile. 4 warps.

#pragma once

#include "flash_common.cuh"

namespace {
namespace fwd {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // keys per tile
constexpr int NWARPS = 4;            // warps per block
constexpr int RPW = BQ / NWARPS;     // query rows per warp

template <int D> constexpr size_t smem_bytes() {
    return (size_t)(BQ * D + BK * (D + 4) + BK * D + NWARPS * RPW * BK) * sizeof(float);
}

// out and lse of the query rows row0 .. row0 + BQ - 1 of (batch b, head h).
// Uses smem_bytes<D>() of dynamic shared memory; a caller running it twice
// in one block puts a __syncthreads() between the calls.
template <typename T, int D>
__device__ __forceinline__ void tile(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const T* __restrict__ bias,
                                     const int* __restrict__ mask, T* __restrict__ out,
                                     float* __restrict__ lse, int b, int h, int row0, int T_,
                                     int S, int H, int bias_sb, int bias_sh, int q_offset,
                                     int limit, int causal, int window) {
    constexpr int DPL = D / 32;      // output dims per lane
    constexpr int KST = D + 4;       // padded K row stride (float4 aligned)
    constexpr int D8 = D / 8;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D]
    float* Ks = Qs + BQ * D;                       // [BK][KST]
    float* Vs = Ks + BK * KST;                     // [BK][D]
    float* Ps = Vs + BK * D;                       // [NWARPS][RPW][BK]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t HD = (size_t)H * D;

    for (int i = tid; i < BQ * D8; i += NWARPS * 32) {
        const int r = i / D8, d = (i % D8) * 8;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row0 + r < T_)
            load8(q + ((size_t)b * T_ + row0 + r) * HD + (size_t)h * D + d, f);
        store8(Qs + r * D + d, f);
    }

    // key tiles that can hold a visible (row, col) pair for this block
    const int r_first = q_offset + row0;
    const int r_last = q_offset + min(row0 + BQ, T_) - 1;
    int k_end = limit;
    if (causal) k_end = min(k_end, r_last + 1);
    const int k_begin = window > 0 ? max(0, r_first - window + 1) : 0;
    const int j_begin = k_begin / BK;
    const int j_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

    float m[RPW], lpart[RPW], acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        m[r] = NEG_INF;
        lpart[r] = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
    }

    const float* qw = Qs + warp * RPW * D;
    float* pw = Ps + warp * RPW * BK;
    const T* bias_bh = bias ? bias + (size_t)b * bias_sb + (size_t)h * bias_sh : nullptr;

    for (int j = j_begin; j < j_end; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // Q stored / previous K,V tile consumed
        for (int i = tid; i < BK * D8; i += NWARPS * 32) {
            const int c = i / D8, d = (i % D8) * 8;
            float fk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            float fv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (c0 + c < S) {
                const size_t off = ((size_t)b * S + c0 + c) * HD + (size_t)h * D + d;
                load8(k + off, fk);
                load8(v + off, fv);
            }
            store8(Ks + c * KST + d, fk);
            store8(Vs + c * D + d, fv);
        }
        __syncthreads();

        // scores: this lane's keys c0+lane and c0+lane+32 against 16 rows
        float s0[RPW], s1[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = 0.f;
        const float* k0 = Ks + lane * KST;
        const float* k1 = Ks + (lane + 32) * KST;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(k0 + d);
            const float4 c = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 x = *reinterpret_cast<const float4*>(qw + r * D + d);
                s0[r] += x.x * a.x + x.y * a.y + x.z * a.z + x.w * a.w;
                s1[r] += x.x * c.x + x.y * c.y + x.z * c.z + x.w * c.w;
            }
        }

        const int col0 = c0 + lane, col1 = c0 + lane + 32;
        const bool in0 = col0 < limit && (!mask || mask[(size_t)b * S + col0] != 0);
        const bool in1 = col1 < limit && (!mask || mask[(size_t)b * S + col1] != 0);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tl = row0 + warp * RPW + r;
            const int row = q_offset + tl;
            float a = s0[r], c = s1[r];
            if (bias_bh && tl < T_) {
                const T* br = bias_bh + (size_t)tl * S;
                if (col0 < S) a += to_f(br[col0]);
                if (col1 < S) c += to_f(br[col1]);
            }
            const bool keep0 = in0 && (!causal || col0 <= row) &&
                               (window <= 0 || row - col0 < window);
            const bool keep1 = in1 && (!causal || col1 <= row) &&
                               (window <= 0 || row - col1 < window);
            a = keep0 ? a : NEG_INF;
            c = keep1 ? c : NEG_INF;
            float mx = fmaxf(a, c);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
            const float m_new = fmaxf(m[r], mx);
            // keep-guard: a row masked so far has m_new = NEG_INF
            const float p0 = keep0 ? expf(a - m_new) : 0.f;
            const float p1 = keep1 ? expf(c - m_new) : 0.f;
            const float alpha = expf(m[r] - m_new);
            lpart[r] = lpart[r] * alpha + p0 + p1;
            m[r] = m_new;
#pragma unroll
            for (int cc = 0; cc < DPL; ++cc) acc[r][cc] *= alpha;
            pw[r * BK + lane] = to_f(from_f<T>(p0));
            pw[r * BK + lane + 32] = to_f(from_f<T>(p1));
        }
        __syncwarp();

        // acc[r][:] += P[r, :] @ V for this lane's output dims
#pragma unroll 1
        for (int c = 0; c < BK; c += 4) {
            float vv[4][DPL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) vv[u][cc] = Vs[(c + u) * D + lane + 32 * cc];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 p = *reinterpret_cast<const float4*>(pw + r * BK + c);
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc)
                    acc[r][cc] += p.x * vv[0][cc] + p.y * vv[1][cc] + p.z * vv[2][cc] +
                                  p.w * vv[3][cc];
            }
        }
        __syncwarp();
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        float l = lpart[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
        const int tl = row0 + warp * RPW + r;
        if (tl >= T_) continue;
        const float denom = l > 0.f ? l : 1.f;
        T* orow = out + ((size_t)b * T_ + tl) * HD + (size_t)h * D;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) orow[lane + 32 * cc] = from_f<T>(acc[r][cc] / denom);
        if (lane == 0)
            lse[((size_t)b * H + h) * T_ + tl] =
                l > 0.f ? m[r] + logf(fmaxf(l, 1e-37f)) : 0.f;
    }
}

}  // namespace fwd
}  // namespace
