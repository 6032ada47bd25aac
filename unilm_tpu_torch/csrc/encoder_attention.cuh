// The CUDA-core body of the whole-row encoder attention forward, shared by
// csrc/encoder_attention.cu (#3: fp32 and bf16, no mask) and the fp32 path
// of csrc/doc_attention.cu (#9: an optional key-padding mask). The design
// and its measurements are described at the top of encoder_attention.cu.
//
// Per (batch, head): out = softmax(s) v with s = qscale q k^T + log2(e)
// bias in the exp2 domain, a masked key (mask[b][s] == 0) at the finite
// -1e30, so a row whose keys are all masked averages v over its S keys.
// q is multiplied by qscale in fp32 as it is staged; for fp32 inputs that
// is also q * qscale rounded to q's type, the doc kernels' contract. A
// key's bias is read only when the key is kept.

#pragma once

#include "flash_common.cuh"

namespace {
namespace enc_fwd {

constexpr int BK = 64;               // keys per K / V tile
constexpr int NWARPS = 4;            // warps per block
constexpr int RPW = 4;               // query rows per warp
constexpr int BQ = NWARPS * RPW;     // query rows per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block may opt into

struct Params {
    const void *q, *k, *v, *bias;
    const int* mask;  // [B, S], nonzero = valid key; null = every key valid
    void* out;
    int T, S, H, bias_sb, bias_sh;
    float qscale;  // scale * log2(e)
};

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32) encoder_attn_kernel(const Params p, int Sp) {
    constexpr int DPL = D / 32;  // output dims per lane
    constexpr int KST = D + 4;   // padded K row stride (float4 aligned)
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D], scaled by qscale
    float* KV = Qs + BQ * D;                      // [BK][KST] K tile, then [BK][D] V tile
    float* Ss = KV + BK * KST;                    // [BQ][Sp] scores, then probabilities

    const T* q = static_cast<const T*>(p.q);
    const T* k = static_cast<const T*>(p.k);
    const T* v = static_cast<const T*>(p.v);
    const T* bias = static_cast<const T*>(p.bias);
    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * BQ;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const int ntiles = Sp / BK;

    stage_rows<T, D>(Qs, D, q + ((size_t)b * T_ + row0) * HD + (size_t)h * D, HD, BQ, T_ - row0,
                     tid, NWARPS * 32);
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NWARPS * 32) Qs[i] *= p.qscale;

    const float* qw = Qs + warp * RPW * D;
    float* sw = Ss + (size_t)warp * RPW * Sp;
    const T* bias_bh = bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;
    const T* kb = k + (size_t)b * S * HD + (size_t)h * D;
    const T* vb = v + (size_t)b * S * HD + (size_t)h * D;

    // ---- phase 1: the score rows s = q k^T (+ bias), log2 domain -------
    for (int j = 0; j < ntiles; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // Q scaled / previous K tile consumed
        stage_rows<T, D>(KV, KST, kb + (size_t)c0 * HD, HD, BK, S - c0, tid, NWARPS * 32);
        __syncthreads();

        float s0[RPW], s1[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = 0.f;
        const float* k0 = KV + lane * KST;
        const float* k1 = KV + (lane + 32) * KST;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(k0 + d);
            const float4 c = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 x = *reinterpret_cast<const float4*>(qw + r * D + d);
                s0[r] += dot4(x, a);
                s1[r] += dot4(x, c);
            }
        }
        const int col0 = c0 + lane, col1 = c0 + lane + 32;
        const bool keep0 = col0 < S && (!mask_b || mask_b[col0]);
        const bool keep1 = col1 < S && (!mask_b || mask_b[col1]);
        // rows past T read row T - 1's bias (their output is not written):
        // a `tl < T_` guard on the read instead made #9's fp32 body slower
        // at the eval CLI's shape, with the same bits (PERF.md, Findings)
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tl = min(row0 + warp * RPW + r, T_ - 1);
            float a = s0[r], c = s1[r];
            if (bias_bh) {
                const T* br = bias_bh + (size_t)tl * S;
                if (keep0) a += LOG2E * to_f(br[col0]);
                if (keep1) c += LOG2E * to_f(br[col1]);
            }
            sw[(size_t)r * Sp + col0] = keep0 ? a : NEG_INF;
            sw[(size_t)r * Sp + col1] = keep1 ? c : NEG_INF;
        }
    }
    __syncwarp();

    // ---- phase 2: exact softmax of each whole row (this warp's rows) ---
    float inv_l[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        float* row = sw + (size_t)r * Sp;
        float m = NEG_INF;
        for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        float l = 0.f;
        for (int c = lane; c < Sp; c += 32) {
            // a masked key sits at -1e30: p = 0 next to any valid key, 1
            // in a row whose keys are all masked
            const float pr = c < S ? round_to<T>(exp2f(row[c] - m)) : 0.f;
            row[c] = pr;
            l += pr;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
        inv_l[r] = 1.f / l;  // the row max contributes exp2(0) = 1, so l >= 1
    }
    __syncwarp();

    // ---- phase 3: out = P V / l -----------------------------------------
    float acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[r][cc] = 0.f;
    for (int j = 0; j < ntiles; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // every warp is done with the previous tile
        stage_rows<T, D>(KV, D, vb + (size_t)c0 * HD, HD, BK, S - c0, tid, NWARPS * 32);
        __syncthreads();
        const int cend = min(BK, (S - c0 + 3) & ~3);  // columns past S have p = 0
#pragma unroll 1
        for (int c = 0; c < cend; c += 4) {
            float vv[4][DPL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) vv[u][cc] = KV[(c + u) * D + lane + 32 * cc];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 pr = *reinterpret_cast<const float4*>(sw + (size_t)r * Sp + c0 + c);
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc)
                    acc[r][cc] += pr.x * vv[0][cc] + pr.y * vv[1][cc] + pr.z * vv[2][cc] +
                                  pr.w * vv[3][cc];
            }
        }
    }

    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int tl = row0 + warp * RPW + r;
        if (tl >= T_) continue;
        T* orow = out + ((size_t)b * T_ + tl) * HD + (size_t)h * D;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) orow[lane + 32 * cc] = from_f<T>(acc[r][cc] * inv_l[r]);
    }
}

// one launch over B batch items; cudaErrorInvalidValue when S is too long
// for whole score rows in shared memory
template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    const int Sp = (p.S + BK - 1) / BK * BK;
    const size_t smem = (size_t)(BQ * D + BK * (D + 4) + BQ * Sp) * sizeof(float);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    auto kern = encoder_attn_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.T + BQ - 1) / BQ, p.H, B);
    kern<<<grid, NWARPS * 32, smem, stream>>>(p, Sp);
    return cudaGetLastError();
}

}  // namespace enc_fwd
}  // namespace
