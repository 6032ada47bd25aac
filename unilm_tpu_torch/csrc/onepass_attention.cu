// One-pass short-sequence attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_onepass_kernel` (:978),
// reached through `_flash_forward_onepass` (:1061) from `_flash_impl`
// (:1166) wherever `_onepass_profitable` (:1152) admits the shape: every
// flash call at short sequences (YOCO's sliding-window and cross layers
// over a cache of <= 256 slots, prefill and decode). The contract is the
// flash forward's (#1, csrc/flash_fwd.cu), not the encoder kernel's (#3):
// q pre-scaled, causal with a query offset, sliding window, valid-kv prefix
// `limit`, per-key padding mask, an additive bias broadcast over
// [B|1, H|1, T, S], and an fp32 lse [B, H, T]. A fully masked row gives
// out = 0 and lse = 0 (the TPU kernel's `l > 0` guards, :1047-1058), not
// the average of v that #3's and #9's finite -1e30 would give. Per row:
//   m = max over kept keys of s,   p = exp(s - m) (0 where masked),
//   l = sum p (fp32, unrounded),   out = (p rounded to v's type) v / l,
//   lse = m + log l,
// in the exp2 domain here (log2(e) folded into q as it is staged, into the
// bias as it is added, lse brought back by ln 2), as the TPU kernel's fast
// path does. Its fast path (full kv, no mask: padded columns at -inf) is
// the same function and needs no branch here: nothing is padded.
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D] (row
// stride H*D), bias [Bb, Hb, T, S] with element strides `bias_sb`,
// `bias_sh` (0 = broadcast), mask [B, S] int32 (nonzero = valid) or null,
// lse [B, H, T] fp32.
//
// What bounds it on the H100: the shapes the selector admits are small
// (the TPU budget keeps q/k/v and the score plane within 8 MB per batch
// item), so a call moves a few MB and does a few hundred MFLOP: at
// YOCO's chat prefill (B=8, T=128, a 256-slot cache, 16 heads, D=64,
// bf16) q, k, v and out are 4.2 MB and the visible pairs 1.1e8 FLOP, a
// bound of ~1.3 us; its decode step (T=1) is the K/V read, ~2.6 us. Such a
// call is bound by its launch and its latency, not by either rate, so this
// first version computes both products on the fp32 CUDA cores, as #3's
// body does; tensor-core tiles are later work.
// What the design does about it: whole score rows of a block's 16 query
// rows stay in shared memory (the TPU kernel's VMEM-resident plane), so K
// and V are each read once per block and nothing but out and lse is
// written; only the key tiles that the block's rows can see are staged
// (causal, window and `limit` cut the range: a decode step at position p
// reads p + 1 keys of the cache, not all of it); a warp whose rows all lie
// past T (a decode step's block holds one row) stages tiles for the others
// and computes nothing. Each warp owns 4 query rows and each lane two keys
// of a 64-key tile, so one K value from shared memory feeds 4 FMAs.
// Grid: one block per (16-row q tile, head, batch), 4 warps.

#include <math.h>

#include "flash_common.cuh"

namespace {
namespace onepass {

constexpr int BK = 64;               // keys per K / V tile
constexpr int NWARPS = 4;            // warps per block
constexpr int RPW = 4;               // query rows per warp
constexpr int BQ = NWARPS * RPW;     // query rows per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block may opt into

struct Params {
    const void *q, *k, *v, *bias;
    const int* mask;
    void* out;
    float* lse;
    int T, S, H, bias_sb, bias_sh, q_offset, limit, causal, window;
};

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32) onepass_kernel(const Params p, int Sp) {
    constexpr int DPL = D / 32;  // output dims per lane
    constexpr int KST = D + 4;   // padded K row stride (float4 aligned)
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D], times log2(e)
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
    const int wrow0 = row0 + warp * RPW;  // this warp's first query row
    const bool live = wrow0 < T_;

    // the key tiles any row of this block can see
    const int j_end = key_tiles_end(row0, BQ, BK, p.q_offset, p.limit, p.causal);
    int j_begin = 0;
    if (p.window > 0) j_begin = max(0, p.q_offset + row0 - p.window + 1) / BK;

    stage_rows<T, D>(Qs, D, q + ((size_t)b * T_ + row0) * HD + (size_t)h * D, HD, BQ, T_ - row0,
                     tid, NWARPS * 32);
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NWARPS * 32) Qs[i] *= LOG2E;

    const float* qw = Qs + warp * RPW * D;
    float* sw = Ss + (size_t)warp * RPW * Sp;
    const T* bias_bh = bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;
    const T* kb = k + (size_t)b * S * HD + (size_t)h * D;
    const T* vb = v + (size_t)b * S * HD + (size_t)h * D;

    // ---- phase 1: the visible score rows, log2 domain; masked = -inf ----
    for (int j = j_begin; j < j_end; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // Q scaled / previous K tile consumed
        stage_rows<T, D>(KV, KST, kb + (size_t)c0 * HD, HD, BK, S - c0, tid, NWARPS * 32);
        __syncthreads();
        if (!live) continue;

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
        const bool valid0 = col0 < p.limit && (!mask_b || mask_b[col0]);
        const bool valid1 = col1 < p.limit && (!mask_b || mask_b[col1]);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int t = wrow0 + r;
            const int pos = p.q_offset + t;  // the query's position
            bool keep0 = valid0, keep1 = valid1;
            if (p.causal) {
                keep0 = keep0 && col0 <= pos;
                keep1 = keep1 && col1 <= pos;
            }
            if (p.window > 0) {
                keep0 = keep0 && pos - col0 < p.window;
                keep1 = keep1 && pos - col1 < p.window;
            }
            float a = s0[r], c = s1[r];
            if (bias_bh && t < T_) {
                const T* br = bias_bh + (size_t)t * S;
                if (keep0) a += LOG2E * to_f(br[col0]);
                if (keep1) c += LOG2E * to_f(br[col1]);
            }
            sw[(size_t)r * Sp + col0] = keep0 ? a : -INFINITY;
            sw[(size_t)r * Sp + col1] = keep1 ? c : -INFINITY;
        }
    }
    __syncwarp();

    // ---- phase 2: exact softmax of each visible row (this warp's rows) --
    const int c_begin = j_begin * BK, c_end = max(j_end, j_begin) * BK;
    float inv_l[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        inv_l[r] = 0.f;
        if (!live) continue;
        float* row = sw + (size_t)r * Sp;
        float m = -INFINITY;
        for (int c = c_begin + lane; c < c_end; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        const bool any = m > -INFINITY;  // no kept key: p = 0, l = 0
        float l = 0.f;
        for (int c = c_begin + lane; c < c_end; c += 32) {
            const float e = any ? exp2f(row[c] - m) : 0.f;
            row[c] = round_to<T>(e);  // the PV product's operand
            l += e;                   // the row sum adds the unrounded values
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
        const int t = wrow0 + r;
        if (l > 0.f) inv_l[r] = 1.f / l;
        if (lane == 0 && t < T_)
            p.lse[((size_t)b * p.H + h) * T_ + t] = l > 0.f ? (m + log2f(l)) * LN2 : 0.f;
    }
    __syncwarp();

    // ---- phase 3: out = P V / l -----------------------------------------
    float acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[r][cc] = 0.f;
    for (int j = j_begin; j < j_end; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // every warp is done with the previous tile
        stage_rows<T, D>(KV, D, vb + (size_t)c0 * HD, HD, BK, S - c0, tid, NWARPS * 32);
        __syncthreads();
        if (!live) continue;
        const int cend = min(BK, (min(S, p.limit) - c0 + 3) & ~3);  // later keys have p = 0
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
        const int t = wrow0 + r;
        if (t >= T_) continue;
        T* orow = out + ((size_t)b * T_ + t) * HD + (size_t)h * D;
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
    auto kern = onepass_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.T + BQ - 1) / BQ, p.H, B);
    kern<<<grid, NWARPS * 32, smem, stream>>>(p, Sp);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Params& p, int B, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<T, 64>(p, B, stream);
        case 96: return launch<T, 96>(p, B, stream);
        case 128: return launch<T, 128>(p, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace onepass
}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q is pre-scaled. Returns
// cudaGetLastError() after the launch.
int onepass_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                     const int* mask, void* out, float* lse, int B, int T_, int S, int H, int D,
                     int bias_sb, int bias_sh, int q_offset, int limit, int causal, int window,
                     int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    if (S <= 0 || q_offset < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const onepass::Params p{q,       k,       v,   bias, mask,     out,   lse,
                            T_,      S,       H,   bias_sb, bias_sh, q_offset,
                            limit < S ? limit : S, causal, window};
    cudaError_t err;
    if (dtype == 0)
        err = onepass::dispatch_d<float>(D, p, B, st);
    else if (dtype == 1)
        err = onepass::dispatch_d<__nv_bfloat16>(D, p, B, st);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
