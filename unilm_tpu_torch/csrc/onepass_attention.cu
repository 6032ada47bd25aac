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
// in the exp2 domain (log2(e) folded into the exponent, or into q and the
// bias as the CUDA-core paths stage them), as the TPU kernel's fast path
// does. Its fast path (full kv, no mask: padded
// columns at -inf) is the same function and needs no branch here: nothing
// is padded.
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
// bound of ~2.5 us; its decode step (T=1) is the K/V read, ~1.4 us. Such a
// call is bound by its launch and its latency, not by either rate.
// The bf16 paths (the plan is ops/flash_attention.py's
// `onepass_tile_plan`, pinned on the CPU by tests/test_torch_onepass_plan):
//  - T > 16, `onepass_kernel_sm90`: a block of 384 threads per 128 query
//    rows of one (batch, head): a producer warpgroup (setmaxnreg 40) and
//    two consumer warpgroups of 64 rows (232), the role taken through
//    __shfl_sync. One producer thread loads the block's q and the visible
//    K/V of its rows, chunks of 128 keys at D = 32 and 64 (64 at D = 96
//    and 128, where 128 scores a thread beside O spilled) by TMA (4-D
//    maps, rows past S read as zeros) into 3 stages (4 at D = 96, 128): up to 384 keys (256)
//    arrive in one wave, so a short row is staged once and never waits on
//    a ring; longer rows stream through the same stages. Causal, window
//    and `limit` cut the staged chunks to the block's visible range and
//    each consumer's walk to its rows' range (#1's `key_walk`). A consumer
//    takes S = Q K^T by SS wgmma (64 x 128 keys, 64 fp32 a thread) and,
//    as #1's consumer does, adds the bias (register loads: its rows of S
//    bf16 are 2-byte aligned, no TMA map takes them) only where there is
//    one and applies the keep predicate only to a chunk that is not
//    interior (`tile_interior`; the padding mask as bits packed by the
//    producer warp): a first version that evaluated both for every
//    element ran the yoco_chat prefill 1.5x slower. Then the row max over
//    the chunk (quad shuffles), p = 2^(log2(e) s - log2(e) m) rounded to
//    bf16 in registers as the A operand of the RS wgmma O += P V, V
//    through the transpose bit. A row whose visible keys fit one chunk
//    (every yoco_chat row) gets its exact max and l in one step, as the
//    TPU kernel does; a longer row rescales O and l by the online factor
//    per chunk (the same function, within the twin's tolerance). out =
//    O / l, 0 for a row with no kept key.
//  - T <= 16 (decode), `onepass_kernel_walk`: a 64-row wgmma tile would
//    waste 63 rows of 64, so the CUDA cores walk the keys: a block of 8
//    warps per (batch, head), q staged as fp32 times log2(e); each warp
//    takes 32-key tiles in turn, a lane per key (its K row by 16-byte
//    loads, the scores of all T rows against it), the row max by a
//    butterfly over the warp, p rounded to bf16 into shared memory, then
//    P V with the lanes on the 4-byte words of the V rows (coalesced).
//    Only the keys the rows can see are read: a decode step at position p
//    reads p + 1 keys of the cache. The warps' (m, l, P V) are merged in
//    warp order in shared memory; nothing is atomic, two runs are
//    bit-equal.
// float32 keeps the first design (`onepass_kernel`, fp32 CUDA cores):
// whole score rows of 16 query rows in shared memory, K and V read once
// per block; each warp owns 4 query rows, each lane two keys of a 64-key
// tile; a warp whose rows all lie past T stages tiles for the others.

#include <math.h>

#include "hopper.cuh"

namespace {

// ---- float32: the CUDA-core body ------------------------------------------
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
        case 32: return launch<T, 32>(p, B, stream);
        case 64: return launch<T, 64>(p, B, stream);
        case 96: return launch<T, 96>(p, B, stream);
        case 128: return launch<T, 128>(p, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace onepass

// ---- bf16 ------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
    const bf16 *q, *k, *v, *bias;
    const int* mask;
    bf16* out;
    float* lse;
    int T, S, H, nq, bias_sb, bias_sh, q_offset, limit, causal, window;
};

// ---- T > 16: wgmma over whole short rows -----------------------------------
namespace hop {

constexpr int BQ = 128;          // query rows per block
constexpr int CROWS = 64;        // query rows per consumer warpgroup (wgmma M)
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int D> struct Geo : sm90::Cols<D> {     // CW, CB, NC, SWZ: the TMA boxes
    // keys per staged K/V chunk (the QK^T product's N): 64 at D = 96 and
    // 128, where 64 x 128 scores beside O spilled
    static constexpr int BK = D <= 64 ? 128 : 64;
    static constexpr int NW = BK / 32;                 // mask words per chunk
    static constexpr int NST = D <= 64 ? 3 : 4;        // K/V chunks in flight
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;        // one K or one V chunk
    static constexpr int OFF_K = Q_BYTES;              // stage s: K, then V
    static constexpr int OFF_BITS = OFF_K + NST * 2 * KV_BYTES;  // [NST][NW] mask words
    static constexpr int OFF_BAR = OFF_BITS + NST * 16;  // q_full, full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;  // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

// warp 0 of the producer warpgroup: q once, then the block's chunks [jb, je)
template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Params& p, uint8_t* smem,
                                         int b, int h, int q0, int jb, int je) {
    using G = Geo<D>;
    constexpr int BK = G::BK;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::OFF_BITS);
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
        sm90::mbar_arrive_expect_tx(bars, G::Q_BYTES);
#pragma unroll
        for (int c = 0; c < G::NC; ++c)
            sm90::tma_load_4d(smem + c * BQ * G::CB, tq, bars, c * G::CW, h, q0, b);
    }
    for (int j = jb, n = 0; j < je; ++j, ++n) {
        const int s = n % G::NST;
        if (n >= G::NST) sm90::mbar_wait(&empty[s], (n / G::NST - 1) & 1);
        if (p.mask) {
            // key c0 + 32 i + bit is kept iff bit `bit` of word i is set
            const int* mrow = p.mask + (size_t)b * p.S;
            uint32_t w[G::NW];
#pragma unroll
            for (int i = 0; i < G::NW; ++i) {
                const int col = j * BK + 32 * i + lane;
                w[i] = __ballot_sync(FULL, col < p.S && __ldg(mrow + col) != 0);
            }
            if (lane == 0) {
#pragma unroll
                for (int i = 0; i < G::NW; ++i) bits[G::NW * s + i] = w[i];
            }
        }
        if (lane == 0) {
            // the arrive releases the mask words written above
            sm90::mbar_arrive_expect_tx(&full[s], 2 * G::KV_BYTES);
            uint8_t* kst = smem + G::OFF_K + 2 * s * G::KV_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(kst + c * BK * G::CB, tk, &full[s], c * G::CW, h, j * BK, b);
                sm90::tma_load_4d(kst + G::KV_BYTES + c * BK * G::CB, tv, &full[s], c * G::CW,
                                  h, j * BK, b);
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, int cw, int b, int h,
                                         int q0, int jb, int je) {
    using G = Geo<D>;
    constexpr int BK = G::BK, NN = BK / 8;  // keys per chunk, 8-key column groups
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(smem + G::OFF_BITS);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = q0 + cw * CROWS;         // this consumer's first query row
    const int nvalid = min(CROWS, p.T - row0);  // its rows < T (may be <= 0)
    const int lo = p.q_offset + row0, hi = lo + nvalid - 1;
    int cjb = 0, cje = 0;
    if (nvalid > 0) key_walk<BK>(lo, hi, p.limit, p.causal, p.window, cjb, cje);

    const uint32_t q_base = smem_addr(smem) + cw * CROWS * G::CB;
    const bf16* bias_bh =
        p.bias ? p.bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(bars, 0);
    for (int j = jb, n = 0; j < je; ++j, ++n) {
        const int s = n % G::NST;
        sm90::mbar_wait(&full[s], (n / G::NST) & 1);
        if (j >= cjb && j < cje) {
            const int c0 = j * BK;
            const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
            const uint32_t v_base = k_base + G::KV_BYTES;

            // S = Q K^T: D / 16 k-steps, both operands K-major
            float sc[BK / 2];
            sm90::wgmma_fence();
#pragma unroll
            for (int c = 0; c < G::NC; ++c)
#pragma unroll
                for (int kk = 0; kk < G::CW / 16; ++kk) {
                    const uint64_t da = sm90::kmajor_desc<D, BQ>(q_base, c, kk);
                    const uint64_t db = sm90::kmajor_desc<D, BK>(k_base, c, kk);
                    if constexpr (BK == 128)
                        sm90::wgmma_ss_n128(sc, da, db, c | kk);
                    else
                        sm90::wgmma_ss_n64(sc, da, db, c | kk);
                }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();

            // this thread's keys of the chunk: bit 2n + e = key c0 + 8n + 2 quad + e
            uint32_t keep_bits = ~0u;
            if (p.mask) {
                uint32_t ws[G::NW], all = ~0u;
#pragma unroll
                for (int i = 0; i < G::NW; ++i) all &= ws[i] = bits[G::NW * s + i];
                if (all != ~0u) {
                    keep_bits = 0;
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn)
                        keep_bits |= ((ws[nn >> 2] >> (8 * (nn & 3) + 2 * quad)) & 3u) << (2 * nn);
                }
            }
            if (bias_bh) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int tl = row0 + 16 * w + r8 + 8 * hh;
                    if (tl >= p.T) continue;
                    const bf16* br = bias_bh + (size_t)tl * p.S;
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int col = c0 + 8 * nn + 2 * quad + e;
                            if (col < p.S) sc[4 * nn + 2 * hh + e] += __bfloat162float(br[col]);
                        }
                }
            }
            if (!tile_interior<BK>(c0, lo, hi, p.limit, p.causal, p.window)) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int row = lo + 16 * w + r8 + 8 * hh;
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int col = c0 + 8 * nn + 2 * quad + e;
                            const bool keep = col < p.limit && (!p.causal || col <= row) &&
                                              (p.window <= 0 || row - col < p.window) &&
                                              ((keep_bits >> (2 * nn + e)) & 1u);
                            if (!keep) sc[4 * nn + 2 * hh + e] = -INFINITY;
                        }
                }
            } else if (keep_bits != ~0u) {
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (!((keep_bits >> (2 * nn + e)) & 1u)) {
                            sc[4 * nn + e] = -INFINITY;
                            sc[4 * nn + 2 + e] = -INFINITY;
                        }
            }

            // online softmax on the fragments; a row with no kept key so far
            // has m = -inf and exponentiates against 0 (the keep-guard). Each
            // pair of probabilities is cast to bf16 as soon as it is taken:
            // pa[4 kk + r] is the A operand of the k-step of keys 16 kk ..
            // 16 kk + 15 (r = 2 (nn & 1) + hh for the keys 8 nn + 2 quad + e)
            uint32_t pa[BK / 4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float mx = -INFINITY;
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
                    mx = fmaxf(mx, fmaxf(sc[4 * nn + 2 * hh], sc[4 * nn + 2 * hh + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
                const float m_new = fmaxf(m[hh], mx);
                const float m_use = m_new == -INFINITY ? 0.f : m_new;
                const float alpha = sm90::ex2((m[hh] - m_use) * LOG2E);
                const float ms = m_use * LOG2E;
                m[hh] = m_new;
                float sum = 0.f;
#pragma unroll
                for (int nn = 0; nn < NN; ++nn) {
                    const float p0 = sm90::ex2(fmaf(sc[4 * nn + 2 * hh], LOG2E, -ms));
                    const float p1 = sm90::ex2(fmaf(sc[4 * nn + 2 * hh + 1], LOG2E, -ms));
                    sum += p0 + p1;
                    pa[4 * (nn >> 1) + 2 * (nn & 1) + hh] = pack(p0, p1);
                }
                l[hh] = l[hh] * alpha + sum;
#pragma unroll
                for (int nn = 0; nn < D / 8; ++nn) {
                    o[4 * nn + 2 * hh] *= alpha;
                    o[4 * nn + 2 * hh + 1] *= alpha;
                }
            }

            // O += P V: V is [keys, D], MN-major (the transpose bit)
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                sm90::wgmma_rs<D>(o, pa + 4 * kk, sm90::mnmajor_desc<D, BK>(v_base, kk));
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
        }
        sm90::mbar_arrive(&empty[s]);
    }

    // out = O / l (0 for a row with no kept key), lse = m + log l
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float lt = l[hh];
        lt += __shfl_xor_sync(FULL, lt, 1);
        lt += __shfl_xor_sync(FULL, lt, 2);
        const float inv = lt > 0.f ? 1.f / lt : 0.f;
        const int r = 16 * w + r8 + 8 * hh;
        if (r >= nvalid) continue;
        bf16* dst = p.out + (((size_t)b * p.T + row0 + r) * p.H + h) * D + 2 * quad;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
            *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                pack(o[4 * nn + 2 * hh] * inv, o[4 * nn + 2 * hh + 1] * inv);
        if (quad == 0)
            p.lse[((size_t)b * p.H + h) * p.T + row0 + r] =
                lt > 0.f ? m[hh] + logf(fmaxf(lt, 1e-37f)) : 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
onepass_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
    using G = Geo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    // block -> (q tile, batch, head); a causal grid runs the last q tile,
    // which sees the most keys, first
    const int BH = gridDim.x / p.nq;
    const int bh = blockIdx.x % BH;
    int qt = blockIdx.x / BH;
    if (p.causal) qt = p.nq - 1 - qt;
    const int b = bh / p.H, h = bh % p.H, q0 = qt * BQ;

    int jb, je;  // the chunks any row of the block can see
    key_walk<G::BK>(p.q_offset + q0, p.q_offset + min(q0 + BQ, p.T) - 1, p.limit, p.causal,
                 p.window, jb, je);

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(bars, 1);  // q loaded
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(bars + 1 + s, 1);             // stage s loaded
            sm90::mbar_init(bars + 1 + G::NST + s, 256);  // stage s read by both consumers
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x < 32) producer<D>(&tq, &tk, &tv, p, smem, b, h, q0, jb, je);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        consumer<D>(p, smem, wg - 1, b, h, q0, jb, je);
    }
}

template <int D>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
    using G = Geo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    if (!sm90::make_map<D>(enc, &tq, p.q, B, p.T, p.H, BQ) ||
        !sm90::make_map<D>(enc, &tk, p.k, B, p.S, p.H, G::BK) ||
        !sm90::make_map<D>(enc, &tv, p.v, B, p.S, p.H, G::BK))
        return cudaErrorInvalidValue;
    p.nq = (p.T + BQ - 1) / BQ;
    auto kern = onepass_kernel_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    kern<<<p.nq * B * p.H, THREADS, G::SMEM, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace hop

// ---- T <= 16: the CUDA-core walk ---------------------------------------------
namespace walk {

constexpr int MAX_T = 16;        // the longest q the walk takes
constexpr int NW = 8;            // warps per block
constexpr int NT = NW * 32;
constexpr int KT = 32;           // keys per warp tile: a lane per key

// shared memory of the block, fp32: q [RW][D], p [NW][RW][KT], the warps'
// m and l [NW][RW] and P V [NW][RW][D]
template <int D, int RW> constexpr int smem_bytes() {
    return (RW * D + NW * RW * KT + 2 * NW * RW + NW * RW * D) * 4;
}

// RW: the rows the registers hold (1 for a decode step, else MAX_T)
template <int D, int RW>
__global__ void __launch_bounds__(NT) onepass_kernel_walk(const Params p) {
    constexpr int NWD = D / 2;                // 4-byte words of a V row
    constexpr int WPL = (NWD + 31) / 32;      // of them per lane
    extern __shared__ float4 smem4[];
    float* qs = reinterpret_cast<float*>(smem4);  // [RW][D]: q * log2(e)
    float* ps = qs + RW * D;                      // [NW][RW][KT]: p rounded to bf16
    float* ms = ps + NW * RW * KT;                // [NW][RW]: each warp's row max
    float* ls = ms + NW * RW;                     // [NW][RW]: ... row sum
    float* os = ls + NW * RW;                     // [NW][RW][D]: ... P V
    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;

    for (int i = tid; i < RW * D; i += NT) {
        const int r = i / D, d = i % D;
        qs[i] = r < T_ ? LOG2E * __bfloat162float(p.q[((size_t)b * T_ + r) * HD + h * D + d])
                       : 0.f;
    }
    // the keys any row can see: [kb, ke)
    const int kb = p.window > 0 ? max(0, p.q_offset - p.window + 1) : 0;
    const int ke = p.causal ? min(p.limit, p.q_offset + T_) : p.limit;
    __syncthreads();

    const bf16* kbh = p.k + (size_t)b * S * HD + (size_t)h * D;
    const bf16* vbh = p.v + (size_t)b * S * HD + (size_t)h * D;
    const bf16* bias_bh =
        p.bias ? p.bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;
    float* pw = ps + warp * RW * KT;

    float m[RW], l[RW], o[RW][2 * WPL];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        m[r] = -INFINITY;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < 2 * WPL; ++i) o[r][i] = 0.f;
    }

    for (int c0 = kb + warp * KT; c0 < ke; c0 += NW * KT) {
        const int c = c0 + lane;  // this lane's key
        const bool in = c < ke;
        float s[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) s[r] = 0.f;
        if (in) {
            const uint4* kr = reinterpret_cast<const uint4*>(kbh + (size_t)c * HD);
#pragma unroll
            for (int d8 = 0; d8 < D / 8; ++d8) {
                float f[8];
                const uint4 u = __ldg(kr + d8);
                const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float2 x = __bfloat1622float2(h2[i]);
                    f[2 * i] = x.x;
                    f[2 * i + 1] = x.y;
                }
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    if (r >= T_) break;
                    const float4 a = *reinterpret_cast<const float4*>(qs + r * D + 8 * d8);
                    const float4 e = *reinterpret_cast<const float4*>(qs + r * D + 8 * d8 + 4);
                    s[r] += a.x * f[0] + a.y * f[1] + a.z * f[2] + a.w * f[3] + e.x * f[4] +
                            e.y * f[5] + e.z * f[6] + e.w * f[7];
                }
            }
        }
        const bool kin = in && (!mask_b || __ldg(mask_b + c) != 0);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            const int pos = p.q_offset + r;
            const bool keep = kin && r < T_ && (!p.causal || c <= pos) &&
                              (p.window <= 0 || pos - c < p.window);
            float x = -INFINITY;
            if (keep)
                x = s[r] + (bias_bh ? LOG2E * __bfloat162float(bias_bh[(size_t)r * S + c]) : 0.f);
            float mt = x;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, off));
            const float m_new = fmaxf(m[r], mt);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no kept key yet
            const float alpha = sm90::ex2(m[r] - m_use);
            const float pr = sm90::ex2(x - m_use);
            l[r] = l[r] * alpha + pr;  // this lane's share of the unrounded sum
#pragma unroll
            for (int i = 0; i < 2 * WPL; ++i) o[r][i] *= alpha;
            m[r] = m_new;
            pw[r * KT + lane] = round_to<bf16>(pr);  // the P V operand
        }
        __syncwarp();
        // P V: the lanes on the words of each key's V row
        const int nk = min(KT, ke - c0);
#pragma unroll 4
        for (int j = 0; j < nk; ++j) {
            const uint32_t* vr = reinterpret_cast<const uint32_t*>(vbh + (size_t)(c0 + j) * HD);
            float2 vv[WPL];
#pragma unroll
            for (int i = 0; i < WPL; ++i) {
                const int wd = lane + 32 * i;
                uint32_t u = wd < NWD ? __ldg(vr + wd) : 0u;
                vv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
            }
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                if (r >= T_) break;
                const float pj = pw[r * KT + j];
#pragma unroll
                for (int i = 0; i < WPL; ++i) {
                    o[r][2 * i] += pj * vv[i].x;
                    o[r][2 * i + 1] += pj * vv[i].y;
                }
            }
        }
        __syncwarp();
    }

    // each warp's (m, l, P V) into shared memory; l summed over the lanes
    // in a fixed butterfly
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        float lt = l[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(FULL, lt, off);
        if (lane == 0) {
            ms[warp * RW + r] = m[r];
            ls[warp * RW + r] = lt;
        }
#pragma unroll
        for (int i = 0; i < WPL; ++i) {
            const int wd = lane + 32 * i;
            if (wd < NWD) {
                os[(warp * RW + r) * D + 2 * wd] = o[r][2 * i];
                os[(warp * RW + r) * D + 2 * wd + 1] = o[r][2 * i + 1];
            }
        }
    }
    __syncthreads();

    // merge the warps in warp order: out = sum_w O_w 2^(m_w - M) / L
    for (int i = tid; i < T_ * D; i += NT) {
        const int r = i / D, d = i % D;
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < NW; ++w) M = fmaxf(M, ms[w * RW + r]);
        float L = 0.f, O = 0.f;
        if (M > -INFINITY) {
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                const float f = sm90::ex2(ms[w * RW + r] - M);  // 0 for a warp with no key
                L += ls[w * RW + r] * f;
                O += os[(w * RW + r) * D + d] * f;
            }
        }
        p.out[((size_t)b * T_ + r) * HD + (size_t)h * D + d] =
            __float2bfloat16(L > 0.f ? O / L : 0.f);
        if (d == 0)
            p.lse[((size_t)b * p.H + h) * T_ + r] = L > 0.f ? (M + log2f(L)) * LN2 : 0.f;
    }
}

template <int D, int RW>
cudaError_t launch_rw(const Params& p, int B, cudaStream_t stream) {
    constexpr int smem = smem_bytes<D, RW>();
    auto kern = onepass_kernel_walk<D, RW>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(p.H, B), NT, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    return p.T == 1 ? launch_rw<D, 1>(p, B, stream) : launch_rw<D, MAX_T>(p, B, stream);
}

}  // namespace walk

// the bf16 path the plan names: the walk for T <= 16, else the wgmma rows
template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
    return p.T <= walk::MAX_T ? walk::launch<D>(p, B, stream) : hop::launch<D>(p, B, stream);
}

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
    limit = limit < S ? limit : S;
    if (dtype == 0) {
        const onepass::Params p{q,       k,       v,   bias,    mask,    out,      lse,
                                T_,      S,       H,   bias_sb, bias_sh, q_offset, limit,
                                causal,  window};
        return (int)onepass::dispatch_d<float>(D, p, B, st);
    }
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const Params p{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v),    static_cast<const bf16*>(bias),
                   mask,                           static_cast<bf16*>(out),
                   lse,                            T_,
                   S,                              H,
                   0,                              bias_sb,
                   bias_sh,                        q_offset,
                   limit,                          causal,
                   window};
    switch (D) {
        case 32: return (int)launch_bf16<32>(p, B, st);
        case 64: return (int)launch_bf16<64>(p, B, st);
        case 96: return (int)launch_bf16<96>(p, B, st);
        case 128: return (int)launch_bf16<128>(p, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
