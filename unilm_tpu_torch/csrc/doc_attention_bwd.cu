// Blocked document attention backward for Hopper (sm_90a), plain C
// interface: the gradient of csrc/doc_attention.cu (#9).
//
// Replaces: unilm_tpu/ops/doc_attention.py `_doc_bwd_kernel` (:108),
// launched by `doc_backward` (:291) from the custom VJP `_doc_attention_bwd`
// (:396). Same function, per (batch, head), with the scores recomputed from
// q * scale * log2(e) rounded to q's type (the exp2 domain, the bias times
// log2(e) added, a masked key at -1e30), p the fp32 natural softmax,
// dp = dO v^T, delta = rowsum(p dp) (recomputed, not rowsum(dO out)) and
// ds = p (dp - delta):
//   dq = scale ds k,   dk = scale ds^T q,   dv = p^T dO,   and ds itself,
// emitted in the inputs' type (bf16 for bf16, fp32 for fp32) as the bias
// gradient before any broadcast reduction (the caller sums it over a
// broadcast batch or head axis, as `doc_backward` does outside the Pallas
// kernel, :370-381). ds is rounded to k's type before ds k and ds^T q, p
// to dO's type before p^T dO (:159-176).
//
// The TPU kernel sweeps the q blocks of one (batch, head group) in order on
// one core and accumulates dk/dv in VMEM across them. On the H100 blocks run
// in parallel and nothing carries over between them, so the bf16 path is
// three launches of one entry point, with no atomics (two runs give the
// same bits).
//
// Layouts are the caller's: q/dO/dq [B, T, H, D], k/v/dk/dv [B, S, H, D]
// (row stride H*D), the mask int32 [B, S] or null, the bias and the ds
// plane [., ., T, S] rows with element strides (batch, head): `bias_sb`,
// `bias_sh` (0 = broadcast) and `ds_sb`, `ds_sh` (ds is never broadcast:
// [B, H, T, S] or head-major [H, B, T, S]), the statistics fp32 [3, B, H, T].
//
// What bounds it on the H100: at the FUNSD shape (B=32, T=S=709, H=12,
// D=64, bf16) the bias read and the ds written are 772 MB of the 1016 MB
// that must move once, against 1.2e11 FLOP: 0.303 ms at 3.35 TB/s against
// 0.125 ms of bf16 tensor time. The schedule below moves the bias twice and
// ds twice (written, then read): ~1.55 GB, 0.46 ms at 3.35 TB/s, and runs
// seven products of 2 D operations per (row, key) pair.
//  - bf16 (namespace hop, the machinery of csrc/flash_bwd.cu, #6/#7:
//    csrc/hopper.cuh's TMA maps, mbarrier rings with the 10 s trap, SS and
//    RS wgmma, a producer warpgroup at setmaxnreg 56 and consumer
//    warpgroups of 64 rows or keys at 224, the role through __shfl_sync):
//    1. `doc_bwd_stats_sm90`, a block per 128 q rows: Q and dO resident,
//       64-key K/V tiles streamed; the consumers scale their Q rows in
//       place to q' = q * scale * log2 e rounded to bf16 (and write q' to
//       dq's buffer for launch 2), take S = Q' K^T and dP = dO V^T, add the
//       bias (read once) and the mask, and keep
//       each row's online max m, l = sum 2^(s - m) and u = sum 2^(s - m) dp;
//       they write m, 1 / l and delta = u / l (the recomputed rowsum(p dp)).
//    2. `doc_bwd_dkv_sm90`, a block per 128 keys (64 at D = 96, 128): K, V
//       resident, 64-row tiles of q', q and dO streamed with their rows'
//       statistics; S^T = K Q'^T and dP^T = V dO^T, the bias again,
//       p^T = 2^(s - m) / l, ds^T = p^T (dp^T - delta) in fp32, ds written
//       to the plane as bf16 (exactly the TPU kernel's bf16 `dsl`), then
//       dV += P^T dO and dK += dS^T Q with p and ds rounded to bf16 as the A
//       operands. dk = scale dS^T q uses the unscaled q.
//    3. `doc_bwd_dq_sm90`, a block per 128 q rows: 64-key K tiles and the
//       matching ds tiles streamed; the ds fragments go from the staged
//       tile into the A operand of dq += dS K; dq = scale dS K.
//    The bias and ds rows hold S bf16: 1418 bytes at S = 709, not a
//    multiple of 16, so no TMA map takes them: the producer warpgroups
//    stage their tiles by 16-byte cp.async into shared memory (see
//    hopper.cuh `stage_plane`, which #4 shares), beside the TMA tiles of
//    the same ring stage; ds is written with 2-byte stores in the
//    accumulators' fragment layout. The tiles are
//    ops/doc_attention.doc_bwd_tile_plan's (tests/test_torch_hopper_plans).
//  - fp32: #4's own fp32 CUDA-core launches (encoder_attention_bwd.cuh,
//    shared with csrc/encoder_attention_bwd.cu) given the mask, with the ds
//    plane as their fp32 dbias planes. They recompute ds from dp and the
//    row's delta in their dk/dv launch instead of reading it back (equal to
//    the plane's fp32 values up to rounding), and scale q k^T after the
//    product, not q before it (the last bits).

#include <cmath>

#include "encoder_attention_bwd.cuh"
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
    const void *q, *k, *v, *dout, *bias;
    const int* mask;  // [B, S], nonzero = valid key; null = every key valid
    void *dq, *dk, *dv, *ds;
    float* stats;     // [3][B][H][T]: row max m (exp2 domain), then bf16: 1 / l and
                      // delta; fp32: l and delta
    int B, T, S, H, bias_sb, bias_sh, ds_sb, ds_sh;
    float scale, qscale;  // scale and scale * log2(e)
};

// ---------------------------------------------------------------------------
// bf16 inputs: the Hopper kernels
// ---------------------------------------------------------------------------
namespace hop {

constexpr int ROWS = 64;  // rows of a consumer's tile (wgmma M) and of a streamed tile
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // 384-thread blocks

using sm90::afrag;
using sm90::bf_lo;
using sm90::Plane;
using sm90::rs_product;
using sm90::ss_product;
using sm90::stage_off;
using sm90::stage_plane;
using sm90::tile_bits;

// ---- launch 1: row statistics ------------------------------------------------
//
// A block per 128 q rows of one (batch, head): two consumer warpgroups of
// 64 rows. The producer warpgroup TMA-loads Q and dO once and streams
// 64-key K/V tiles and the matching [128, 64] bias tiles through a ring,
// packing each tile's key-padding mask into bits; the consumers scale
// their rows of Q in place (q * scale * log2 e, rounded to bf16: the
// scores' operand) and write the same q' to dq's buffer for launch 2, then
// per tile take S = Q' K^T and dP = dO V^T (SS wgmma), add the bias and
// update the rows' online max m, sum l = sum 2^(s - m) and u = sum
// 2^(s - m) dp. The quad merges its partial statistics in a fixed
// butterfly; stats gets m, 1 / l and delta = u / l.

template <int D> struct StatGeo : sm90::Cols<D> {
    static constexpr int NCW = 2;
    static constexpr int BQ = ROWS * NCW;          // q rows per block
    static constexpr int BK = 64;                  // keys per tile
    static constexpr int NW = BK / 32;             // mask words per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = D == 128 ? 3 : 4;   // stages of the K/V/bias ring
    static constexpr int Q_BYTES = BQ * D * 2;     // Q, then dO
    static constexpr int KV_BYTES = BK * D * 2;    // one K or one V tile
    static constexpr int B_BYTES = BQ * Plane<BK>::BYTES_PER_ROW;  // a bias tile
    static constexpr int OFF_K = 2 * Q_BYTES;      // stage s: K, then V
    static constexpr int OFF_B = OFF_K + NST * 2 * KV_BYTES;      // [NST] bias tiles
    static constexpr int OFF_BITS = OFF_B + NST * B_BYTES;        // [NST][NW] mask words
    static constexpr int OFF_BAR = OFF_BITS + NST * NW * 4;  // q_full, full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ size_t plane_base(const Params& p, bool ds, int b, int h) {
    return ds ? (size_t)b * p.ds_sb + (size_t)h * p.ds_sh
              : (size_t)b * p.bias_sb + (size_t)h * p.bias_sh;
}

template <int D>
__device__ __forceinline__ void stats_producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                               const CUtensorMap* tk, const CUtensorMap* tv,
                                               const Params& p, uint8_t* smem, int b, int h,
                                               int q0) {
    using G = StatGeo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::OFF_BITS);
    const int t = threadIdx.x, lane = t & 31;
    const bf16* bias = static_cast<const bf16*>(p.bias);
    const size_t base = plane_base(p, false, b, h);
    if (t == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tdo);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
        sm90::mbar_arrive_expect_tx(&bars[0], 2 * G::Q_BYTES);
#pragma unroll
        for (int c = 0; c < G::NC; ++c) {
            sm90::tma_load_4d(smem + c * G::BQ * G::CB, tq, &bars[0], c * G::CW, h, q0, b);
            sm90::tma_load_4d(smem + G::Q_BYTES + c * G::BQ * G::CB, tdo, &bars[0], c * G::CW,
                              h, q0, b);
        }
    }
    const int nk = (p.S + G::BK - 1) / G::BK;
    for (int j = 0; j < nk; ++j) {
        const int s = j % G::NST;
        // the tile's mask as bits (warp 0), read before the stage frees up:
        // key j BK + 32 i + bit is kept iff bit `bit` of word i is set
        uint32_t mw[G::NW];
        if (t < 32 && p.mask) {
            const int* mrow = p.mask + (size_t)b * p.S;
#pragma unroll
            for (int i = 0; i < G::NW; ++i) {
                const int col = j * G::BK + 32 * i + lane;
                mw[i] = __ballot_sync(FULL, col < p.S && __ldg(mrow + col) != 0);
            }
        }
        if (j >= G::NST) sm90::mbar_wait(&empty[s], (j / G::NST - 1) & 1);
        if (bias)
            stage_plane<G::BQ, G::BK>(reinterpret_cast<uint32_t*>(smem + G::OFF_B + s * G::B_BYTES),
                                      bias, base, p.S, p.T, q0, j * G::BK, t);
        sm90::cp_async_arrive(&full[s]);
        if (t < 32) {
            if (p.mask && lane == 0) {
#pragma unroll
                for (int i = 0; i < G::NW; ++i) bits[G::NW * s + i] = mw[i];
            }
            if (lane == 0) {
                // the arrive releases the mask words written above
                sm90::mbar_arrive_expect_tx(&full[s], 2 * G::KV_BYTES);
                uint8_t* kst = smem + G::OFF_K + 2 * s * G::KV_BYTES;
#pragma unroll
                for (int c = 0; c < G::NC; ++c) {
                    sm90::tma_load_4d(kst + c * G::BK * G::CB, tk, &full[s], c * G::CW, h,
                                      j * G::BK, b);
                    sm90::tma_load_4d(kst + G::KV_BYTES + c * G::BK * G::CB, tv, &full[s],
                                      c * G::CW, h, j * G::BK, b);
                }
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void stats_consumer(const Params& p, uint8_t* smem, int cw, int b,
                                               int h, int q0) {
    using G = StatGeo<D>;
    constexpr int BK = G::BK, NN = BK / 8;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(smem + G::OFF_BITS);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = q0 + cw * ROWS;  // this consumer's first query row
    const bool live = row0 < p.T;
    const int tl[2] = {row0 + 16 * w + r8, row0 + 16 * w + r8 + 8};  // this thread's rows
    const size_t HD = (size_t)p.H * D;
    const bool has_bias = p.bias != nullptr;
    const size_t base = plane_base(p, false, b, h);
    int boff[2];  // the rows' offsets in the staged bias tiles (c0 a multiple of 64)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) boff[hh] = stage_off(base, tl[hh], p.S, 0);

    sm90::mbar_wait(&bars[0], 0);
    // q' = q * scale * log2 e rounded to bf16: in place in this consumer's
    // rows of each box (a swizzle moves 16-byte chunks within a row, so an
    // element-wise pass need not know it), and from global q into dq's
    // buffer for launch 2
#pragma unroll
    for (int c = 0; c < G::NC; ++c) {
        uint32_t* x = reinterpret_cast<uint32_t*>(smem + c * G::BQ * G::CB + cw * ROWS * G::CB);
        for (int i = t; i < ROWS * G::CB / 4; i += 128) x[i] = scale2(x[i], p.qscale);
    }
    const bf16* q = static_cast<const bf16*>(p.q);
    bf16* qs = static_cast<bf16*>(p.dq);
    for (int i = t; i < ROWS * D / 8; i += 128) {
        const int r = row0 + i / (D / 8), d = (i % (D / 8)) * 8;
        if (r >= p.T) continue;
        const size_t off = ((size_t)b * p.T + r) * HD + (size_t)h * D + d;
        uint4 u = *reinterpret_cast<const uint4*>(q + off);
        u.x = scale2(u.x, p.qscale);
        u.y = scale2(u.y, p.qscale);
        u.z = scale2(u.z, p.qscale);
        u.w = scale2(u.w, p.qscale);
        *reinterpret_cast<uint4*>(qs + off) = u;
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1 + cw, 128);

    const uint32_t q_base = smem_addr(smem) + cw * ROWS * G::CB;
    const uint32_t do_base = q_base + G::Q_BYTES;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
    const int nk = (p.S + BK - 1) / BK;
    for (int j = 0; j < nk; ++j) {
        const int s = j % G::NST;
        sm90::mbar_wait(&full[s], (j / G::NST) & 1);
        if (live) {
            const int c0 = j * BK;
            const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
            const uint32_t v_base = k_base + G::KV_BYTES;
            const uint32_t* btile =
                reinterpret_cast<const uint32_t*>(smem + G::OFF_B + s * G::B_BYTES);
            float sc[BK / 2], dp[BK / 2];
            sm90::wgmma_fence();
            ss_product<D, G::BQ, BK>(sc, q_base, k_base);
            ss_product<D, G::BQ, BK>(dp, do_base, v_base);
            sm90::wgmma_commit();
            uint32_t keep_bits = ~0u;  // bit 2 nn + e: key c0 + 8 nn + 2 quad + e
            if (p.mask) {
                keep_bits = 0;
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
                    keep_bits |= ((bits[G::NW * s + (nn >> 2)] >> (8 * (nn & 3) + 2 * quad)) & 3u)
                                 << (2 * nn);
            }
            sm90::wgmma_wait<0>();

            // s in the exp2 domain: + log2(e) bias, a masked key -1e30,
            // past S -inf; then the online statistics of the two rows
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = tl[hh] - q0;
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int k = 8 * nn + 2 * quad + e, col = c0 + k;
                        const bool keep = (keep_bits >> (2 * nn + e)) & 1u;
                        const float bv =
                            has_bias ? bf_lo(tile_bits<BK>(btile, r, k + boff[hh])) : 0.f;
                        const int i = 4 * nn + 2 * hh + e;
                        sc[i] = col >= p.S ? -INFINITY : keep ? fmaf(LOG2E, bv, sc[i]) : NEG_INF;
                    }
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float mt = m[hh];
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
                    mt = fmaxf(mt, fmaxf(sc[4 * nn + 2 * hh], sc[4 * nn + 2 * hh + 1]));
                const float a = sm90::ex2(m[hh] - mt);
                float ls = 0.f, us = 0.f;
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int i = 4 * nn + 2 * hh + e;
                        const float x = sm90::ex2(sc[i] - mt);
                        ls += x;
                        us += x * dp[i];
                    }
                l[hh] = l[hh] * a + ls;
                u[hh] = u[hh] * a + us;
                m[hh] = mt;
            }
        }
        sm90::mbar_arrive(&empty[s]);
    }

    // merge the quad's statistics (a fixed butterfly) and write them
    const size_t plane = (size_t)p.B * p.H * p.T;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            const float mo = __shfl_xor_sync(FULL, m[hh], o);
            const float lo = __shfl_xor_sync(FULL, l[hh], o);
            const float uo = __shfl_xor_sync(FULL, u[hh], o);
            const float mt = fmaxf(m[hh], mo);
            const float a = sm90::ex2(m[hh] - mt), c = sm90::ex2(mo - mt);
            l[hh] = l[hh] * a + lo * c;
            u[hh] = u[hh] * a + uo * c;
            m[hh] = mt;
        }
        if (quad == 0 && tl[hh] < p.T) {
            const size_t ri = ((size_t)b * p.H + h) * p.T + tl[hh];
            p.stats[ri] = m[hh];
            p.stats[plane + ri] = 1.f / l[hh];
            p.stats[2 * plane + ri] = u[hh] / l[hh];
        }
    }
}

// A block's tile and (batch, head): the tiles of one (batch, head) are
// neighbours in the grid, so the K/V (or q, dO) they share is read from
// memory once and from L2 after
struct Block {
    int b, h, tile;
};
__device__ __forceinline__ Block block_of(const Params& p, int ntiles) {
    const int bh = blockIdx.x / ntiles;
    return {bh / p.H, bh % p.H, (int)blockIdx.x % ntiles};
}

template <int D>
__global__ void __launch_bounds__(StatGeo<D>::THREADS, 1)
doc_bwd_stats_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
    using G = StatGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const Block blk = block_of(p, (p.T + G::BQ - 1) / G::BQ);
    const int q0 = blk.tile * G::BQ;

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(&bars[0], 1);  // Q and dO loaded
        for (int s = 0; s < G::NST; ++s) {
            // stage s loaded: the producer warpgroup's copies, then the TMA
            sm90::mbar_init(&bars[1 + s], 128 + 1);
            sm90::mbar_init(&bars[1 + G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        stats_producer<D>(&tq, &tdo, &tk, &tv, p, smem, blk.b, blk.h, q0);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        stats_consumer<D>(p, smem, wg - 1, blk.b, blk.h, q0);
    }
}

// ---- launch 2: dk, dv and the ds plane ---------------------------------------
//
// A block per 128 keys of one (batch, head) (64 at D = 96 and 128: one
// consumer warpgroup), K and V resident; the producer warpgroup streams
// 64-row tiles of q', q and dO (TMA), their rows' statistics and the
// [64, keys] bias tiles (cp.async). A consumer takes S^T = K Q'^T and
// dP^T = V dO^T (SS wgmma), adds the bias, forms p^T = 2^(s - m) / l and
// ds^T = p^T (dp^T - delta) in fp32, writes ds as bf16 into the plane
// (rows < T, keys < S) and takes dV += P^T dO and dK += dS^T Q with p and
// ds rounded to bf16 as the A operands (RS wgmma, Q and dO through the
// transpose bit).

template <int D> struct DkvGeo : sm90::Cols<D> {
    static constexpr int NCW = D == 64 ? 2 : 1;    // consumer warpgroups of 64 keys
    static constexpr int BKB = ROWS * NCW;          // keys per block
    static constexpr int BQ = 64;                   // q rows per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = D == 128 ? 3 : 4;    // stages of the ring
    static constexpr int KV_BYTES = BKB * D * 2;    // K, then V
    static constexpr int Q_BYTES = BQ * D * 2;      // one q', q or dO tile
    static constexpr int B_BYTES = BQ * Plane<BKB>::BYTES_PER_ROW;  // a bias tile
    static constexpr int OFF_Q = 2 * KV_BYTES;      // stage s: q', q, dO
    static constexpr int OFF_B = OFF_Q + NST * 3 * Q_BYTES;   // [NST] bias tiles
    static constexpr int OFF_ST = OFF_B + NST * B_BYTES;      // [NST][3][BQ]: m, 1/l, delta
    static constexpr int OFF_BAR = OFF_ST + NST * 3 * BQ * 4;  // kv_full, full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tqs, const CUtensorMap* tq,
                                             const CUtensorMap* tdo, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const Params& p,
                                             uint8_t* smem, int b, int h, int c0) {
    using G = DkvGeo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    const int t = threadIdx.x;
    const bf16* bias = static_cast<const bf16*>(p.bias);
    const size_t base = plane_base(p, false, b, h);
    if (t == 0) {
        sm90::prefetch_tensormap(tqs);
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tdo);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
        sm90::mbar_arrive_expect_tx(&bars[0], 2 * G::KV_BYTES);
#pragma unroll
        for (int cw = 0; cw < G::NCW; ++cw)
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                uint8_t* kt = smem + cw * ROWS * D * 2 + c * ROWS * G::CB;
                sm90::tma_load_4d(kt, tk, &bars[0], c * G::CW, h, c0 + cw * ROWS, b);
                sm90::tma_load_4d(kt + G::KV_BYTES, tv, &bars[0], c * G::CW, h,
                                  c0 + cw * ROWS, b);
            }
    }
    const size_t rbase = ((size_t)b * p.H + h) * p.T, plane = (size_t)p.B * p.H * p.T;
    const int nq = (p.T + G::BQ - 1) / G::BQ;
    for (int i = 0; i < nq; ++i) {
        const int s = i % G::NST;
        if (i >= G::NST) sm90::mbar_wait(&empty[s], (i / G::NST - 1) & 1);
        float* st = reinterpret_cast<float*>(smem + G::OFF_ST) + s * 3 * G::BQ;
        for (int r = t; r < 3 * G::BQ; r += 128) {
            const int which = r / G::BQ, tr = i * G::BQ + r % G::BQ;
            const bool in = tr < p.T;
            sm90::cp4(st + r, in ? p.stats + which * plane + rbase + tr : p.stats, in ? 4 : 0);
        }
        if (bias)
            stage_plane<G::BQ, G::BKB>(reinterpret_cast<uint32_t*>(smem + G::OFF_B + s * G::B_BYTES),
                                       bias, base, p.S, p.T, i * G::BQ, c0, t);
        sm90::cp_async_arrive(&full[s]);
        if (t == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], 3 * G::Q_BYTES);
            uint8_t* qst = smem + G::OFF_Q + 3 * s * G::Q_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                const int off = c * G::BQ * G::CB;
                sm90::tma_load_4d(qst + off, tqs, &full[s], c * G::CW, h, i * G::BQ, b);
                sm90::tma_load_4d(qst + G::Q_BYTES + off, tq, &full[s], c * G::CW, h,
                                  i * G::BQ, b);
                sm90::tma_load_4d(qst + 2 * G::Q_BYTES + off, tdo, &full[s], c * G::CW, h,
                                  i * G::BQ, b);
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void dkv_consumer(const Params& p, uint8_t* smem, int cw, int b,
                                             int h, int kc0) {
    using G = DkvGeo<D>;
    constexpr int BQ = G::BQ;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int c0 = kc0 + cw * ROWS;  // this consumer's first key
    const int kc[2] = {c0 + 16 * w + r8, c0 + 16 * w + r8 + 8};  // this thread's keys
    bool kin[2], kok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        kin[hh] = kc[hh] < p.S;
        kok[hh] = kin[hh] && (!p.mask || __ldg(p.mask + (size_t)b * p.S + kc[hh]) != 0);
    }
    const bool has_bias = p.bias != nullptr;
    const size_t bbase = plane_base(p, false, b, h);
    bf16* ds_bh = static_cast<bf16*>(p.ds) + plane_base(p, true, b, h);
    const uint32_t k_base = smem_addr(smem) + cw * ROWS * D * 2;
    const uint32_t v_base = k_base + G::KV_BYTES;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(&bars[0], 0);
    const int nq = (p.T + BQ - 1) / BQ;
    for (int i = 0; i < nq; ++i) {
        const int s = i % G::NST;
        sm90::mbar_wait(&full[s], (i / G::NST) & 1);
        if (c0 < p.S) {
            const int t0 = i * BQ;
            const uint32_t qs_st = smem_addr(smem + G::OFF_Q + 3 * s * G::Q_BYTES);
            const uint32_t q_st = qs_st + G::Q_BYTES;
            const uint32_t do_st = q_st + G::Q_BYTES;
            const float* st = reinterpret_cast<const float*>(smem + G::OFF_ST) + s * 3 * BQ;
            const uint32_t* btile =
                reinterpret_cast<const uint32_t*>(smem + G::OFF_B + s * G::B_BYTES);

            // S^T = K Q'^T and dP^T = V dO^T, [keys, rows]: sc[4 nn + 2 hh + e]
            // is key kc[hh], row t0 + 8 nn + 2 quad + e
            float sc[32], dp[32];
            sm90::wgmma_fence();
            ss_product<D, ROWS, BQ>(sc, k_base, qs_st);
            ss_product<D, ROWS, BQ>(dp, v_base, do_st);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();

            // p^T and ds^T in fp32; ds to the plane; both as bf16 A operands
            uint32_t pa[16], da[16];
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                const int r = 8 * nn + 2 * quad;
                const float2 m2 = *reinterpret_cast<const float2*>(st + r);
                const float2 rl2 = *reinterpret_cast<const float2*>(st + BQ + r);
                const float2 dl2 = *reinterpret_cast<const float2*>(st + 2 * BQ + r);
                const int o0 = stage_off(bbase, t0 + r, p.S, kc0);
                const int o1 = stage_off(bbase, t0 + r + 1, p.S, kc0);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int i0 = 4 * nn + 2 * hh, kl = kc[hh] - kc0;
                    float x0 = sc[i0], x1 = sc[i0 + 1];
                    if (has_bias) {
                        x0 = fmaf(LOG2E, bf_lo(tile_bits<G::BKB>(btile, r, kl + o0)), x0);
                        x1 = fmaf(LOG2E, bf_lo(tile_bits<G::BKB>(btile, r + 1, kl + o1)), x1);
                    }
                    if (!kok[hh]) x0 = x1 = kin[hh] ? NEG_INF : -INFINITY;
                    const float p0 = sm90::ex2(x0 - m2.x) * rl2.x;
                    const float p1 = sm90::ex2(x1 - m2.y) * rl2.y;
                    const float d0 = p0 * (dp[i0] - dl2.x), d1 = p1 * (dp[i0 + 1] - dl2.y);
                    pa[afrag(nn, hh)] = pack(p0, p1);
                    const uint32_t dd = pack(d0, d1);
                    da[afrag(nn, hh)] = dd;
                    if (kin[hh]) {
                        const int tr = t0 + r;
                        unsigned short* dst =
                            reinterpret_cast<unsigned short*>(ds_bh + (size_t)tr * p.S + kc[hh]);
                        if (tr < p.T) dst[0] = (unsigned short)(dd & 0xffffu);
                        if (tr + 1 < p.T) dst[p.S] = (unsigned short)(dd >> 16);
                    }
                }
            }

            // dV += P^T dO, dK += dS^T Q; dO and Q are [rows, D], MN-major
            sm90::wgmma_fence();
            rs_product<D>(dv, pa, do_st);
            rs_product<D>(dk, da, q_st);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
        }
        sm90::mbar_arrive(&empty[s]);
    }

    bf16* dkp = static_cast<bf16*>(p.dk);
    bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (!kin[hh]) continue;
        const size_t off = (((size_t)b * p.S + kc[hh]) * p.H + h) * D + 2 * quad;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
            *reinterpret_cast<uint32_t*>(dkp + off + 8 * nn) =
                pack(dk[4 * nn + 2 * hh] * p.scale, dk[4 * nn + 2 * hh + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvp + off + 8 * nn) =
                pack(dv[4 * nn + 2 * hh], dv[4 * nn + 2 * hh + 1]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(DkvGeo<D>::THREADS, 1)
doc_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
    using G = DkvGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const Block blk = block_of(p, (p.S + G::BKB - 1) / G::BKB);
    const int c0 = blk.tile * G::BKB;

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(&bars[0], 1);  // K and V loaded
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&bars[1 + s], 128 + 1);                 // stage s loaded
            sm90::mbar_init(&bars[1 + G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_dec<PRODUCER_REGS>();
        dkv_producer<D>(&tqs, &tq, &tdo, &tk, &tv, p, smem, blk.b, blk.h, c0);
    } else {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_inc<CONSUMER_REGS>();
        dkv_consumer<D>(p, smem, wg - 1, blk.b, blk.h, c0);
    }
}

// ---- launch 3: dq = scale ds k --------------------------------------------------
//
// A block per 128 q rows of one (batch, head): two consumer warpgroups of
// 64 rows; the producer warpgroup streams 64-key K tiles (TMA) and the
// matching [128, 64] ds tiles (cp.async). A consumer packs its ds
// fragments from the staged tile and takes dq += dS K (RS wgmma, K through
// the transpose bit).

template <int D> struct DqGeo : sm90::Cols<D> {
    static constexpr int NCW = 2;
    static constexpr int BQ = ROWS * NCW;
    static constexpr int BK = ROWS;                // keys per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = 4;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr int S_BYTES = BQ * Plane<BK>::BYTES_PER_ROW;  // a ds tile
    static constexpr int OFF_S = NST * KV_BYTES;
    static constexpr int OFF_BAR = OFF_S + NST * S_BYTES;  // full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + 2 * NST * 8 + 1024;
    static_assert(KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(DqGeo<D>::THREADS, 1)
doc_bwd_dq_sm90(const __grid_constant__ CUtensorMap tk, const Params p) {
    using G = DqGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const Block blk = block_of(p, (p.T + G::BQ - 1) / G::BQ);
    const int b = blk.b, h = blk.h, q0 = blk.tile * G::BQ;
    const int nk = (p.S + G::BK - 1) / G::BK;
    const bf16* ds = static_cast<const bf16*>(p.ds);
    const size_t base = plane_base(p, true, b, h);

    uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* empty = full + G::NST;
    if (threadIdx.x == 0) {
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&full[s], 128 + 1);
            sm90::mbar_init(&empty[s], 128 * G::NCW);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        const int t = threadIdx.x;
        if (t == 0) sm90::prefetch_tensormap(&tk);
        for (int j = 0; j < nk; ++j) {
            const int s = j % G::NST;
            if (j >= G::NST) sm90::mbar_wait(&empty[s], (j / G::NST - 1) & 1);
            stage_plane<G::BQ, G::BK>(reinterpret_cast<uint32_t*>(smem + G::OFF_S + s * G::S_BYTES),
                                      ds, base, p.S, p.T, q0, j * G::BK, t);
            sm90::cp_async_arrive(&full[s]);
            if (t == 0) {
                sm90::mbar_arrive_expect_tx(&full[s], G::KV_BYTES);
#pragma unroll
                for (int c = 0; c < G::NC; ++c)
                    sm90::tma_load_4d(smem + s * G::KV_BYTES + c * G::BK * G::CB, &tk, &full[s],
                                      c * G::CW, h, j * G::BK, b);
            }
        }
        return;
    }
    const int cw = wg - 1;
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = q0 + cw * ROWS;
    const int tl[2] = {row0 + 16 * w + r8, row0 + 16 * w + r8 + 8};
    int off[2];  // the rows' offsets in the staged ds tiles (c0 a multiple of 64)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) off[hh] = stage_off(base, tl[hh], p.S, 0);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < nk; ++j) {
        const int s = j % G::NST;
        sm90::mbar_wait(&full[s], (j / G::NST) & 1);
        const uint32_t* stile = reinterpret_cast<const uint32_t*>(smem + G::OFF_S + s * G::S_BYTES);
        uint32_t da[16];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = tl[hh] - q0;
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                // keys past S hold the next row's ds: 0 instead
                const int c = j * G::BK + 8 * nn + 2 * quad, k = c - j * G::BK + off[hh];
                da[afrag(nn, hh)] = (c < p.S ? tile_bits<G::BK>(stile, r, k) : 0u) |
                                    (c + 1 < p.S ? tile_bits<G::BK>(stile, r, k + 1) << 16 : 0u);
            }
        }
        sm90::wgmma_fence();
        rs_product<D>(acc, da, smem_addr(smem + s * G::KV_BYTES));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::mbar_arrive(&empty[s]);
    }
    bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (tl[hh] >= p.T) continue;
        bf16* dst = dq + (((size_t)b * p.T + tl[hh]) * p.H + h) * D + 2 * quad;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
            *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                pack(acc[4 * nn + 2 * hh] * p.scale, acc[4 * nn + 2 * hh + 1] * p.scale);
    }
}

template <typename K>
cudaError_t prepare(K kern, int smem) {
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the three launches; q' goes through dq's buffer (launch 1 writes it,
// launch 2 reads it, launch 3 overwrites it with dq)
template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    using S1 = StatGeo<D>;
    using S2 = DkvGeo<D>;
    using S3 = DqGeo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap q128, do128, k64, v64, qs64, q64, do64;
    if (!sm90::make_map<D>(enc, &q128, p.q, p.B, p.T, p.H, S1::BQ) ||
        !sm90::make_map<D>(enc, &do128, p.dout, p.B, p.T, p.H, S1::BQ) ||
        !sm90::make_map<D>(enc, &k64, p.k, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map<D>(enc, &v64, p.v, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map<D>(enc, &qs64, p.dq, p.B, p.T, p.H, S2::BQ) ||
        !sm90::make_map<D>(enc, &q64, p.q, p.B, p.T, p.H, S2::BQ) ||
        !sm90::make_map<D>(enc, &do64, p.dout, p.B, p.T, p.H, S2::BQ))
        return cudaErrorInvalidValue;
    cudaError_t err;
    if ((err = prepare(doc_bwd_stats_sm90<D>, S1::SMEM)) != cudaSuccess ||
        (err = prepare(doc_bwd_dkv_sm90<D>, S2::SMEM)) != cudaSuccess ||
        (err = prepare(doc_bwd_dq_sm90<D>, S3::SMEM)) != cudaSuccess)
        return err;
    const int BH = p.B * p.H;
    doc_bwd_stats_sm90<D><<<(p.T + S1::BQ - 1) / S1::BQ * BH, S1::THREADS, S1::SMEM, stream>>>(
        q128, do128, k64, v64, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    doc_bwd_dkv_sm90<D><<<(p.S + S2::BKB - 1) / S2::BKB * BH, S2::THREADS, S2::SMEM, stream>>>(
        qs64, q64, do64, k64, v64, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    doc_bwd_dq_sm90<D><<<(p.T + S3::BQ - 1) / S3::BQ * BH, S3::THREADS, S3::SMEM, stream>>>(k64, p);
    return cudaGetLastError();
}

}  // namespace hop

// fp32 inputs: #4's fp32 launches (encoder_attention_bwd.cuh) with the mask,
// one (batch, head) per launch-1 block, the ds plane as its dbias planes
cudaError_t launch_fp32(int D, const Params& p, cudaStream_t stream) {
    const enc_bwd::Params e{p.q, p.k, p.v, p.dout, p.bias, p.mask, p.dq, p.dk, p.dv,
                            static_cast<float*>(p.ds), p.stats, p.B, p.T, p.S, p.H, p.bias_sb,
                            p.bias_sh, (size_t)p.ds_sb, (size_t)p.ds_sh, 1, 0, p.scale,
                            p.qscale};
    switch (D) {
        case 64: return enc_bwd::launch_fp32<64>(e, p.B, stream);
        case 96: return enc_bwd::launch_fp32<96>(e, p.B, stream);
        case 128: return enc_bwd::launch_fp32<128>(e, p.B, stream);
        default: return cudaErrorInvalidValue;
    }
}


}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `scale` multiplies q k^T. `mask` is
// int32 [B, S] or null; `bias` is null or addressed as bias + b * bias_sb +
// h * bias_sh + t * S + s; `ds` (every element written, in the inputs'
// type) as ds + b * ds_sb + h * ds_sh + t * S + s. `stats` is [3, B, H, T]
// fp32 scratch. Returns cudaGetLastError() after the second launch.
int doc_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const void* bias, const void* mask, void* dq, void* dk, void* dv, void* ds,
                 void* stats, int B, int T_, int S, int H, int D, int bias_sb, int bias_sh,
                 int ds_sb, int ds_sh, float scale, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    if (S <= 0 || !ds || !stats || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    const Params p{q, k, v, dout, bias, static_cast<const int*>(mask), dq, dk, dv, ds,
                   static_cast<float*>(stats), B, T_, S, H, bias_sb, bias_sh, ds_sb, ds_sh,
                   scale, scale * LOG2E};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_fp32(D, p, st);
    switch (D) {
        case 64: return (int)hop::launch<64>(p, st);
        case 96: return (int)hop::launch<96>(p, st);
        case 128: return (int)hop::launch<128>(p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
