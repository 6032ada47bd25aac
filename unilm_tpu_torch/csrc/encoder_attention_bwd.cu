// Encoder attention backward for Hopper (sm_90a), plain C interface: the
// gradient of csrc/encoder_attention.cu (#3).
//
// Replaces: unilm_tpu/ops/flash_attention.py `_vit_bwd_kernel` (:711),
// reached through `_vit_backward` (:814) from the custom VJP `_vit_bwd`
// (:937). Same function, per (batch, head): with the scores
// s = scale q k^T + bias, p = softmax(s) recomputed exactly in fp32 (no
// residual of the forward is read), dp = dO v^T, delta = rowsum(p dp) and
// ds = p (dp - delta):
//   dq = scale ds k,   dk = scale ds^T q,   dv = p^T dO,   dbias = ds,
// dbias summed over the dims the bias broadcasts. ds is rounded to k's
// type before ds k and ds^T q, p to dO's type before p^T dO; dbias is fp32
// and unrounded (the natural-domain ds). The scores are taken in the exp2
// domain, scale * log2(e) multiplying q k^T and log2(e) the bias, as in
// the TPU kernel and #3. The ragged edge (T, S not multiples of a tile) is
// masked here; the TPU wrapper pads with a NEG_INF bias instead.
//
// The TPU kernel keeps a whole [T, S] plane per head in VMEM and walks the
// batch in order on one core, accumulating a batch-broadcast dbias in one
// resident block. On the H100 blocks run in parallel and nothing carries
// over between them, so the one pass becomes launches of one entry point,
// with no float atomics (two runs give the same bits).
//
// Layouts are the caller's: q/dO/dq [B, T, H, D], k/v/dk/dv [B, S, H, D]
// (row stride H*D, the projection layout), bias [Bb, Hb, T, S] with
// element strides `bias_sb`, `bias_sh` (0 = broadcast), dbias fp32
// [Bb, Hb, T, S], the partial planes fp32 [groups, Hb, T, S], the row
// statistics fp32 [3, B, H, T], the bf16 ds plane [B, H, T, S].
//
// What bounds it on the H100: the work itself (five T x S x D products per
// batch and head, 10 B H T S D FLOP) is bound by memory on the card: at
// BEiT-B (B=256, T=S=197, H=12, D=64, bf16) 545 MB in and out against
// 7.6e10 FLOP, 0.163 ms at 3.35 TB/s against 0.077 ms of bf16 tensor time.
//  - bf16 (the training path), namespace hop, the machinery of
//    csrc/doc_attention_bwd.cu (#10, which computes the same function with
//    a key-padding mask): csrc/hopper.cuh's TMA maps, mbarrier rings with
//    the 10 s trap, SS and RS wgmma, producer warpgroups at setmaxnreg 72
//    and consumer warpgroups of 64 rows or keys at 216, the role through
//    __shfl_sync. Seven products of 2 D operations per (row, key) pair
//    where the first design ran nine, the bias read twice, ds written once
//    as bf16 and read once:
//    1. `enc_bwd_stats_sm90`, a persistent grid (a block per SM) over the
//       items of 128 q rows of one (batch, head): Q and dO per item (two
//       buffers at D = 64, so the next item's load overlaps this one),
//       K/V tiles (128 keys at D = 64, else 64) and the bias tiles
//       streamed through a ring that runs on across items; S = Q K^T and dP = dO V^T,
//       s = qscale S + log2(e) bias, each row's online max m,
//       l = sum 2^(s - m) and u = sum 2^(s - m) dp; the statistics m,
//       1 / l and delta = u / l.
//    2. `enc_bwd_dkv_sm90`, a block per (128 keys, or 64 at D = 96 and
//       128: one consumer; head, or every head for a head-broadcast bias;
//       batch group): it loops over its (batch, head) items in order, K and
//       V of each loaded once, 64-row tiles of q and dO streamed with their
//       rows' statistics and bias tiles; S^T = K Q^T, dP^T = V dO^T,
//       p^T = 2^(s - m) / l, ds^T = p^T (dp^T - delta) in fp32; dV += P^T dO
//       and dK += dS^T Q with p and ds as bf16 A operands; while those run,
//       ds to the bf16 plane (exactly the TPU kernel's rounded `dsl`) and
//       the unrounded ds into the block's dbias tile: [keys, T] fp32 in
//       shared memory, where it fits (T <= 232 at D = 64), over all the
//       block's items in order, then written once; else read, added and
//       written in the block's own rows of the global plane, also in item
//       order. (Added inside the element loop, the tile's stores stalled
//       every later shared load of the loop: a third of the launch.)
//    3. `enc_bwd_dq_sm90`, a persistent grid (two blocks an SM at D = 64)
//       over the 128-row items: dq = scale dS K over the bf16 ds plane,
//       64-key K and ds tiles streamed through one ring across items.
//    4. `enc_bwd_dbias_sum_kernel`, only when more than one batch group
//       sums a batch-broadcast dbias: the groups' planes in group order.
//    The batch groups are ops/flash_attention.py's `enc_bwd_plan`: about
//    two dk/dv blocks an SM, so at BEiT-B 11 groups of 24 batch items and
//    20.5 MB of partial planes (the first design's one group per batch
//    item wrote and read back 477 MB). The bias and ds rows hold S bf16
//    (394 bytes at S = 197, 2-byte aligned), so no TMA map takes them: the
//    producer warpgroups stage their tiles by 16-byte cp.async
//    (hopper.cuh `stage_plane`); ds is written with 2-byte stores in the
//    accumulators' fragment layout.
//  - fp32 inputs (encoder_attention_bwd.cuh, which the fp32 path of
//    csrc/doc_attention_bwd.cu shares with a key-padding mask): fp32 CUDA
//    cores, two launches: launch 1 (a block per 64-row q tile, head or
//    every head, batch group) sweeps the key tiles twice, for the exact
//    row statistics, then for p, ds, dbias and dq; launch 2 (a block per
//    64-key tile, head, batch) recomputes p and ds for dk and dv; then
//    launch 4 as above. 8 warps per block.

#include <cmath>

#include "encoder_attention_bwd.cuh"
#include "hopper.cuh"

namespace {

using enc_bwd::LOG2E;

// ---------------------------------------------------------------------------
// dbias = the sum of the groups' partial planes, in group order.
// ---------------------------------------------------------------------------
__global__ void enc_bwd_dbias_sum_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, size_t n, int groups) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float s = part[i];
        for (int g = 1; g < groups; ++g) s += part[(size_t)g * n + i];
        out[i] = s;
    }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the Hopper kernels
// ---------------------------------------------------------------------------
namespace hop {

constexpr int ROWS = 64;  // rows of a consumer's tile (wgmma M) and of a streamed tile
// 384-thread blocks; a producer at 56 spilled in launch 2 (its item loop)
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
constexpr int SMEM_MAX = 232448;

using sm90::afrag;
using sm90::bf_lo;
using sm90::Plane;
using sm90::rs_product;
using sm90::ss_product;
using sm90::stage_off;
using sm90::stage_plane;
using sm90::tile_bits;

struct Params {
    const bf16 *q, *k, *v, *dout, *bias;
    bf16 *dq, *dk, *dv, *ds;  // ds: the [B, H, T, S] plane launch 2 writes and launch 3 reads
    float* dbias;   // the fp32 planes launch 2 writes (dbias or the group partials), or null
    float* stats;   // [3][B][H][T]: row max m (exp2 domain), 1 / l, delta
    int B, T, S, H, bias_sb, bias_sh;
    size_t db_sz;   // element stride of the dbias planes per batch group
    size_t db_sh;   // ... and per head (0: the heads share one plane)
    int group;      // batch items per dk/dv block (> 1 only for a batch-summed dbias)
    int head_sum;   // dbias summed over heads: a dk/dv block loops over every head
    int tp;         // row stride (fp32) of the dbias tile in shared memory; 0: none
    float scale, qscale;  // scale and scale * log2(e)
};

// the dbias tile's fp32 pairs, addressed in the shared window: generic
// loads and stores would be ordered against the ds plane's global stores
__device__ __forceinline__ float2 lds2(uint32_t a) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
    return v;
}
__device__ __forceinline__ void sts2(uint32_t a, float2 v) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(v.x), "f"(v.y));
}

__device__ __forceinline__ size_t bias_base(const Params& p, int b, int h) {
    return (size_t)b * p.bias_sb + (size_t)h * p.bias_sh;
}
__device__ __forceinline__ size_t ds_base(const Params& p, int b, int h) {
    return ((size_t)b * p.H + h) * p.T * p.S;
}

// ---- launch 1: row statistics ------------------------------------------------
//
// A persistent grid (a block per SM) over the (128 q rows, batch, head)
// items, in grid-stride order, so that neighbouring blocks share their
// (batch, head)'s K and V through L2. A block has two consumer warpgroups
// of 64 rows. The producer warpgroup TMA-loads each item's Q and dO (two
// buffers at D = 64: the next item's arrive while this one is computed)
// and streams K/V tiles (128 keys at D = 64, else 64) and the matching
// bias tiles through a ring that runs on across items; per tile the consumers take
// S = Q K^T and dP = dO V^T (SS wgmma), form s = qscale S + log2(e) bias
// and update the rows' online max m, sum l = sum 2^(s - m) and
// u = sum 2^(s - m) dp. The quad merges its partial statistics in a fixed
// butterfly; stats gets m, 1 / l and delta = u / l.

template <int D> struct StatGeo : sm90::Cols<D> {
    static constexpr int NCW = 2;
    static constexpr int BQ = ROWS * NCW;          // q rows per item
    static constexpr int BK = D == 64 ? 128 : 64;  // keys per tile (64 at D = 96, 128: registers)
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NQB = D == 64 ? 2 : 1;    // Q/dO buffers
    static constexpr int NST = BK == 128 ? 2 : D == 128 ? 3 : 4;  // stages of the ring
    static constexpr int Q_BYTES = BQ * D * 2;     // Q, then dO
    static constexpr int KV_BYTES = BK * D * 2;    // one K or one V tile
    static constexpr int B_BYTES = BQ * Plane<BK>::BYTES_PER_ROW;  // a bias tile
    static constexpr int OFF_K = NQB * 2 * Q_BYTES;  // stage s: K, then V
    static constexpr int OFF_B = OFF_K + NST * 2 * KV_BYTES;      // [NST] bias tiles
    // q_full[NQB], q_empty[NQB], full[NST], empty[NST]
    static constexpr int OFF_BAR = OFF_B + NST * B_BYTES;
    static constexpr int SMEM = OFF_BAR + 2 * (NQB + NST) * 8 + 1024;
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= SMEM_MAX, "shared memory");
};

// item idx of a launch over 128-row q tiles: (batch, head, first row), the
// tiles of one (batch, head) neighbours
struct Item {
    int b, h, q0;
};
__device__ __forceinline__ Item item_of(const Params& p, int idx, int ntiles, int rows) {
    const int bh = idx / ntiles;
    return {bh / p.H, bh % p.H, (idx % ntiles) * rows};
}

template <int D>
__device__ __forceinline__ void stats_producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                               const CUtensorMap* tk, const CUtensorMap* tv,
                                               const Params& p, uint8_t* smem) {
    using G = StatGeo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* q_full = bars;
    uint64_t* q_empty = bars + G::NQB;
    uint64_t* full = bars + 2 * G::NQB;
    uint64_t* empty = full + G::NST;
    const int t = threadIdx.x;
    if (t == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tdo);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
    }
    const int ntiles = (p.T + G::BQ - 1) / G::BQ, total = ntiles * p.B * p.H;
    const int nk = (p.S + G::BK - 1) / G::BK;
    for (int it = 0, idx = blockIdx.x, g = 0; idx < total; ++it, idx += gridDim.x) {
        const Item x = item_of(p, idx, ntiles, G::BQ);
        const int qb = it % G::NQB;
        if (t == 0) {
            // this buffer's last item done with its Q and dO
            if (it >= G::NQB) sm90::mbar_wait(&q_empty[qb], (it / G::NQB - 1) & 1);
            sm90::mbar_arrive_expect_tx(&q_full[qb], 2 * G::Q_BYTES);
            uint8_t* qst = smem + qb * 2 * G::Q_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(qst + c * G::BQ * G::CB, tq, &q_full[qb], c * G::CW, x.h,
                                  x.q0, x.b);
                sm90::tma_load_4d(qst + G::Q_BYTES + c * G::BQ * G::CB, tdo, &q_full[qb],
                                  c * G::CW, x.h, x.q0, x.b);
            }
        }
        const size_t base = bias_base(p, x.b, x.h);
        for (int j = 0; j < nk; ++j, ++g) {
            const int s = g % G::NST;
            if (g >= G::NST) sm90::mbar_wait(&empty[s], (g / G::NST - 1) & 1);
            if (p.bias)
                stage_plane<G::BQ, G::BK>(
                    reinterpret_cast<uint32_t*>(smem + G::OFF_B + s * G::B_BYTES), p.bias, base,
                    p.S, p.T, x.q0, j * G::BK, t);
            sm90::cp_async_arrive(&full[s]);
            if (t == 0) {
                sm90::mbar_arrive_expect_tx(&full[s], 2 * G::KV_BYTES);
                uint8_t* kst = smem + G::OFF_K + 2 * s * G::KV_BYTES;
#pragma unroll
                for (int c = 0; c < G::NC; ++c) {
                    sm90::tma_load_4d(kst + c * G::BK * G::CB, tk, &full[s], c * G::CW, x.h,
                                      j * G::BK, x.b);
                    sm90::tma_load_4d(kst + G::KV_BYTES + c * G::BK * G::CB, tv, &full[s],
                                      c * G::CW, x.h, j * G::BK, x.b);
                }
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void stats_consumer(const Params& p, uint8_t* smem, int cw) {
    using G = StatGeo<D>;
    constexpr int BK = G::BK, NN = BK / 8;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* q_full = bars;
    uint64_t* q_empty = bars + G::NQB;
    uint64_t* full = bars + 2 * G::NQB;
    uint64_t* empty = full + G::NST;

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const bool has_bias = p.bias != nullptr;
    const size_t plane = (size_t)p.B * p.H * p.T;
    const int ntiles = (p.T + G::BQ - 1) / G::BQ, total = ntiles * p.B * p.H;
    const int nk = (p.S + BK - 1) / BK;
    for (int it = 0, idx = blockIdx.x, g = 0; idx < total; ++it, idx += gridDim.x) {
        const Item x = item_of(p, idx, ntiles, G::BQ);
        const int qb = it % G::NQB;
        const int row0 = x.q0 + cw * ROWS;  // this consumer's first query row
        const bool live = row0 < p.T;
        const int tl[2] = {row0 + 16 * w + r8, row0 + 16 * w + r8 + 8};  // this thread's rows
        const size_t base = bias_base(p, x.b, x.h);
        int boff[2];  // the rows' offsets in the staged bias tiles (c0 a multiple of 64)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) boff[hh] = stage_off(base, tl[hh], p.S, 0);

        sm90::mbar_wait(&q_full[qb], (it / G::NQB) & 1);
        const uint32_t q_base = smem_addr(smem + qb * 2 * G::Q_BYTES) + cw * ROWS * G::CB;
        const uint32_t do_base = q_base + G::Q_BYTES;
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
        for (int j = 0; j < nk; ++j, ++g) {
            const int s = g % G::NST;
            sm90::mbar_wait(&full[s], (g / G::NST) & 1);
            if (live) {
                const int c0 = j * BK;
                const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
                const uint32_t v_base = k_base + G::KV_BYTES;
                const uint32_t* btile =
                    reinterpret_cast<const uint32_t*>(smem + G::OFF_B + s * G::B_BYTES);
                float sc[BK / 2], dp[BK / 2];
                sm90::wgmma_fence();
                ss_product<D, G::BQ, BK, BK>(sc, q_base, k_base);
                ss_product<D, G::BQ, BK, BK>(dp, do_base, v_base);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();

                // s in the exp2 domain: qscale q k^T + log2(e) bias; past S
                // -inf; then the online statistics of the two rows
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int r = tl[hh] - x.q0;
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int k = 8 * nn + 2 * quad + e, i = 4 * nn + 2 * hh + e;
                            const float bv =
                                has_bias ? bf_lo(tile_bits<BK>(btile, r, k + boff[hh])) : 0.f;
                            sc[i] = c0 + k >= p.S ? -INFINITY
                                                  : fmaf(sc[i], p.qscale, LOG2E * bv);
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
                            const float y = sm90::ex2(sc[i] - mt);
                            ls += y;
                            us += y * dp[i];
                        }
                    l[hh] = l[hh] * a + ls;
                    u[hh] = u[hh] * a + us;
                    m[hh] = mt;
                }
            }
            sm90::mbar_arrive(&empty[s]);
        }
        sm90::mbar_arrive(&q_empty[qb]);  // Q and dO free for the item after next

        // merge the quad's statistics (a fixed butterfly) and write them
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
                const size_t ri = ((size_t)x.b * p.H + x.h) * p.T + tl[hh];
                p.stats[ri] = m[hh];
                p.stats[plane + ri] = 1.f / l[hh];
                p.stats[2 * plane + ri] = u[hh] / l[hh];
            }
        }
    }
}

template <int D>
__global__ void __launch_bounds__(StatGeo<D>::THREADS, 1)
enc_bwd_stats_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
    using G = StatGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        for (int i = 0; i < G::NQB; ++i) {
            sm90::mbar_init(&bars[i], 1);                           // Q and dO loaded
            sm90::mbar_init(&bars[G::NQB + i], 128 * G::NCW);      // Q and dO read
        }
        for (int s = 0; s < G::NST; ++s) {
            // stage s loaded: the producer warpgroup's copies, then the TMA
            sm90::mbar_init(&bars[2 * G::NQB + s], 128 + 1);
            sm90::mbar_init(&bars[2 * G::NQB + G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        stats_producer<D>(&tq, &tdo, &tk, &tv, p, smem);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        stats_consumer<D>(p, smem, wg - 1);
    }
}

// ---- launch 2: dk, dv, the ds plane and dbias -------------------------------
//
// A block per (key block, head or every head, batch group): 128 keys (64 at
// D = 96 and 128: one consumer warpgroup). It takes its (batch, head) items
// in order, batch-major; for each, K and V by TMA (the producer waits until
// the consumers are done with the previous item's), then the 64-row tiles
// of q and dO (TMA), their rows' statistics and the [64, keys] bias tiles
// (cp.async) through a ring that runs on across items. A consumer takes
// S^T = K Q^T and dP^T = V dO^T (SS wgmma), p^T = 2^(s - m) / l and
// ds^T = p^T (dp^T - delta) in fp32, writes ds as bf16 into the plane
// (rows < T, keys < S), adds the fp32 ds into its dbias tile, and takes
// dV += P^T dO and dK += dS^T Q with p and ds rounded to bf16 as the A
// operands (RS wgmma, Q and dO through the transpose bit). With tp > 0 the
// dbias tile is [64 keys, tp] fp32 in shared memory (rows t and t + 1 of a
// key adjacent; tp = 8 mod 32 words, so a warp's float2 accesses fall on
// distinct banks), zeroed first and written to the block's plane once at
// the end; with tp = 0 the block's rows of the global plane are written
// by its first item and read, added and written by the next ones.

template <int D> struct DkvGeo : sm90::Cols<D> {
    static constexpr int NCW = D == 64 ? 2 : 1;    // consumer warpgroups of 64 keys
    static constexpr int BKB = ROWS * NCW;          // keys per block
    static constexpr int BQ = 64;                   // q rows per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = D == 64 ? 2 : 3;     // stages of the ring
    static constexpr int KV_BYTES = BKB * D * 2;    // K, then V
    static constexpr int Q_BYTES = BQ * D * 2;      // one q or dO tile
    static constexpr int B_BYTES = BQ * Plane<BKB>::BYTES_PER_ROW;  // a bias tile
    static constexpr int OFF_Q = 2 * KV_BYTES;      // stage s: q, dO
    static constexpr int OFF_B = OFF_Q + NST * 2 * Q_BYTES;   // [NST] bias tiles
    static constexpr int OFF_ST = OFF_B + NST * B_BYTES;      // [NST][3][BQ]: m, 1/l, delta
    static constexpr int OFF_BAR = OFF_ST + NST * 3 * BQ * 4;
    // kv_full, kv_empty, full[NST], empty[NST]; then the dbias tile
    static constexpr int OFF_ACC = OFF_BAR + (2 + 2 * NST) * 8;
    static constexpr int SMEM = OFF_ACC + 1024;     // without the dbias tile
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(OFF_ACC % 16 == 0 && SMEM <= SMEM_MAX, "shared memory");
};

// item n of block z, hh: (batch, head), batch-major
__device__ __forceinline__ void item_bh(const Params& p, int z, int hh, int n, int& b, int& h) {
    if (p.head_sum) {
        b = z * p.group + n / p.H;
        h = n % p.H;
    } else {
        b = z * p.group + n;
        h = hh;
    }
}

template <int D>
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             const Params& p, uint8_t* smem, int z, int hh,
                                             int nitems, int c0) {
    using G = DkvGeo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + G::NST;
    const int t = threadIdx.x;
    const size_t plane = (size_t)p.B * p.H * p.T;
    const int nq = (p.T + G::BQ - 1) / G::BQ;
    if (t == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tdo);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
    }
    for (int n = 0, g = 0; n < nitems; ++n) {
        int b, h;
        item_bh(p, z, hh, n, b, h);
        if (t == 0) {
            // K and V of this item once the consumers are done with the last
            if (n > 0) sm90::mbar_wait(&bars[1], (n - 1) & 1);
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
        const size_t rbase = ((size_t)b * p.H + h) * p.T, base = bias_base(p, b, h);
        for (int i = 0; i < nq; ++i, ++g) {
            const int s = g % G::NST;
            if (g >= G::NST) sm90::mbar_wait(&empty[s], (g / G::NST - 1) & 1);
            float* st = reinterpret_cast<float*>(smem + G::OFF_ST) + s * 3 * G::BQ;
            for (int r = t; r < 3 * G::BQ; r += 128) {
                const int which = r / G::BQ, tr = i * G::BQ + r % G::BQ;
                const bool in = tr < p.T;
                sm90::cp4(st + r, in ? p.stats + which * plane + rbase + tr : p.stats, in ? 4 : 0);
            }
            if (p.bias)
                stage_plane<G::BQ, G::BKB>(
                    reinterpret_cast<uint32_t*>(smem + G::OFF_B + s * G::B_BYTES), p.bias, base,
                    p.S, p.T, i * G::BQ, c0, t);
            sm90::cp_async_arrive(&full[s]);
            if (t == 0) {
                sm90::mbar_arrive_expect_tx(&full[s], 2 * G::Q_BYTES);
                uint8_t* qst = smem + G::OFF_Q + 2 * s * G::Q_BYTES;
#pragma unroll
                for (int c = 0; c < G::NC; ++c) {
                    const int off = c * G::BQ * G::CB;
                    sm90::tma_load_4d(qst + off, tq, &full[s], c * G::CW, h, i * G::BQ, b);
                    sm90::tma_load_4d(qst + G::Q_BYTES + off, tdo, &full[s], c * G::CW, h,
                                      i * G::BQ, b);
                }
            }
        }
    }
}

// one consumer thread's keys in launch 2
struct DkvKeys {
    int quad, kc0;          // the thread's quad; the block's first key
    int kl[2], kc[2];       // its keys, from the consumer's first and absolute
    bool kin[2];            // ... < S
    uint32_t k_base, v_base;  // the consumer's K and V in shared memory
};

// one 64-row q tile of launch 2 (a variant over 16 rows for a last tile
// of at most 16 spilled and ran slower)
template <int D>
__device__ __forceinline__ void dkv_step(const Params& p, const DkvKeys& th, float* dk, float* dv,
                                         uint32_t q_st, uint32_t do_st, const float* st,
                                         const uint32_t* btile, int t0, size_t bbase,
                                         bf16* ds_bh, float* acc, float* db, int n) {
    using G = DkvGeo<D>;
    constexpr int BQ = G::BQ;
    const int quad = th.quad;

    // S^T = K Q^T and dP^T = V dO^T, [keys, rows]: sc[4 nn + 2 hh + e] is
    // key kc[hh], row t0 + 8 nn + 2 quad + e
    float sc[BQ / 2], dp[BQ / 2];
    sm90::wgmma_fence();
    ss_product<D, ROWS, BQ>(sc, th.k_base, q_st);
    ss_product<D, ROWS, BQ>(dp, th.v_base, do_st);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();

    // p^T and ds^T in fp32, both as bf16 A operands; the fp32 ds kept in sc
    // for the plane and the dbias tile
    uint32_t pa[BQ / 4], da[BQ / 4];
#pragma unroll
    for (int nn = 0; nn < BQ / 8; ++nn) {
        const int r = 8 * nn + 2 * quad, tr = t0 + r;
        const float2 m2 = *reinterpret_cast<const float2*>(st + r);
        const float2 rl2 = *reinterpret_cast<const float2*>(st + BQ + r);
        const float2 dl2 = *reinterpret_cast<const float2*>(st + 2 * BQ + r);
        const int o0 = stage_off(bbase, tr, p.S, th.kc0);
        const int o1 = stage_off(bbase, tr + 1, p.S, th.kc0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int i0 = 4 * nn + 2 * hh, kb = th.kc[hh] - th.kc0;
            float x0 = sc[i0] * p.qscale, x1 = sc[i0 + 1] * p.qscale;
            if (p.bias) {
                x0 = fmaf(LOG2E, bf_lo(tile_bits<G::BKB>(btile, r, kb + o0)), x0);
                x1 = fmaf(LOG2E, bf_lo(tile_bits<G::BKB>(btile, r + 1, kb + o1)), x1);
            }
            // past S: p = 0 (a row past T has 1 / l = 0 from the staging)
            const float p0 = th.kin[hh] ? sm90::ex2(x0 - m2.x) * rl2.x : 0.f;
            const float p1 = th.kin[hh] ? sm90::ex2(x1 - m2.y) * rl2.y : 0.f;
            sc[i0] = p0 * (dp[i0] - dl2.x);
            sc[i0 + 1] = p1 * (dp[i0 + 1] - dl2.y);
            pa[afrag(nn, hh)] = pack(p0, p1);
            da[afrag(nn, hh)] = pack(sc[i0], sc[i0 + 1]);
        }
    }

    // dV += P^T dO, dK += dS^T Q; dO and Q are [rows, D], MN-major
    sm90::wgmma_fence();
    rs_product<D>(dv, pa, do_st);
    rs_product<D>(dk, da, q_st);
    sm90::wgmma_commit();

    // while they run: ds to the plane as bf16 (rows < T, keys < S), and the
    // fp32 ds into the block's dbias: the tile (rows t, t + 1 of a key) or
    // the block's rows of the global plane
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (!th.kin[hh]) continue;
        const uint32_t arow = smem_addr(acc + th.kl[hh] * p.tp + t0 + 2 * quad);
#pragma unroll
        for (int nn = 0; nn < BQ / 8; ++nn) {
            const int i0 = 4 * nn + 2 * hh, tr = t0 + 8 * nn + 2 * quad;
            if (tr >= p.T) continue;
            const uint32_t dd = pack(sc[i0], sc[i0 + 1]);
            unsigned short* dst =
                reinterpret_cast<unsigned short*>(ds_bh + (size_t)tr * p.S + th.kc[hh]);
            dst[0] = (unsigned short)(dd & 0xffffu);
            if (tr + 1 < p.T) dst[p.S] = (unsigned short)(dd >> 16);
            if (acc) {
                float2 v = lds2(arow + 32 * nn);
                v.x += sc[i0];
                v.y += sc[i0 + 1];
                sts2(arow + 32 * nn, v);
            } else if (db) {
                float* d = db + (size_t)tr * p.S + th.kc[hh];
                d[0] = n == 0 ? sc[i0] : d[0] + sc[i0];
                if (tr + 1 < p.T) d[p.S] = n == 0 ? sc[i0 + 1] : d[p.S] + sc[i0 + 1];
            }
        }
    }
    sm90::wgmma_wait<0>();
}

template <int D>
__device__ __forceinline__ void dkv_consumer(const Params& p, uint8_t* smem, int cw, int z,
                                             int hh_blk, int nitems, int kc0) {
    using G = DkvGeo<D>;
    constexpr int BQ = G::BQ;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + G::NST;

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int c0 = kc0 + cw * ROWS;  // this consumer's first key
    const bool live = c0 < p.S;
    DkvKeys th;
    th.quad = quad;
    th.kc0 = kc0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        th.kl[hh] = 16 * w + r8 + 8 * hh;  // this thread's keys, from c0
        th.kc[hh] = c0 + th.kl[hh];
        th.kin[hh] = th.kc[hh] < p.S;
    }
    th.k_base = smem_addr(smem) + cw * ROWS * D * 2;
    th.v_base = th.k_base + G::KV_BYTES;
    const int (&kc)[2] = th.kc;
    const bool (&kin)[2] = th.kin;
    const int nq = (p.T + BQ - 1) / BQ;
    // this consumer's dbias tile in shared memory, [64 keys][tp] fp32
    // (tp > 0 only where a dbias is summed on chip)
    float* acc = p.tp ? reinterpret_cast<float*>(smem + G::OFF_ACC) + cw * ROWS * p.tp : nullptr;
    if (acc) {
        for (int i = t; i < ROWS * p.tp; i += 128) acc[i] = 0.f;
        sm90::named_sync(1 + cw, 128);
    }

    for (int n = 0, g = 0; n < nitems; ++n) {
        int b, h;
        item_bh(p, z, hh_blk, n, b, h);
        const size_t bbase = bias_base(p, b, h);
        bf16* ds_bh = p.ds + ds_base(p, b, h);
        float* db = p.dbias && !acc ? p.dbias + (size_t)z * p.db_sz + (size_t)h * p.db_sh
                                    : nullptr;
        float dk[D / 2], dv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

        sm90::mbar_wait(&bars[0], n & 1);
        for (int i = 0; i < nq; ++i, ++g) {
            const int s = g % G::NST;
            sm90::mbar_wait(&full[s], (g / G::NST) & 1);
            if (live) {
                const int t0 = i * BQ;
                const uint32_t q_st = smem_addr(smem + G::OFF_Q + 2 * s * G::Q_BYTES);
                const uint32_t do_st = q_st + G::Q_BYTES;
                const float* st = reinterpret_cast<const float*>(smem + G::OFF_ST) + s * 3 * BQ;
                const uint32_t* btile =
                    reinterpret_cast<const uint32_t*>(smem + G::OFF_B + s * G::B_BYTES);

                dkv_step<D>(p, th, dk, dv, q_st, do_st, st, btile, t0, bbase, ds_bh, acc, db, n);
            }
            sm90::mbar_arrive(&empty[s]);
        }
        sm90::mbar_arrive(&bars[1]);  // K and V free for the next item

        bf16* dkp = p.dk;
        bf16* dvp = p.dv;
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

    // the dbias tile to the block's plane: rows < T, keys < S
    if (acc && live) {
        sm90::named_sync(1 + cw, 128);
        float* db = p.dbias + (size_t)z * p.db_sz + (size_t)hh_blk * p.db_sh;
        const int nk = min(ROWS, p.S - c0);
        for (int i = t; i < p.T * ROWS; i += 128) {
            const int tr = i / ROWS, k = i % ROWS;
            if (k < nk) db[(size_t)tr * p.S + c0 + k] = acc[k * p.tp + tr];
        }
    }
}

template <int D>
__global__ void __launch_bounds__(DkvGeo<D>::THREADS, 1)
enc_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const Params p) {
    using G = DkvGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    // block -> (key block, head or every head, batch group)
    const int nkb = (p.S + G::BKB - 1) / G::BKB, HH = p.head_sum ? 1 : p.H;
    const int kb = blockIdx.x % nkb, rest = blockIdx.x / nkb;
    const int hh = rest % HH, z = rest / HH;
    const int nitems = min(p.group, p.B - z * p.group) * (p.head_sum ? p.H : 1);

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(&bars[0], 1);               // K and V loaded
        sm90::mbar_init(&bars[1], 128 * G::NCW);   // K and V read
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&bars[2 + s], 128 + 1);                 // stage s loaded
            sm90::mbar_init(&bars[2 + G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_dec<PRODUCER_REGS>();
        dkv_producer<D>(&tq, &tdo, &tk, &tv, p, smem, z, hh, nitems, kb * G::BKB);
    } else {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_inc<CONSUMER_REGS>();
        dkv_consumer<D>(p, smem, wg - 1, z, hh, nitems, kb * G::BKB);
    }
}

// ---- launch 3: dq = scale ds k --------------------------------------------------
//
// A persistent grid (two blocks an SM at D = 64, one at 96 and 128) over
// the (128 q rows, batch, head) items in grid-stride order: two consumer
// warpgroups of 64 rows; the producer warpgroup streams 64-key K tiles
// (TMA) and the matching [128, 64] ds tiles (cp.async) through a ring that
// runs on across items. A consumer packs its ds fragments from the staged
// tile and takes dq += dS K (RS wgmma, K through the transpose bit).

template <int D> struct DqGeo : sm90::Cols<D> {
    static constexpr int NCW = 2;
    static constexpr int BQ = ROWS * NCW;
    static constexpr int BK = ROWS;                // keys per tile (128 spilled)
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int PER_SM = D == 64 ? 2 : 1;  // blocks an SM (89 registers a thread at one)
    static constexpr int NST = 4;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr int S_BYTES = BQ * Plane<BK>::BYTES_PER_ROW;  // a ds tile
    static constexpr int OFF_S = NST * KV_BYTES;
    static constexpr int OFF_BAR = OFF_S + NST * S_BYTES;  // full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + 2 * NST * 8 + 1024;
    static_assert(KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM * PER_SM <= 233472, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(DqGeo<D>::THREADS, DqGeo<D>::PER_SM)
enc_bwd_dq_sm90(const __grid_constant__ CUtensorMap tk, const Params p) {
    using G = DqGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const int ntiles = (p.T + G::BQ - 1) / G::BQ, total = ntiles * p.B * p.H;
    const int nk = (p.S + G::BK - 1) / G::BK;

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
        for (int idx = blockIdx.x, g = 0; idx < total; idx += gridDim.x) {
            const Item x = item_of(p, idx, ntiles, G::BQ);
            const size_t base = ds_base(p, x.b, x.h);
            for (int j = 0; j < nk; ++j, ++g) {
                const int s = g % G::NST;
                if (g >= G::NST) sm90::mbar_wait(&empty[s], (g / G::NST - 1) & 1);
                stage_plane<G::BQ, G::BK>(
                    reinterpret_cast<uint32_t*>(smem + G::OFF_S + s * G::S_BYTES), p.ds, base,
                    p.S, p.T, x.q0, j * G::BK, t);
                sm90::cp_async_arrive(&full[s]);
                if (t == 0) {
                    sm90::mbar_arrive_expect_tx(&full[s], G::KV_BYTES);
#pragma unroll
                    for (int c = 0; c < G::NC; ++c)
                        sm90::tma_load_4d(smem + s * G::KV_BYTES + c * G::BK * G::CB, &tk,
                                          &full[s], c * G::CW, x.h, j * G::BK, x.b);
                }
            }
        }
        return;
    }
    const int cw = wg - 1;
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    for (int idx = blockIdx.x, g = 0; idx < total; idx += gridDim.x) {
        const Item x = item_of(p, idx, ntiles, G::BQ);
        const size_t base = ds_base(p, x.b, x.h);
        const int row0 = x.q0 + cw * ROWS;
        const int tl[2] = {row0 + 16 * w + r8, row0 + 16 * w + r8 + 8};
        int off[2];  // the rows' offsets in the staged ds tiles (c0 a multiple of 64)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) off[hh] = stage_off(base, tl[hh], p.S, 0);
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        for (int j = 0; j < nk; ++j, ++g) {
            const int s = g % G::NST;
            sm90::mbar_wait(&full[s], (g / G::NST) & 1);
            const uint32_t* stile =
                reinterpret_cast<const uint32_t*>(smem + G::OFF_S + s * G::S_BYTES);
            uint32_t da[16];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = tl[hh] - x.q0;
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
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            if (tl[hh] >= p.T) continue;
            bf16* dst = p.dq + (((size_t)x.b * p.T + tl[hh]) * p.H + x.h) * D + 2 * quad;
#pragma unroll
            for (int nn = 0; nn < D / 8; ++nn)
                *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                    pack(acc[4 * nn + 2 * hh] * p.scale, acc[4 * nn + 2 * hh + 1] * p.scale);
        }
    }
}

template <typename K>
cudaError_t prepare(K kern, int smem) {
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The dbias tile's row stride (fp32) in launch 2's shared memory: the
// least tp >= T rounded up to even with tp = 8 mod 32, or 0 where it does
// not fit (ops/flash_attention.py `enc_bwd_plan` mirrors this rule)
template <int D> int acc_stride(int T) {
    using G = DkvGeo<D>;
    const int tp = ((T + 1) / 2 * 2 + 23) / 32 * 32 + 8;
    return G::SMEM + G::BKB * tp * 4 <= SMEM_MAX ? tp : 0;
}

// the three launches (the groups' sum follows in the entry point)
template <int D>
cudaError_t launch(Params p, int groups, cudaStream_t stream) {
    using S1 = StatGeo<D>;
    using S2 = DkvGeo<D>;
    using S3 = DqGeo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap q128, do128, k64, v64, q64, do64, ks1, vs1, ks3;
    if (!sm90::make_map<D>(enc, &q128, p.q, p.B, p.T, p.H, S1::BQ) ||
        !sm90::make_map<D>(enc, &do128, p.dout, p.B, p.T, p.H, S1::BQ) ||
        !sm90::make_map<D>(enc, &k64, p.k, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map<D>(enc, &v64, p.v, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map<D>(enc, &ks1, p.k, p.B, p.S, p.H, S1::BK) ||
        !sm90::make_map<D>(enc, &vs1, p.v, p.B, p.S, p.H, S1::BK) ||
        !sm90::make_map<D>(enc, &ks3, p.k, p.B, p.S, p.H, S3::BK) ||
        !sm90::make_map<D>(enc, &q64, p.q, p.B, p.T, p.H, S2::BQ) ||
        !sm90::make_map<D>(enc, &do64, p.dout, p.B, p.T, p.H, S2::BQ))
        return cudaErrorInvalidValue;
    // a block that sums dbias over more than one item does so on chip
    const bool sums = p.dbias && (p.group > 1 || p.head_sum);
    p.tp = sums ? acc_stride<D>(p.T) : 0;
    const int smem2 = S2::SMEM + S2::BKB * p.tp * 4;
    cudaError_t err;
    if ((err = prepare(enc_bwd_stats_sm90<D>, S1::SMEM)) != cudaSuccess ||
        (err = prepare(enc_bwd_dkv_sm90<D>, smem2)) != cudaSuccess ||
        (err = prepare(enc_bwd_dq_sm90<D>, S3::SMEM)) != cudaSuccess)
        return err;
    int dev, sms;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    // launches 1 and 3: persistent grids over the 128-row items
    const int items = (p.T + S1::BQ - 1) / S1::BQ * p.B * p.H;
    enc_bwd_stats_sm90<D><<<min(items, sms), S1::THREADS, S1::SMEM, stream>>>(q128, do128, ks1,
                                                                              vs1, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int nkb = (p.S + S2::BKB - 1) / S2::BKB;
    enc_bwd_dkv_sm90<D><<<nkb * (p.head_sum ? 1 : p.H) * groups, S2::THREADS, smem2, stream>>>(
        q64, do64, k64, v64, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    enc_bwd_dq_sm90<D><<<min(items, S3::PER_SM * sms), S3::THREADS, S3::SMEM, stream>>>(ks3, p);
    return cudaGetLastError();
}

}  // namespace hop

cudaError_t dispatch_d(int D, int dtype, const enc_bwd::Params& e, bf16* ds, int groups,
                       cudaStream_t st) {
    if (dtype == 0) {
        switch (D) {
            case 64: return enc_bwd::launch_fp32<64>(e, groups, st);
            case 96: return enc_bwd::launch_fp32<96>(e, groups, st);
            case 128: return enc_bwd::launch_fp32<128>(e, groups, st);
            default: return cudaErrorInvalidValue;
        }
    }
    if (!ds) return cudaErrorInvalidValue;
    const hop::Params p{static_cast<const bf16*>(e.q),    static_cast<const bf16*>(e.k),
                        static_cast<const bf16*>(e.v),    static_cast<const bf16*>(e.dout),
                        static_cast<const bf16*>(e.bias), static_cast<bf16*>(e.dq),
                        static_cast<bf16*>(e.dk),         static_cast<bf16*>(e.dv),
                        ds,                               e.dbias,
                        e.stats,                          e.B,
                        e.T,                              e.S,
                        e.H,                              e.bias_sb,
                        e.bias_sh,                        e.db_sz,
                        e.db_sh,                          e.group,
                        e.head_sum,                       0,
                        e.scale,                          e.qscale};
    switch (D) {
        case 64: return hop::launch<64>(p, groups, st);
        case 96: return hop::launch<96>(p, groups, st);
        case 128: return hop::launch<128>(p, groups, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `scale` multiplies q k^T. dbias may be
// null (no bias, or its gradient not wanted). A [1, Hb, T, S] bias with
// B > 1 has its gradient summed over the batch in groups of `group` batch
// items (a bf16 dk/dv block or an fp32 dq block each); with more than one
// group `partial` ([ceil(B / group), Hb, T, S] fp32) takes the groups'
// planes and a last launch adds them into dbias, with one group partial is
// null and the blocks write dbias itself. Otherwise `group` is 1 and
// partial null. `head_sum` (a [., 1, T, S] bias, H > 1) makes a block sum
// the heads. `stats` is [3, B, H, T] fp32 scratch; `ds` is [B, H, T, S]
// bf16 scratch for bf16 inputs (null for fp32). Returns cudaGetLastError()
// after the last launch.
int encoder_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                     const void* bias, void* dq, void* dk, void* dv, void* dbias, void* partial,
                     void* stats, void* ds, int B, int T_, int S, int H, int D, int bias_sb,
                     int bias_sh, int bias_h, int group, int head_sum, float scale, int dtype,
                     void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    // a [1, Hb, T, S] bias's gradient over B > 1 is summed over the batch
    const bool batch_sum = dbias && bias_sb == 0 && B > 1;
    if (S <= 0 || group <= 0 || (dbias && !bias) || (group > 1 && !batch_sum) ||
        (head_sum && (!dbias || bias_h != 1)) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    const int groups = (B + group - 1) / group;
    // partial planes exactly when more than one group sums the batch
    if ((partial != nullptr) != (batch_sum && groups > 1)) return (int)cudaErrorInvalidValue;
    const size_t TS = (size_t)T_ * S;
    const enc_bwd::Params e{q, k, v, dout, bias, nullptr, dq, dk, dv,
                            static_cast<float*>(partial ? partial : dbias),
                            static_cast<float*>(stats), B, T_, S, H, bias_sb, bias_sh,
                            bias_h * TS, bias_h > 1 ? TS : 0, group, head_sum, scale,
                            scale * LOG2E};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = dispatch_d(D, dtype, e, static_cast<bf16*>(ds), groups, st);
    if (err != cudaSuccess || !partial) return (int)err;
    const size_t n = (size_t)bias_h * T_ * S;
    const int blocks = (int)((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056);
    enc_bwd_dbias_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                                     static_cast<float*>(dbias), n, groups);
    return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
