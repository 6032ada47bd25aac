// Flash attention backward in one pass for Hopper (sm_90a), plain C
// interface: dq, dk and dv from one recompute of the probabilities.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_bwd_fused_kernel` (:1520),
// launched by `_flash_backward_fused` (:1633) from the custom VJP
// `_flash_bwd` (:1920) when there is no bias and UNILM_TPU_FUSED_BWD is set
// (:1944). Same contract as the split pair #6/#7 (csrc/flash_bwd.cu)
// without the bias: q pre-scaled (dk is the gradient of the unscaled k),
// p = exp(s - lse) under causal with a query offset, sliding window, the
// valid-kv prefix `limit` and the int32 key-padding mask; dp = dO v^T;
// ds = p (dp - delta) in fp32 with delta from the caller: rowsum(dO * out)
// in fp32 and, in bf16, rowsum(p dp) from #6's delta sweep launched alone
// (csrc/flash_bwd.cu `flash_bwd_delta`), since a delta taken from the bf16
// out loses a near-uniform row's q and k gradients; ds rounded to the
// inputs' type before ds k and ds^T q (:1598-
// 1611); dv += p^T dO. Key tiles wholly outside the causal / window /
// limit band are skipped; a fully masked row contributes nothing.
//
// The TPU kernel walks a (B, H, nq, nk) grid in order on one core and keeps
// dk and dv for a whole (batch, head) resident in VMEM; it needs no
// ordering for dq because dq[i] accumulates across the inner j loop. On the
// H100 blocks run in parallel. Schedule taken here: one block per key block
// j of one (batch, head) keeps dk_j and dv_j in fp32 registers and walks
// the 64-row q tiles that see j, and for each recomputes s and p, adds
// p^T dO to dv, computes dp and ds, adds ds^T q to dk and forms its part
// ds k_j of dq: five products per tile pair against the split pair's
// seven, and one pass over q, k, v and dO where the split pair makes two.
//
// dq: several key blocks add into one dq row tile. They add into an fp32
// accumulator [B, T, H, D], zeroed here per call, in a fixed order: the
// block of key block j adds its part to a row tile after the blocks of key
// blocks j+1 .. end-1 (every later key block that sees the tile) have added
// theirs, counted by one turn counter per (batch, head, row tile) (acquire
// loads, a release add; no float atomics). Key blocks run on the grid
// reversed, so a block waits only on blocks of lower linear index,
// dispatched before it: no deadlock. Descending j is the order in which
// causal blocks reach a row tile when each walks its tiles upward, so the
// turns rarely stall on the causal path. A bf16 call ends with a second
// kernel that casts the accumulator to dq; an fp32 call accumulates in dq
// itself. Two runs on the same inputs give the same bits.
//
// What bounds it on the H100: at the train shape (B=2, T=S=2048, H=32,
// D=64, causal, bf16) the five products are 5 * B * H * T^2 * D / 2 =
// 8.6e10 operations over the lower triangle, 0.087 ms at 989 TFLOP/s,
// against 118 MB of q, k, v, dO, lse, delta in and dq, dk, dv out, 0.035
// ms at 3.35 TB/s: bound by the tensor cores.
//  - bf16 (namespace hop, `flash_bwd_fused_sm90`): #7's dk/dv block
//    (csrc/flash_bwd.cu `flash_bwd_dkv_sm90`) with the fifth product. A
//    block takes 128 keys at D = 32 and 64 (two consumer warpgroups of 64 keys,
//    setmaxnreg 232), 64 keys and one consumer at D = 96 and 128; K and V
//    stay resident. Producer warp 0 streams 64-row Q/dO tiles by a TMA
//    ring with each tile's lse and delta by 4-byte cp.async (the walk of
//    flash_common.cuh `q_walk`, `tile_interior` for the predicate-free
//    body). A consumer takes S^T = K Q^T and dP^T = V dO^T (SS wgmma),
//    dV += P^T dO and dK += dS^T Q (RS wgmma, p and ds as bf16 A
//    operands), and writes its bf16 dS^T fragments into a shared [keys,
//    64 rows] tile with the 128-byte swizzle. Then one consumer (the two
//    alternate steps at D = 64) takes dQ_step [64 rows, D] = dS K_block as
//    one SS wgmma chain with both operands read through the transpose
//    bits, writes the fp32 tile to shared memory (D / 32 swizzled boxes)
//    and hands it to a writer warp of the producer warpgroup (warps 1 and
//    2, alternate tiles): it waits for the row tile's turn, adds the tile
//    into the accumulator with one bulk reduce-add (cp.reduce.async.bulk
//    .tensor, performed in L2, rows past T left out), waits for the write
//    to complete and passes the turn. The consumers never wait on a turn
//    themselves unless every dq tile buffer is in flight. The walk and the
//    turn order are ops/flash_attention.py's `fused_bwd_plan`
//    (tests/test_torch_fused_bwd_plan.py). The earlier design (mma.sync, a
//    block per 64 keys, ds k through shared memory per warp, the dq turns
//    taken by the whole block with L2 loads and stores) took 1.2421 ms at
//    the train shape with delta and the dq cast (chip_smoke.py's
//    flash_bwd_fused phase, H100 80GB HBM3, 700 W).
//  - fp32: #7's CUDA-core dk/dv body (csrc/flash_bwd.cuh) with FUSED set:
//    the same block adds ds k from its shared-memory ds plane into dq, in
//    turn; exact fp32 products.

#include <cmath>

#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

namespace hop {

constexpr int ROWS = 64;  // q rows per step (the dq product's M), keys per consumer
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 384-thread blocks
constexpr float LOG2E = 1.4426950408889634f;

using sm90::afrag;

// the geometry `fused_bwd_plan` mirrors
template <int D> struct FusedGeo : sm90::Cols<D> {
    static constexpr int NCW = D <= 64 ? 2 : 1;    // consumer warpgroups of 64 keys
    static constexpr int BKB = ROWS * NCW;          // keys per block
    static constexpr int BQ = ROWS;                 // q rows per step
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = D == 128 ? 3 : 4;    // stages of the Q/dO ring
    static constexpr int NDQ = D <= 64 ? 4 : 2;     // dq tile buffers
    static constexpr int NWR = 2;                   // writer warps (producer warps 1, 2)
    static constexpr int KV_BYTES = BKB * D * 2;    // K, then V: a [64, D] tile per consumer
    static constexpr int Q_BYTES = BQ * D * 2;      // one Q or one dO tile
    static constexpr int DS_BYTES = BKB * BQ * 2;   // dS^T [keys, rows] bf16
    static constexpr int DQ_BYTES = BQ * D * 4;     // fp32 [rows, D] as D / 32 boxes
    static constexpr int OFF_Q = 2 * KV_BYTES;      // stage s: Q, then dO
    static constexpr int OFF_DS = OFF_Q + NST * 2 * Q_BYTES;  // [2] dS^T tiles
    static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;      // [NDQ] dq tiles
    static constexpr int OFF_LD = OFF_DQ + NDQ * DQ_BYTES;    // [NST][2][BQ]: lse, delta
    // kv_full, full[NST], empty[NST], ds_full[2], ds_empty[2], dq_full[NDQ],
    // dq_empty[NDQ]
    static constexpr int OFF_BAR = OFF_LD + NST * 2 * BQ * 4;
    static constexpr int NBAR = 1 + 2 * NST + 4 + 2 * NDQ;
    static constexpr int SMEM = OFF_BAR + NBAR * 8 + 1024;  // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0 && DS_BYTES % 1024 == 0 &&
                      DQ_BYTES % 1024 == 0,
                  "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

template <int D> struct Bars {
    using G = FusedGeo<D>;
    uint64_t *kv_full, *full, *empty, *ds_full, *ds_empty, *dq_full, *dq_empty;
    __device__ explicit Bars(uint8_t* smem) {
        uint64_t* b = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
        kv_full = b;
        full = b + 1;
        empty = full + G::NST;
        ds_full = empty + G::NST;
        ds_empty = ds_full + 2;
        dq_full = ds_empty + 2;
        dq_empty = dq_full + G::NDQ;
    }
};

// A block's (batch, head) and key block j: the key blocks run on the grid
// reversed, the highest first, so that the blocks a turn waits on have
// lower linear indices
struct Block {
    int b, h, j;
};
template <int D> __device__ __forceinline__ Block block_of(const Params& p) {
    const int BH = p.B * p.H, nkb = (p.S + FusedGeo<D>::BKB - 1) / FusedGeo<D>::BKB;
    const int bh = blockIdx.x % BH;
    return {bh / p.H, bh % p.H, nkb - 1 - (int)blockIdx.x / BH};
}

// the q tiles [ib, ie) of the block's walk
template <int D> __device__ __forceinline__ void block_walk(const Params& p, int c0, int& ib, int& ie) {
    using G = FusedGeo<D>;
    q_walk<G::BQ>(c0, c0 + G::BKB - 1, p.T, p.q_offset, p.limit, p.causal, p.window, ib, ie);
}

template <int D>
__device__ __forceinline__ void loader(const CUtensorMap* tq, const CUtensorMap* tdo,
                                       const CUtensorMap* tk, const CUtensorMap* tv,
                                       const Params& p, uint8_t* smem, const Block& blk) {
    using G = FusedGeo<D>;
    Bars<D> bars(smem);
    float* lds = reinterpret_cast<float*>(smem + G::OFF_LD);
    const int lane = threadIdx.x & 31, b = blk.b, h = blk.h, c0 = blk.j * G::BKB;
    if (lane == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tdo);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
        sm90::mbar_arrive_expect_tx(bars.kv_full, 2 * G::KV_BYTES);
#pragma unroll
        for (int cw = 0; cw < G::NCW; ++cw)
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                uint8_t* kt = smem + cw * ROWS * D * 2 + c * ROWS * G::CB;
                sm90::tma_load_4d(kt, tk, bars.kv_full, c * G::CW, h, c0 + cw * ROWS, b);
                sm90::tma_load_4d(kt + G::KV_BYTES, tv, bars.kv_full, c * G::CW, h,
                                  c0 + cw * ROWS, b);
            }
    }
    int ib, ie;
    block_walk<D>(p, c0, ib, ie);
    const size_t rbase = ((size_t)b * p.H + h) * p.T;
    for (int i = ib, n = 0; i < ie; ++i, ++n) {
        const int s = n % G::NST;
        if (n >= G::NST) sm90::mbar_wait(&bars.empty[s], (n / G::NST - 1) & 1);
        // the tile's lse and delta by 4-byte cp.async (zeros past T): a
        // plain load here would hold the ring to one memory latency a step
        float* ld = lds + s * 2 * G::BQ;
        for (int r = lane; r < G::BQ; r += 32) {
            const int tr = i * G::BQ + r;
            const bool in = tr < p.T;
            sm90::cp4(ld + r, in ? p.lse + rbase + tr : p.lse, in ? 4 : 0);
            sm90::cp4(ld + G::BQ + r, in ? p.delta + rbase + tr : p.delta, in ? 4 : 0);
        }
        sm90::cp_async_arrive(&bars.full[s]);  // every lane, once its copies land
        if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&bars.full[s], 2 * G::Q_BYTES);
            uint8_t* qst = smem + G::OFF_Q + 2 * s * G::Q_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(qst + c * G::BQ * G::CB, tq, &bars.full[s], c * G::CW, h,
                                  i * G::BQ, b);
                sm90::tma_load_4d(qst + G::Q_BYTES + c * G::BQ * G::CB, tdo, &bars.full[s],
                                  c * G::CW, h, i * G::BQ, b);
            }
        }
    }
}

// Lane 0 of writer warp `wr` (0 .. NWR - 1): the dq tiles of steps wr,
// wr + NWR, ..., each added into the accumulator in its row tile's turn.
template <int D>
__device__ __forceinline__ void writer(const CUtensorMap* tdq, const Params& p, uint8_t* smem,
                                       const Block& blk, int wr) {
    using G = FusedGeo<D>;
    Bars<D> bars(smem);
    if (wr == 0) sm90::prefetch_tensormap(tdq);
    int ib, ie;
    block_walk<D>(p, blk.j * G::BKB, ib, ie);
    const int nrt = (p.T + G::BQ - 1) / G::BQ;
    int* turns = p.turns + ((size_t)blk.b * p.H + blk.h) * nrt;
    for (int n = wr; ib + n < ie; n += G::NWR) {
        const int i = ib + n, buf = n % G::NDQ;
        const int lo = p.q_offset + i * G::BQ, hi = p.q_offset + min(p.T, (i + 1) * G::BQ) - 1;
        int jb, je;
        key_walk<G::BKB>(lo, hi, p.limit, p.causal, p.window, jb, je);
        sm90::mbar_wait(&bars.dq_full[buf], (n / G::NDQ) & 1);
        // the turn: every later key block of the row tile has added its part
        const int target = je - 1 - blk.j;
        if (ld_acquire(turns + i) < target) {
            const unsigned long long t0 = globaltimer_ns();
            while (ld_acquire(turns + i) < target)
                if (globaltimer_ns() - t0 > 10000000000ull) __trap();
        }
        sm90::fence_proxy_async_global();
        const uint8_t* tile = smem + G::OFF_DQ + buf * G::DQ_BYTES;
#pragma unroll
        for (int c = 0; c < D / 32; ++c)
            sm90::tma_reduce_add_4d(tdq, tile + c * G::BQ * 128, 32 * c, blk.h, i * G::BQ, blk.b);
        sm90::bulk_commit();
        sm90::bulk_wait_all();  // the adds performed, not only the tile read
        sm90::fence_proxy_async_global();
        __threadfence();
        asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(turns + i), "r"(1)
                     : "memory");
        sm90::mbar_arrive(&bars.dq_empty[buf]);
    }
}

template <int D>
__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, int cw,
                                         const Block& blk) {
    using G = FusedGeo<D>;
    constexpr int BQ = G::BQ;
    Bars<D> bars(smem);
    const float* lds = reinterpret_cast<const float*>(smem + G::OFF_LD);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int b = blk.b, h = blk.h, kc0 = blk.j * G::BKB;
    const int c0 = kc0 + cw * ROWS;  // this consumer's first key
    int ib, ie, cib, cie;
    block_walk<D>(p, kc0, ib, ie);
    q_walk<BQ>(c0, c0 + ROWS - 1, p.T, p.q_offset, p.limit, p.causal, p.window, cib, cie);

    const uint32_t kv_base = smem_addr(smem);
    const uint32_t k_base = kv_base + cw * ROWS * D * 2;
    const uint32_t v_base = k_base + G::KV_BYTES;
    const uint32_t ds0 = smem_addr(smem + G::OFF_DS);
    const int kc[2] = {c0 + 16 * w + r8, c0 + 16 * w + r8 + 8};  // this thread's keys
    bool key_ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
        key_ok[hh] = kc[hh] < p.limit &&
                     (!p.mask || __ldg(p.mask + (size_t)b * p.S + kc[hh]) != 0);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(bars.kv_full, 0);
    for (int i = ib, n = 0; i < ie; ++i, ++n) {
        const int s = n % G::NST, sb = n & 1;
        sm90::mbar_wait(&bars.full[s], (n / G::NST) & 1);
        const bool vis = i >= cib && i < cie;
        const int t0 = i * BQ;
        const uint32_t q_st = smem_addr(smem + G::OFF_Q + 2 * s * G::Q_BYTES);
        const uint32_t do_st = q_st + G::Q_BYTES;
        uint32_t pa[16], da[16];
#pragma unroll
        for (int x = 0; x < 16; ++x) pa[x] = da[x] = 0u;
        if (vis) {
            const float* ld = lds + s * 2 * BQ;
            // S^T = K Q^T and dP^T = V dO^T, [keys, rows]: sc[4 nn + 2 hh + e]
            // is key kc[hh], row t0 + 8 nn + 2 quad + e
            float sc[32], dp[32];
            sm90::wgmma_fence();
            sm90::ss_product<D, ROWS, BQ>(sc, k_base, q_st);
            sm90::ss_product<D, ROWS, BQ>(dp, v_base, do_st);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();

            const int lo = p.q_offset + t0, hi = p.q_offset + min(p.T, t0 + BQ) - 1;
            if (!tile_interior<ROWS>(c0, lo, hi, p.limit, p.causal, p.window)) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int row = lo + 8 * nn + 2 * quad + e, col = kc[hh];
                            const bool keep = key_ok[hh] && (!p.causal || col <= row) &&
                                              (p.window <= 0 || row - col < p.window);
                            if (!keep) sc[4 * nn + 2 * hh + e] = -INFINITY;
                        }
            } else {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                    if (!key_ok[hh]) {
#pragma unroll
                        for (int nn = 0; nn < 8; ++nn) {
                            sc[4 * nn + 2 * hh] = -INFINITY;
                            sc[4 * nn + 2 * hh + 1] = -INFINITY;
                        }
                    }
            }

            // p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta) in fp32, each
            // pair turned into a bf16 A operand as it is formed
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                const float2 l2 = *reinterpret_cast<const float2*>(ld + 8 * nn + 2 * quad);
                const float2 dl = *reinterpret_cast<const float2*>(ld + BQ + 8 * nn + 2 * quad);
                const float lx = l2.x * LOG2E, ly = l2.y * LOG2E;
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int i0 = 4 * nn + 2 * hh;
                    const float p0 = sm90::ex2(fmaf(sc[i0], LOG2E, -lx));
                    const float p1 = sm90::ex2(fmaf(sc[i0 + 1], LOG2E, -ly));
                    pa[afrag(nn, hh)] = pack(p0, p1);
                    da[afrag(nn, hh)] = pack(p0 * (dp[i0] - dl.x), p1 * (dp[i0 + 1] - dl.y));
                }
            }
        }

        // dS^T (zeros where this consumer's keys see no row of the tile)
        // into the shared [keys, 64 rows] tile of this step: key row k holds
        // its 64 rows' bf16 values as 8 16-byte chunks, chunk c at c ^ (k % 8)
        // (the 128-byte swizzle the dq product's descriptor reads)
        if (n >= 2) sm90::mbar_wait(&bars.ds_empty[sb], ((n >> 1) - 1) & 1);
        uint8_t* dst = smem + G::OFF_DS + sb * G::DS_BYTES;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int key = cw * ROWS + 16 * w + r8 + 8 * hh;  // its row of the tile
#pragma unroll
            for (int nn = 0; nn < 8; ++nn)
                *reinterpret_cast<uint32_t*>(dst + key * 128 + ((nn ^ (key & 7)) << 4) +
                                             4 * quad) = da[afrag(nn, hh)];
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&bars.ds_full[sb]);

        if (vis) {  // dV += P^T dO, dK += dS^T Q; dO and Q are [rows, D], MN-major
            sm90::wgmma_fence();
            sm90::rs_product<D>(dv, pa, do_st);
            sm90::rs_product<D>(dk, da, q_st);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
        }
        if (cw != n % G::NCW) {
            sm90::mbar_arrive(&bars.empty[s]);
            continue;
        }
        // this consumer's turn at the step's dq: dQ = dS K_block, [64 rows,
        // D], over the block's keys; dS^T and K both through the transpose
        // bits
        sm90::mbar_wait(&bars.ds_full[sb], (n >> 1) & 1);
        float dq[D / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::BKB / 16; ++kk) {
            const uint64_t a = sm90::make_desc(ds0 + sb * G::DS_BYTES + kk * 16 * 128,
                                               ROWS * 128, 8 * 128, sm90::SW128);
            const uint64_t bk =
                sm90::mnmajor_desc<D, ROWS>(kv_base + (kk >> 2) * ROWS * D * 2, kk & 3);
            sm90::wgmma_ss_tt<D>(dq, a, bk, kk);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::mbar_arrive(&bars.ds_empty[sb]);
        sm90::mbar_arrive(&bars.empty[s]);

        // the fp32 tile to its buffer: box c holds columns 32 c .. as [64
        // rows, 128 bytes], 16-byte chunk x of row r at x ^ (r % 8)
        const int buf = n % G::NDQ;
        if (n >= G::NDQ) sm90::mbar_wait(&bars.dq_empty[buf], (n / G::NDQ - 1) & 1);
        uint8_t* tile = smem + G::OFF_DQ + buf * G::DQ_BYTES;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * w + r8 + 8 * hh;
#pragma unroll
            for (int nn = 0; nn < D / 8; ++nn) {
                const int chunk = (2 * (nn & 3) + (quad >> 1)) ^ (r & 7);
                *reinterpret_cast<float2*>(tile + (nn >> 2) * BQ * 128 + r * 128 + chunk * 16 +
                                           8 * (quad & 1)) =
                    make_float2(dq[4 * nn + 2 * hh], dq[4 * nn + 2 * hh + 1]);
            }
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&bars.dq_full[buf]);
    }

    bf16* dkp = static_cast<bf16*>(p.dk);
    bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (kc[hh] >= p.S) continue;
        const size_t off = (((size_t)b * p.S + kc[hh]) * p.H + h) * D + 2 * quad;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
            *reinterpret_cast<uint32_t*>(dkp + off + 8 * nn) =
                pack(dk[4 * nn + 2 * hh], dk[4 * nn + 2 * hh + 1]);
            *reinterpret_cast<uint32_t*>(dvp + off + 8 * nn) =
                pack(dv[4 * nn + 2 * hh], dv[4 * nn + 2 * hh + 1]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(FusedGeo<D>::THREADS, 1)
flash_bwd_fused_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdq, const Params p) {
    using G = FusedGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const Block blk = block_of<D>(p);

    Bars<D> bars(smem);
    if (threadIdx.x == 0) {
        sm90::mbar_init(bars.kv_full, 1);  // K and V loaded
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&bars.full[s], 32 + 1);          // stage s loaded
            sm90::mbar_init(&bars.empty[s], 128 * G::NCW);  // stage s read
        }
        for (int x = 0; x < 2; ++x) {
            sm90::mbar_init(&bars.ds_full[x], 128 * G::NCW);  // dS^T tile written
            sm90::mbar_init(&bars.ds_empty[x], 128);          // read by the dq product
        }
        for (int x = 0; x < G::NDQ; ++x) {
            sm90::mbar_init(&bars.dq_full[x], 128);  // dq tile written
            sm90::mbar_init(&bars.dq_empty[x], 1);   // added into the accumulator
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp: only
    // then does it give the consumers the registers setmaxnreg asks for
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_dec<PRODUCER_REGS>();
        const int warp = __shfl_sync(FULL, (int)threadIdx.x / 32, 0);
        if (warp == 0)
            loader<D>(&tq, &tdo, &tk, &tv, p, smem, blk);
        else if (warp <= G::NWR && (threadIdx.x & 31) == 0)
            writer<D>(&tdq, p, smem, blk, warp - 1);
    } else {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_inc<CONSUMER_REGS>();
        consumer<D>(p, smem, wg - 1, blk);
    }
}

// dq = the fp32 accumulator rounded to bf16, 4 elements a thread
__global__ void dq_cast_kernel(const float4* __restrict__ acc, uint2* __restrict__ out,
                               size_t n4) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
         i += (size_t)gridDim.x * blockDim.x) {
        const float4 x = acc[i];
        out[i] = make_uint2(pack(x.x, x.y), pack(x.z, x.w));
    }
}

template <int D>
cudaError_t launch(const Params& p, void* dq, cudaStream_t stream) {
    using G = FusedGeo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tdo, tk, tv, tdq;
    if (!sm90::make_map<D>(enc, &tq, p.q, p.B, p.T, p.H, G::BQ) ||
        !sm90::make_map<D>(enc, &tdo, p.dout, p.B, p.T, p.H, G::BQ) ||
        !sm90::make_map<D>(enc, &tk, p.k, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map<D>(enc, &tv, p.v, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map_f32(enc, &tdq, p.dq, p.B, p.T, p.H, D, G::BQ))
        return cudaErrorInvalidValue;
    const size_t acc_bytes = (size_t)p.B * p.T * p.H * D * sizeof(float);
    cudaError_t err = cudaMemsetAsync(p.dq, 0, acc_bytes, stream);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(p.turns, 0,
                          (size_t)p.B * p.H * ((p.T + G::BQ - 1) / G::BQ) * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    auto kern = flash_bwd_fused_sm90<D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    const int nkb = (p.S + G::BKB - 1) / G::BKB;
    kern<<<nkb * p.B * p.H, G::THREADS, G::SMEM, stream>>>(tq, tdo, tk, tv, tdq, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n4 = acc_bytes / sizeof(float4);
    const size_t want = (n4 + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    dq_cast_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(p.dq),
                                              static_cast<uint2*>(dq), n4);
    return cudaGetLastError();
}

}  // namespace hop

// fp32 inputs: #7's body with FUSED set, accumulating into dq itself
template <int D>
cudaError_t launch_fp32(const Params& p, cudaStream_t stream) {
    cudaError_t err = cudaMemsetAsync(p.dq, 0, (size_t)p.B * p.T * p.H * D * sizeof(float),
                                      stream);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(p.turns, 0, (size_t)p.B * p.H * ((p.T + BQ - 1) / BQ) * sizeof(int),
                          stream);
    if (err != cudaSuccess) return err;
    return launch_dkv<float, D, true>(p, stream);
}

template <int D>
cudaError_t launch(int dtype, Params p, void* dq, void* dq_acc, cudaStream_t stream) {
    if (dtype == 0) {
        p.dq = dq;
        return launch_fp32<D>(p, stream);
    }
    p.dq = dq_acc;
    return hop::launch<D>(p, dq, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `mask` is int32 [B, S] or null. Scratch
// from the caller, zeroed here: `turns` int32 of at least B * H * ceil(T /
// 64) and, for bf16, `dq_acc` fp32 [B, T, H, D] (unused for fp32). q_offset
// >= 0. Returns cudaGetLastError() after the last launch.
int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* mask, void* dq, void* dk,
                    void* dv, void* dq_acc, void* turns, int B, int T_, int S, int H, int D,
                    int q_offset, int limit, int causal, int window, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
    if (q_offset < 0 || !turns || (dtype != 0 && dtype != 1) || (dtype == 1 && !dq_acc))
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, dout, nullptr, static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<const int*>(mask), nullptr, dk, dv,
             nullptr, B, T_, S, H, 0, 0, q_offset, limit, causal, window, 0,
             static_cast<int*>(turns)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return (int)launch<32>(dtype, p, dq, dq_acc, st);
        case 64: return (int)launch<64>(dtype, p, dq, dq_acc, st);
        case 96: return (int)launch<96>(dtype, p, dq, dq_acc, st);
        case 128: return (int)launch<128>(dtype, p, dq, dq_acc, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
