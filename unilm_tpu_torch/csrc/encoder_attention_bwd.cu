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
// resident block. On the H100 blocks run in parallel and a block's shared
// memory holds a few rows of such a plane, so the one pass becomes up to
// three launches of one entry point:
//  1. dq (+ dbias, + row statistics): one block per (64-row q tile, head,
//     batch group). For each (batch, head) it loops over, it sweeps the key
//     tiles twice: first for the exact row statistics (max m, l =
//     sum exp2(s - m), u = sum exp2(s - m) dp, kept online per lane and
//     merged across the warp in a fixed order), then for p, ds, dbias and
//     dq. It writes m, l and delta = u / l for launch 2.
//  2. dk, dv: one block per (64-key tile, head, batch), sweeping the q
//     tiles and recomputing p and ds with those statistics.
//  3. Only when a batch-broadcast dbias is summed over batch groups: the
//     groups' partial planes, added in group order.
// A dbias row belongs to one block, which adds every (batch, head) it
// loops over (the batch items of its group for a [1, ...] bias; every head
// for a [., 1, ...] bias) in loop order; launch 3 adds the groups in order.
// No float atomics: two runs give the same bits.
//
// Layouts are the caller's: q/dO/dq [B, T, H, D], k/v/dk/dv [B, S, H, D]
// (row stride H*D, the projection layout), bias [Bb, Hb, T, S] with
// element strides `bias_sb`, `bias_sh` (0 = broadcast), dbias fp32
// [Bb, Hb, T, S], the partial planes fp32 [groups, Hb, T, S], the row
// statistics fp32 [3, B, H, T].
//
// What bounds it on the H100: the work itself (five T x S x D products per
// batch and head, 10 B H T S D FLOP) is bound by memory on the card: at
// BEiT-B (B=256, T=S=197, H=12, D=64, bf16) 545 MB in and out against
// 7.6e10 FLOP, 0.163 ms at 3.35 TB/s against 0.077 ms of bf16 tensor time.
// Both designs below recompute: nine products instead of five (the
// statistics sweep repeats q k^T and dO v^T, launch 2 repeats them again),
// and stream K/V (launch 1) and q/dO (launch 2) once per tile of the other
// side, so neither reaches that bound; they are bound by latency: tile
// loads, block barriers and the per-element exp2 and bias reads between
// the products.
// What the designs do about it:
//  - bf16 (the training path), namespace tc: every product on the tensor
//    cores (mma.sync m16n8k16, fp32 accumulators). A warp owns 16 query
//    rows (launch 1) or 16 keys (launch 2); the score and dp tiles stay in
//    the accumulators, and p and ds become the next product's operand
//    straight from the accumulator layout, rounded to bf16 there (the
//    rounding the contract asks for). Tiles are bf16 with rows padded by 8
//    elements, so fragment loads are bank-conflict free; operands that are
//    needed transposed (K in ds k, q and dO in ds^T q and p^T dO) come from
//    the same tiles through ldmatrix .trans. The next K/V (launch 1) or
//    q/dO (launch 2) tile is fetched by cp.async while the current one is
//    used. The bias is read in the accumulator layout, times log2(e).
//    Against the first version of this file, which ran bf16 through the
//    fp32 design below, it took BEiT-B from 12.28 ms to about a quarter of
//    that (PERF.md, chip_smoke.py's encoder_bwd phase).
//  - fp32 inputs (encoder_attention_bwd.cuh, which the fp32 path of
//    csrc/doc_attention_bwd.cu (#10) shares with a key-padding mask):
//    fp32 CUDA cores, the tiles of csrc/flash_bwd.cu (#6/#7):
//    in launch 1 each warp owns 8 query rows and each lane two keys of a
//    64-key tile, K and V rows padded so the per-lane float4 reads are
//    conflict free, q and dO read as float4 broadcasts, ds handed to the
//    ds k product through shared memory; launch 2 is its transpose (each
//    warp owns 8 keys, each lane two query rows). 8 warps per block.

#include "encoder_attention_bwd.cuh"
#include "mma_common.cuh"

namespace {

using enc_bwd::BK;
using enc_bwd::BQ;
using enc_bwd::launch_pair;
using enc_bwd::LOG2E;
using enc_bwd::Params;

// ---------------------------------------------------------------------------
// launch 3: dbias = the sum of the groups' partial planes, in group order.
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
// bf16 inputs: the same two launches on the tensor cores (see the top of
// the file). 4 warps per block.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int BQ2 = 32;        // launch 2: query rows per step
constexpr int PAD = 8;         // bf16 elements of padding per tile row
static_assert(BQ == NW * 16 && BK == NW * 16, "a warp owns 16 rows or keys");

template <int D>
__device__ __forceinline__ void stage(bf16* x, int ld, const bf16* src, size_t row_stride,
                                      int nrows, int valid, int tid) {
    stage_async<D, NT>(x, ld, src, row_stride, nrows, valid, tid);
}

// log2(e) * bias[row][col], 0 without a bias
__device__ __forceinline__ float bias2(const bf16* bias_bh, int S, int row, int col) {
    return bias_bh ? LOG2E * __bfloat162float(bias_bh[(size_t)row * S + col]) : 0.f;
}

// launch 1 on the tensor cores: row statistics, dq and dbias. One block per
// (64-row q tile, head or every head, batch group), as enc_bwd_dq_kernel;
// the K/V tiles of its two sweeps are double-buffered (cp.async).
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 3 : 2) enc_bwd_dq_tc_kernel(const Params p) {
    constexpr int LD = D + PAD;
    constexpr int NJ = BK / 8, ND = D / 8, KD = D / 16;
    extern __shared__ float4 smem4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BQ][LD]
    bf16* Os = Qs + BQ * LD;                    // [BQ][LD] dO
    bf16* KV = Os + BQ * LD;                    // 2 x {K [BK][LD], V [BK][LD]}

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* v = static_cast<const bf16*>(p.v);
    const bf16* dout = static_cast<const bf16*>(p.dout);
    const bf16* bias = static_cast<const bf16*>(p.bias);
    bf16* dq = static_cast<bf16*>(p.dq);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = blockIdx.x * BQ;
    const int T_ = p.T, S = p.S, H = p.H;
    const size_t HD = (size_t)H * D;
    const int nrows = min(BQ, T_ - row0);
    const int nk = (S + BK - 1) / BK;
    const int b_begin = blockIdx.z * p.group, b_end = min(p.B, b_begin + p.group);
    const int h_begin = p.head_sum ? 0 : blockIdx.y;
    const int h_end = p.head_sum ? H : blockIdx.y + 1;
    float* db_z = p.dbias ? p.dbias + (size_t)blockIdx.z * p.db_sz : nullptr;
    const int wr = warp * 16;  // this warp's first local row
    // the thread's two rows, clamped for the bias reads of rows past T
    const int tl[2] = {row0 + wr + g, row0 + wr + g + 8};
    const int tr[2] = {min(tl[0], T_ - 1), min(tl[1], T_ - 1)};
    bool first = true;

    for (int b = b_begin; b < b_end; ++b) {
        for (int h = h_begin; h < h_end; ++h) {
            __syncthreads();  // the previous (batch, head)'s tiles consumed
            const size_t qoff = ((size_t)b * T_ + row0) * HD + (size_t)h * D;
            const size_t kbase = (size_t)b * S * HD + (size_t)h * D;
            stage<D>(Qs, LD, q + qoff, HD, BQ, nrows, tid);
            stage<D>(Os, LD, dout + qoff, HD, BQ, nrows, tid);
            stage<D>(KV, LD, k + kbase, HD, BK, S, tid);
            stage<D>(KV + BK * LD, LD, v + kbase, HD, BK, S, tid);
            cp_commit();
            const bf16* bias_bh =
                bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
            float* db_bh = db_z ? db_z + (size_t)h * p.db_sh : nullptr;

            float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
            float delta[2] = {0.f, 0.f};
            float acc[ND][4];
#pragma unroll
            for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

            // tiles 0..nk-1: sweep 0, the exact row statistics; tiles
            // nk..2nk-1: sweep 1, p, ds, dbias and dq
            for (int i = 0; i < 2 * nk; ++i) {
                const int c0 = (i % nk) * BK;
                const bool sweep1 = i >= nk;
                if (i + 1 < 2 * nk) {  // prefetch the next tile into the other buffer
                    const int cn = ((i + 1) % nk) * BK;
                    bf16* nb = KV + ((i + 1) & 1) * 2 * BK * LD;
                    stage<D>(nb, LD, k + kbase + (size_t)cn * HD, HD, BK, S - cn, tid);
                    stage<D>(nb + BK * LD, LD, v + kbase + (size_t)cn * HD, HD, BK, S - cn,
                             tid);
                    cp_commit();
                    cp_wait<1>();
                } else {
                    cp_wait<0>();
                }
                __syncthreads();
                const bf16* Ks = KV + (i & 1) * 2 * BK * LD;
                const bf16* Vs = Ks + BK * LD;

                float s[NJ][4], dp[NJ][4];
#pragma unroll
                for (int n = 0; n < NJ; ++n)
                    s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] =
                        dp[n][3] = 0.f;
#pragma unroll
                for (int kk = 0; kk < KD; ++kk) {
                    uint32_t aq[4], ao[4];
                    load_a(aq, Qs, LD, wr, kk * 16, g, tq);
                    load_a(ao, Os, LD, wr, kk * 16, g, tq);
#pragma unroll
                    for (int n = 0; n < NJ; ++n) {
                        const bf16* kr = Ks + (n * 8 + g) * LD + kk * 16 + 2 * tq;
                        const bf16* vr = Vs + (n * 8 + g) * LD + kk * 16 + 2 * tq;
                        mma(s[n], aq, ld32(kr), ld32(kr + 8));
                        mma(dp[n], ao, ld32(vr), ld32(vr + 8));
                    }
                }
                // s -> the exp2-domain scores with the bias; NEG_INF past S
#pragma unroll
                for (int n = 0; n < NJ; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = c0 + n * 8 + 2 * tq + (e & 1);
                        s[n][e] = col < S ? s[n][e] * p.qscale + bias2(bias_bh, S, tr[e >> 1], col)
                                          : NEG_INF;
                    }

                if (!sweep1) {
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        float mt = m[r];
#pragma unroll
                        for (int n = 0; n < NJ; ++n)
                            mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
                        const float a = exp2f(m[r] - mt);
                        float ls = 0.f, us = 0.f;
#pragma unroll
                        for (int n = 0; n < NJ; ++n)
#pragma unroll
                            for (int e = 2 * r; e < 2 * r + 2; ++e) {
                                const float x = exp2f(s[n][e] - mt);
                                ls += x;
                                us += x * dp[n][e];
                            }
                        l[r] = l[r] * a + ls;
                        u[r] = u[r] * a + us;
                        m[r] = mt;
                    }
                    if (i == nk - 1) {
                        // merge the quad's statistics (a fixed butterfly)
#pragma unroll
                        for (int r = 0; r < 2; ++r) {
#pragma unroll
                            for (int o = 1; o < 4; o <<= 1) {
                                const float mo = __shfl_xor_sync(FULL, m[r], o);
                                const float lo = __shfl_xor_sync(FULL, l[r], o);
                                const float uo = __shfl_xor_sync(FULL, u[r], o);
                                const float mt = fmaxf(m[r], mo);
                                const float a = exp2f(m[r] - mt), c = exp2f(mo - mt);
                                l[r] = l[r] * a + lo * c;
                                u[r] = u[r] * a + uo * c;
                                m[r] = mt;
                            }
                            delta[r] = u[r] / l[r];
                            if (tq == 0 && tl[r] < T_) {
                                const size_t ri = ((size_t)b * H + h) * T_ + tl[r];
                                const size_t plane = (size_t)p.B * H * T_;
                                p.stats[ri] = m[r];
                                p.stats[plane + ri] = l[r];
                                p.stats[2 * plane + ri] = delta[r];
                            }
                        }
                    }
                } else {
                    // p, ds (fp32) -> dbias; ds (bf16) @ K -> dq
#pragma unroll
                    for (int n = 0; n < NJ; ++n)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int r = e >> 1;
                            const float pr = exp2f(s[n][e] - m[r]) / l[r];
                            s[n][e] = pr * (dp[n][e] - delta[r]);  // ds
                            const int col = c0 + n * 8 + 2 * tq + (e & 1);
                            if (db_bh && tl[r] < T_ && col < S) {
                                float* d = db_bh + (size_t)tl[r] * S + col;
                                *d = first ? s[n][e] : *d + s[n][e];
                            }
                        }
#pragma unroll
                    for (int kk = 0; kk < BK / 16; ++kk) {
                        uint32_t a[4];
                        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
                        for (int n = 0; n < ND; n += 2) {
                            uint32_t bk[4];
                            load_bt(bk, Ks, LD, kk * 16, n * 8, lane);
                            mma(acc[n], a, bk[0], bk[1]);
                            mma(acc[n + 1], a, bk[2], bk[3]);
                        }
                    }
                }
                __syncthreads();  // this buffer is free for tile i + 2
            }

#pragma unroll
            for (int r = 0; r < 2; ++r) {
                if (tl[r] >= T_) continue;
                bf16* dst = dq + ((size_t)b * T_ + tl[r]) * HD + (size_t)h * D + 2 * tq;
#pragma unroll
                for (int n = 0; n < ND; ++n)
                    *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
                        acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
            }
            first = false;
        }
    }
}

// launch 2 on the tensor cores: dk, dv. One block per (64-key tile, head,
// batch), sweeping the q rows BQ2 at a time, the q/dO tiles
// double-buffered (cp.async).
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 4 : 2) enc_bwd_dkv_tc_kernel(const Params p) {
    constexpr int LD = D + PAD;
    constexpr int NJ = BQ2 / 8, ND = D / 8, KD = D / 16;
    extern __shared__ float4 smem4[];
    bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [BK][LD]
    bf16* Vs = Ks + BK * LD;                    // [BK][LD]
    bf16* QO = Vs + BK * LD;                    // 2 x {q [BQ2][LD], dO [BQ2][LD]}
    float* Ms = reinterpret_cast<float*>(QO + 4 * BQ2 * LD);  // [BQ2] m
    float* Ls = Ms + BQ2;                                      // [BQ2] l
    float* Dl = Ls + BQ2;                                      // [BQ2] delta

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* v = static_cast<const bf16*>(p.v);
    const bf16* dout = static_cast<const bf16*>(p.dout);
    const bf16* bias = static_cast<const bf16*>(p.bias);

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int c0 = blockIdx.x * BK;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const size_t plane = (size_t)p.B * p.H * T_;
    const int wk = warp * 16;  // this warp's first local key
    // the thread's two keys, clamped for the bias reads of keys past S
    const int key[2] = {c0 + wk + g, c0 + wk + g + 8};
    const int kc[2] = {min(key[0], S - 1), min(key[1], S - 1)};
    const int nq = (T_ + BQ2 - 1) / BQ2;

    const size_t koff = ((size_t)b * S + c0) * HD + (size_t)h * D;
    const size_t qbase = (size_t)b * T_ * HD + (size_t)h * D;
    stage<D>(Ks, LD, k + koff, HD, BK, S - c0, tid);
    stage<D>(Vs, LD, v + koff, HD, BK, S - c0, tid);
    stage<D>(QO, LD, q + qbase, HD, BQ2, T_, tid);
    stage<D>(QO + BQ2 * LD, LD, dout + qbase, HD, BQ2, T_, tid);
    cp_commit();
    const bf16* bias_bh = bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;

    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int it = 0; it < nq; ++it) {
        const int t0 = it * BQ2;
        if (it + 1 < nq) {  // prefetch the next q / dO tile
            const int tn = t0 + BQ2;
            bf16* nb = QO + ((it + 1) & 1) * 2 * BQ2 * LD;
            stage<D>(nb, LD, q + qbase + (size_t)tn * HD, HD, BQ2, T_ - tn, tid);
            stage<D>(nb + BQ2 * LD, LD, dout + qbase + (size_t)tn * HD, HD, BQ2, T_ - tn, tid);
            cp_commit();
        }
        for (int t = tid; t < BQ2; t += NT) {
            const bool live = t0 + t < T_;
            const size_t ri = ((size_t)b * p.H + h) * T_ + t0 + t;
            Ms[t] = live ? p.stats[ri] : 0.f;
            Ls[t] = live ? p.stats[plane + ri] : 1.f;
            Dl[t] = live ? p.stats[2 * plane + ri] : 0.f;
        }
        if (it + 1 < nq)
            cp_wait<1>();
        else
            cp_wait<0>();
        __syncthreads();
        const bf16* Qs = QO + (it & 1) * 2 * BQ2 * LD;
        const bf16* Os = Qs + BQ2 * LD;

        // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys
        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] =
                0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t ak[4], av[4];
            load_a(ak, Ks, LD, wk, kk * 16, g, tq);
            load_a(av, Vs, LD, wk, kk * 16, g, tq);
#pragma unroll
            for (int n = 0; n < NJ; ++n) {
                const bf16* qr = Qs + (n * 8 + g) * LD + kk * 16 + 2 * tq;
                const bf16* orow = Os + (n * 8 + g) * LD + kk * 16 + 2 * tq;
                mma(s[n], ak, ld32(qr), ld32(qr + 8));
                mma(dp[n], av, ld32(orow), ld32(orow + 8));
            }
        }
        // p^T (in s) and ds^T (in dp); zero past S and past T
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int tt = n * 8 + 2 * tq + (e & 1), r = e >> 1;
                float pr = 0.f;
                if (key[r] < S && t0 + tt < T_)
                    pr = exp2f(s[n][e] * p.qscale + bias2(bias_bh, S, t0 + tt, kc[r]) -
                               Ms[tt]) / Ls[tt];
                s[n][e] = pr;
                dp[n][e] = pr * (dp[n][e] - Dl[tt]);
            }
        // dv += p^T dO, dk += ds^T q
#pragma unroll
        for (int kk = 0; kk < BQ2 / 16; ++kk) {
            uint32_t ap[4], ad[4];
            acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
            acc_to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < ND; n += 2) {
                uint32_t bo[4], bq[4];
                load_bt(bo, Os, LD, kk * 16, n * 8, lane);
                load_bt(bq, Qs, LD, kk * 16, n * 8, lane);
                mma(dv[n], ap, bo[0], bo[1]);
                mma(dv[n + 1], ap, bo[2], bo[3]);
                mma(dk[n], ad, bq[0], bq[1]);
                mma(dk[n + 1], ad, bq[2], bq[3]);
            }
        }
        __syncthreads();  // this buffer and the statistics are free
    }

    bf16* dkp = static_cast<bf16*>(p.dk);
    bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (key[r] >= S) continue;
        const size_t off = ((size_t)b * S + key[r]) * HD + (size_t)h * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dkp + off + n * 8) = __floats2bfloat162_rn(
                dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
            *reinterpret_cast<__nv_bfloat162*>(dvp + off + n * 8) =
                __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
        }
    }
}

template <int D> constexpr size_t dq_smem() {
    return (size_t)6 * BQ * (D + PAD) * sizeof(bf16);
}
template <int D> constexpr size_t dkv_smem() {
    return (size_t)(2 * BK + 4 * BQ2) * (D + PAD) * sizeof(bf16) + 3 * BQ2 * sizeof(float);
}

}  // namespace tc

template <int D>
cudaError_t launch(int dtype, const Params& p, int groups, cudaStream_t stream) {
    if (dtype == 0) return enc_bwd::launch_fp32<D>(p, groups, stream);
    return launch_pair(tc::enc_bwd_dq_tc_kernel<D>, tc::dq_smem<D>(),
                       tc::enc_bwd_dkv_tc_kernel<D>, tc::dkv_smem<D>(), tc::NT, p, groups,
                       stream);
}

cudaError_t dispatch_d(int D, int dtype, const Params& p, int groups, cudaStream_t st) {
    switch (D) {
        case 64: return launch<64>(dtype, p, groups, st);
        case 96: return launch<96>(dtype, p, groups, st);
        case 128: return launch<128>(dtype, p, groups, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `scale` multiplies q k^T. dbias may be
// null (no bias, or its gradient not wanted). A [1, Hb, T, S] bias with
// B > 1 has its gradient summed over the batch: launch 1 sums each group
// of `group` batch items; with more than one group `partial`
// ([ceil(B / group), Hb, T, S] fp32) takes the groups' planes and launch 3
// adds them into dbias, with one group partial is null and launch 1 writes
// dbias itself. Otherwise `group` is 1 and partial null. `head_sum` (a
// [., 1, T, S] bias, H > 1) makes launch 1 sum the heads. `stats` is
// [3, B, H, T] fp32 scratch. Returns cudaGetLastError() after the last
// launch.
int encoder_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                     const void* bias, void* dq, void* dk, void* dv, void* dbias, void* partial,
                     void* stats, int B, int T_, int S, int H, int D, int bias_sb, int bias_sh,
                     int bias_h, int group, int head_sum, float scale, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    // a [1, Hb, T, S] bias's gradient over B > 1 is summed over the batch
    const bool batch_sum = dbias && bias_sb == 0 && B > 1;
    if (S <= 0 || group <= 0 || (dbias && !bias) || (group > 1 && !batch_sum) ||
        (head_sum && (!dbias || bias_h != 1)))
        return (int)cudaErrorInvalidValue;
    const int groups = (B + group - 1) / group;
    // partial planes exactly when more than one group sums the batch
    if ((partial != nullptr) != (batch_sum && groups > 1)) return (int)cudaErrorInvalidValue;
    const size_t TS = (size_t)T_ * S;
    Params p{q, k, v, dout, bias, nullptr, dq, dk, dv,
             static_cast<float*>(partial ? partial : dbias), static_cast<float*>(stats),
             B, T_, S, H, bias_sb, bias_sh, bias_h * TS, bias_h > 1 ? TS : 0, group, head_sum,
             scale, scale * LOG2E};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 || dtype == 1 ? dispatch_d(D, dtype, p, groups, st) : cudaErrorInvalidValue;
    if (err != cudaSuccess || !partial) return (int)err;
    const size_t n = (size_t)bias_h * T_ * S;
    const int blocks = (int)((n + 255) / 256 < 1056 ? (n + 255) / 256 : 1056);
    enc_bwd_dbias_sum_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                                     static_cast<float*>(dbias), n, groups);
    return (int)cudaGetLastError();
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
