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
// in parallel, so the one pass becomes two launches of one entry point, with
// no atomics (two runs give the same bits):
//  A. one block per (64-row q tile, head, batch): sweep 0 over the key
//     tiles takes the exact row statistics online (max m, l = sum
//     exp2(s - m), u = sum exp2(s - m) dp, merged across the quad in a
//     fixed order); sweep 1 recomputes s and dp, writes ds (rounded) to the
//     ds plane, and accumulates dq. It writes m and l for launch B.
//  B. one block per (64-key tile, head, batch), sweeping the q tiles:
//     recomputes p from m and l, reads ds back from the plane (for bf16
//     exactly the TPU kernel's bf16 `dsl`), and accumulates dk and dv. It
//     needs no v and no dp: the ds plane carries them.
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
// 0.125 ms of bf16 tensor time. The design recomputes (q k^T and dO v^T
// twice in launch A, q k^T again in launch B: eight products instead of
// five) and reads the bias three times and ds twice, so it does not reach
// that bound; a first version, right and deterministic.
//  - bf16 (namespace tc): every product on the tensor cores (mma.sync
//    m16n8k16, fp32 accumulators), the tiles of csrc/encoder_attention_bwd.cu
//    (#4): a warp owns 16 query rows (A) or 16 keys (B), p and ds go from the
//    accumulators to the next product's operand in bf16, the transposed
//    operands come through ldmatrix .trans, the next tile is fetched by
//    cp.async while the current one is used. Launch B scales its q operand
//    in registers with the same rounding launch A used in shared memory.
//    Launch A reads a tile's bias and mask before its products and selects
//    between them, so no bias read waits on a mask read (as in #9).
//  - fp32: #4's own fp32 CUDA-core launches (encoder_attention_bwd.cuh,
//    shared with csrc/encoder_attention_bwd.cu) given the mask, with the ds
//    plane as their fp32 dbias planes. They differ from A and B above in
//    two ways that fp32 makes exact or nearly so: launch B recomputes ds
//    from dp and the row's delta instead of reading it back (equal to the
//    plane's fp32 values up to rounding), and q k^T is scaled after the
//    product, not q before it (the last bits).

#include <cmath>

#include "encoder_attention_bwd.cuh"
#include "mma_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile

struct Params {
    const void *q, *k, *v, *dout, *bias;
    const int* mask;  // [B, S], nonzero = valid key; null = every key valid
    void *dq, *dk, *dv, *ds;
    float* stats;     // [3][B][H][T]: row max m (exp2 domain), l (and delta for fp32)
    int B, T, S, H, bias_sb, bias_sh, ds_sb, ds_sh;
    float scale, qscale;  // scale and scale * log2(e)
};

__device__ __forceinline__ bool key_ok(const int* mask_b, int col) {
    return !mask_b || mask_b[col];
}

// ---------------------------------------------------------------------------
// bf16 inputs: the same two launches on the tensor cores. 4 warps per block.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int BQ2 = 32;        // launch B: query rows per step
constexpr int PAD = 8;         // bf16 elements of padding per tile row
static_assert(BQ == NW * 16 && BK == NW * 16, "a warp owns 16 rows or keys");

// log2(e) * bias[row][col], 0 without a bias
__device__ __forceinline__ float bias_log2(const bf16* bias_bh, int S, int row, int col) {
    return bias_bh ? LOG2E * __bfloat162float(bias_bh[(size_t)row * S + col]) : 0.f;
}

// launch A on the tensor cores: row statistics, ds and dq; one block per
// (64-row q tile, head, batch), the K/V tiles of its two sweeps
// double-buffered (cp.async)
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 3 : 2) doc_bwd_dq_tc_kernel(const Params p) {
    constexpr int LD = D + PAD;
    constexpr int NJ = BK / 8, ND = D / 8, KD = D / 16;
    extern __shared__ float4 smem4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BQ][LD], q * qscale
    bf16* Os = Qs + BQ * LD;                    // [BQ][LD] dO
    bf16* KV = Os + BQ * LD;                    // 2 x {K [BK][LD], V [BK][LD]}

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* v = static_cast<const bf16*>(p.v);
    const bf16* dout = static_cast<const bf16*>(p.dout);
    bf16* dq = static_cast<bf16*>(p.dq);

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = blockIdx.x * BQ;
    const int T_ = p.T, S = p.S, H = p.H;
    const size_t HD = (size_t)H * D;
    const int nrows = min(BQ, T_ - row0);
    const int nk = (S + BK - 1) / BK;
    const int wr = warp * 16;  // this warp's first local row
    // the thread's two rows, clamped for the bias reads of rows past T
    const int tl[2] = {row0 + wr + g, row0 + wr + g + 8};
    const int tr[2] = {min(tl[0], T_ - 1), min(tl[1], T_ - 1)};
    const size_t qoff = ((size_t)b * T_ + row0) * HD + (size_t)h * D;
    const size_t kbase = (size_t)b * S * HD + (size_t)h * D;
    const bf16* bias_bh =
        p.bias ? static_cast<const bf16*>(p.bias) + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh
               : nullptr;
    bf16* ds_bh = static_cast<bf16*>(p.ds) + (size_t)b * p.ds_sb + (size_t)h * p.ds_sh;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;

    stage_async<D, NT>(Qs, LD, q + qoff, HD, BQ, nrows, tid);
    cp_commit();
    stage_async<D, NT>(Os, LD, dout + qoff, HD, BQ, nrows, tid);
    stage_async<D, NT>(KV, LD, k + kbase, HD, BK, S, tid);
    stage_async<D, NT>(KV + BK * LD, LD, v + kbase, HD, BK, S, tid);
    cp_commit();
    cp_wait<1>();  // q has arrived
    __syncthreads();
    // q * scale * log2(e), rounded to bf16, in place; the loop's first
    // barrier publishes it
    for (int i = tid; i < BQ * D / 2; i += NT) {
        uint32_t* x = reinterpret_cast<uint32_t*>(Qs + (i / (D / 2)) * LD + (i % (D / 2)) * 2);
        *x = scale2(*x, p.qscale);
    }

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
    float delta[2] = {0.f, 0.f};
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    // tiles 0..nk-1: sweep 0, the exact row statistics; tiles nk..2nk-1:
    // sweep 1, p, ds and dq
    for (int i = 0; i < 2 * nk; ++i) {
        const int c0 = (i % nk) * BK;
        const bool sweep1 = i >= nk;
        if (i + 1 < 2 * nk) {  // prefetch the next tile into the other buffer
            const int cn = ((i + 1) % nk) * BK;
            bf16* nb = KV + ((i + 1) & 1) * 2 * BK * LD;
            stage_async<D, NT>(nb, LD, k + kbase + (size_t)cn * HD, HD, BK, S - cn, tid);
            stage_async<D, NT>(nb + BK * LD, LD, v + kbase + (size_t)cn * HD, HD, BK, S - cn,
                               tid);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();
        const bf16* Ks = KV + (i & 1) * 2 * BK * LD;
        const bf16* Vs = Ks + BK * LD;

        // what the tile adds to the exp2-domain scores: log2(e) * bias, a
        // masked key -1e30 (s + -1e30 rounds to -1e30 for any score), past
        // S -inf; the bias and the mask both read before the products (a
        // clamped column past S) and then selected, so that neither read
        // waits on the other and their latency hides behind the mma work
        float add[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = c0 + n * 8 + 2 * tq + (e & 1);
                const int cc = min(col, S - 1);
                const float bv = bias_log2(bias_bh, S, tr[e >> 1], cc);
                add[n][e] = col >= S ? -INFINITY : key_ok(mask_b, cc) ? bv : NEG_INF;
            }

        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] =
                0.f;
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
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += add[n][e];

        if (!sweep1) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mt = m[r];
#pragma unroll
                for (int n = 0; n < NJ; ++n) mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
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
                        p.stats[ri] = m[r];
                        p.stats[(size_t)p.B * H * T_ + ri] = l[r];
                    }
                }
            }
        } else {
            // p, ds (fp32) -> the ds plane (bf16); ds (bf16) @ K -> dq
#pragma unroll
            for (int n = 0; n < NJ; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1;
                    const float pr = exp2f(s[n][e] - m[r]) / l[r];
                    s[n][e] = pr * (dp[n][e] - delta[r]);  // ds
                    const int col = c0 + n * 8 + 2 * tq + (e & 1);
                    if (tl[r] < T_ && col < S)
                        ds_bh[(size_t)tl[r] * S + col] = __float2bfloat16(s[n][e]);
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
}

// launch B on the tensor cores: dk, dv; one block per (64-key tile, head,
// batch), sweeping the q rows BQ2 at a time, the q/dO tiles double-buffered
// (cp.async)
template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 4 : 2) doc_bwd_dkv_tc_kernel(const Params p) {
    constexpr int LD = D + PAD;
    constexpr int NJ = BQ2 / 8, ND = D / 8, KD = D / 16;
    extern __shared__ float4 smem4[];
    bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [BK][LD]
    bf16* QO = Ks + BK * LD;                    // 2 x {q [BQ2][LD], dO [BQ2][LD]}
    float* Ms = reinterpret_cast<float*>(QO + 4 * BQ2 * LD);  // [BQ2] m
    float* Ls = Ms + BQ2;                                      // [BQ2] l

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* dout = static_cast<const bf16*>(p.dout);

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int c0 = blockIdx.x * BK;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const size_t plane = (size_t)p.B * p.H * T_;
    const int wk = warp * 16;  // this warp's first local key
    // the thread's two keys, clamped for the bias and ds reads past S
    const int key[2] = {c0 + wk + g, c0 + wk + g + 8};
    const int kc[2] = {min(key[0], S - 1), min(key[1], S - 1)};
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;
    const bool kin[2] = {key[0] < S, key[1] < S};
    const bool keep[2] = {kin[0] && key_ok(mask_b, key[0]), kin[1] && key_ok(mask_b, key[1])};
    const int nq = (T_ + BQ2 - 1) / BQ2;

    const size_t koff = ((size_t)b * S + c0) * HD + (size_t)h * D;
    const size_t qbase = (size_t)b * T_ * HD + (size_t)h * D;
    stage_async<D, NT>(Ks, LD, k + koff, HD, BK, S - c0, tid);
    stage_async<D, NT>(QO, LD, q + qbase, HD, BQ2, T_, tid);
    stage_async<D, NT>(QO + BQ2 * LD, LD, dout + qbase, HD, BQ2, T_, tid);
    cp_commit();
    const bf16* bias_bh =
        p.bias ? static_cast<const bf16*>(p.bias) + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh
               : nullptr;
    const bf16* ds_bh =
        static_cast<const bf16*>(p.ds) + (size_t)b * p.ds_sb + (size_t)h * p.ds_sh;

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
            stage_async<D, NT>(nb, LD, q + qbase + (size_t)tn * HD, HD, BQ2, T_ - tn, tid);
            stage_async<D, NT>(nb + BQ2 * LD, LD, dout + qbase + (size_t)tn * HD, HD, BQ2,
                               T_ - tn, tid);
            cp_commit();
        }
        for (int t = tid; t < BQ2; t += NT) {
            const bool live = t0 + t < T_;
            const size_t ri = ((size_t)b * p.H + h) * T_ + t0 + t;
            Ms[t] = live ? p.stats[ri] : 0.f;
            Ls[t] = live ? p.stats[plane + ri] : 1.f;
        }
        if (it + 1 < nq)
            cp_wait<1>();
        else
            cp_wait<0>();
        __syncthreads();
        const bf16* Qs = QO + (it & 1) * 2 * BQ2 * LD;
        const bf16* Os = Qs + BQ2 * LD;

        // s^T = k (q * qscale)^T for this warp's 16 keys, q scaled and
        // rounded in registers as launch A scaled it in shared memory
        float s[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t ak[4];
            load_a(ak, Ks, LD, wk, kk * 16, g, tq);
#pragma unroll
            for (int n = 0; n < NJ; ++n) {
                const bf16* qr = Qs + (n * 8 + g) * LD + kk * 16 + 2 * tq;
                mma(s[n], ak, scale2(ld32(qr), p.qscale), scale2(ld32(qr + 8), p.qscale));
            }
        }
        // p^T (in s) and ds^T (read back from the ds plane); zero past S
        // and past T
        float dsv[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int tt = n * 8 + 2 * tq + (e & 1), r = e >> 1;
                const int t = t0 + tt;
                float pr = 0.f, d = 0.f;
                if (kin[r] && t < T_) {
                    const float x =
                        keep[r] ? s[n][e] + bias_log2(bias_bh, S, t, kc[r]) : NEG_INF;
                    pr = exp2f(x - Ms[tt]) / Ls[tt];
                    d = __bfloat162float(ds_bh[(size_t)t * S + kc[r]]);
                }
                s[n][e] = pr;
                dsv[n][e] = d;
            }
        // dv += p^T dO, dk += ds^T q
#pragma unroll
        for (int kk = 0; kk < BQ2 / 16; ++kk) {
            uint32_t ap[4], ad[4];
            acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
            acc_to_a(ad, dsv[2 * kk], dsv[2 * kk + 1]);
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
        if (!kin[r]) continue;
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
    return (size_t)(BK + 4 * BQ2) * (D + PAD) * sizeof(bf16) + 2 * BQ2 * sizeof(float);
}

}  // namespace tc

template <typename K1, typename K2>
cudaError_t launch_pair(K1 dq_kern, size_t dq_bytes, K2 dkv_kern, size_t dkv_bytes, int nthreads,
                        const Params& p, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkv_bytes);
    if (err != cudaSuccess) return err;
    dq_kern<<<dim3((p.T + BQ - 1) / BQ, p.H, p.B), nthreads, dq_bytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkv_kern<<<dim3((p.S + BK - 1) / BK, p.H, p.B), nthreads, dkv_bytes, stream>>>(p);
    return cudaGetLastError();
}

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

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
    return launch_pair(tc::doc_bwd_dq_tc_kernel<D>, tc::dq_smem<D>(),
                       tc::doc_bwd_dkv_tc_kernel<D>, tc::dkv_smem<D>(), tc::NT, p, stream);
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
        case 64: return (int)launch_bf16<64>(p, st);
        case 96: return (int)launch_bf16<96>(p, st);
        case 128: return (int)launch_bf16<128>(p, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
