// The fp32 CUDA-core launches of the encoder attention backward, shared by
// csrc/encoder_attention_bwd.cu (#4) and the fp32 path of
// csrc/doc_attention_bwd.cu (#10), and `launch_pair`, which launches the
// two (both files' bf16 paths are their own wgmma launches). The design is
// described at the top of encoder_attention_bwd.cu: launch 1 (dq kernel)
// takes the exact row statistics, dq and the fp32 dbias planes; launch 2
// (dk/dv kernel) recomputes p and ds from those statistics. #10 adds the key-padding mask
// (a masked key at the finite -1e30, as in the forward) and takes the ds
// plane as launch 1's dbias planes, one (batch, head) per block; for fp32
// inputs that plane is the ds #10 emits. The scores are q k^T times
// qscale after the product, which differs from #10's q * qscale rounded
// to fp32 first only in the last bits.

#pragma once

#include "flash_common.cuh"

namespace {
namespace enc_bwd {

constexpr int BQ = 64;                // query rows per tile
constexpr int BK = 64;                // keys per tile
constexpr int NWARPS = 8;             // warps per block
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;      // dq kernel: query rows per warp
constexpr int KPW = BK / NWARPS;      // dk/dv kernel: keys per warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
    const void *q, *k, *v, *dout, *bias;
    const int* mask;  // [B, S], nonzero = valid key; null = every key valid (fp32 launches)
    void *dq, *dk, *dv;
    float* dbias;   // dq kernel: the fp32 planes it accumulates into (dbias, the partials
                    // or a ds plane), or null
    float* stats;   // [3][B][H][T]: row max m (exp2 domain), l, delta
    int B, T, S, H, bias_sb, bias_sh;
    size_t db_sz;   // element stride of the dbias planes per dq block z (batch group)
    size_t db_sh;   // ... and per head (0: the heads share one plane)
    int group;      // batch items per dq block (> 1 only for a batch-summed dbias)
    int head_sum;   // dbias summed over heads: a dq block loops over every head
    float scale, qscale;  // scale and scale * log2(e)
};

// s (exp2 domain, bias added, a masked key or one past S at -1e30) and
// dp = dO v^T of RPW query rows (this warp's, staged in qw / ow) against
// this lane's keys c0+lane, c0+lane+32 of the staged K / V tile.
template <typename T, int D>
__device__ __forceinline__ void row_tile(const Params& p, const float* qw, const float* ow,
                                         const float* Ks, const float* Vs, const T* bias_bh,
                                         const int* mask_b, int row0, int c0, int lane,
                                         float (&s0)[RPW],
                                         float (&s1)[RPW], float (&dp0)[RPW],
                                         float (&dp1)[RPW]) {
    constexpr int KST = D + 4;
#pragma unroll
    for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = dp0[r] = dp1[r] = 0.f;
    const float* k0 = Ks + lane * KST;
    const float* k1 = Ks + (lane + 32) * KST;
    const float* v0 = Vs + lane * KST;
    const float* v1 = Vs + (lane + 32) * KST;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(k0 + d);
        const float4 kb = *reinterpret_cast<const float4*>(k1 + d);
        const float4 va = *reinterpret_cast<const float4*>(v0 + d);
        const float4 vb = *reinterpret_cast<const float4*>(v1 + d);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(qw + r * D + d);
            const float4 y = *reinterpret_cast<const float4*>(ow + r * D + d);
            s0[r] += dot4(x, ka);
            s1[r] += dot4(x, kb);
            dp0[r] += dot4(y, va);
            dp1[r] += dot4(y, vb);
        }
    }
    const int col0 = c0 + lane, col1 = c0 + lane + 32;
    const bool keep0 = col0 < p.S && (!mask_b || mask_b[col0]);
    const bool keep1 = col1 < p.S && (!mask_b || mask_b[col1]);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int tl = row0 + r;
        s0[r] *= p.qscale;
        s1[r] *= p.qscale;
        if (bias_bh && tl < p.T) {
            const T* br = bias_bh + (size_t)tl * p.S;
            if (keep0) s0[r] += LOG2E * to_f(br[col0]);
            if (keep1) s1[r] += LOG2E * to_f(br[col1]);
        }
        if (!keep0) s0[r] = NEG_INF;
        if (!keep1) s1[r] = NEG_INF;
    }
}

// ---------------------------------------------------------------------------
// launch 1: row statistics, dq and dbias. One block per (64-row q tile,
// head or every head, batch group).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) enc_bwd_dq_kernel(const Params p) {
    constexpr int DPL = D / 32;       // dq dims per lane
    constexpr int KST = D + 4;        // padded K/V row stride
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D]
    float* Os = Qs + BQ * D;                       // [BQ][D]   dO
    float* Ks = Os + BQ * D;                       // [BK][KST]
    float* Vs = Ks + BK * KST;                     // [BK][KST]
    float* Ps = Vs + BK * KST;                     // [NWARPS][RPW][BK] ds, rounded

    const T* q = static_cast<const T*>(p.q);
    const T* k = static_cast<const T*>(p.k);
    const T* v = static_cast<const T*>(p.v);
    const T* dout = static_cast<const T*>(p.dout);
    const T* bias = static_cast<const T*>(p.bias);
    T* dq = static_cast<T*>(p.dq);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * BQ;
    const int wrow0 = row0 + warp * RPW;  // this warp's first row
    const int T_ = p.T, S = p.S, H = p.H;
    const size_t HD = (size_t)H * D;
    const int nrows = min(BQ, T_ - row0);
    const int nk = (S + BK - 1) / BK;
    const int b_begin = blockIdx.z * p.group, b_end = min(p.B, b_begin + p.group);
    const int h_begin = p.head_sum ? 0 : blockIdx.y;
    const int h_end = p.head_sum ? H : blockIdx.y + 1;
    // this block's slot of dbias planes
    float* db_z = p.dbias ? p.dbias + (size_t)blockIdx.z * p.db_sz : nullptr;

    const float* qw = Qs + warp * RPW * D;
    const float* ow = Os + warp * RPW * D;
    float* pw = Ps + warp * RPW * BK;
    bool first = true;  // first (batch, head) of this block: dbias is written, then added to

    for (int b = b_begin; b < b_end; ++b) {
        for (int h = h_begin; h < h_end; ++h) {
            __syncthreads();  // the previous (batch, head)'s tiles consumed
            const size_t qoff = ((size_t)b * T_ + row0) * HD + (size_t)h * D;
            stage_rows<T, D>(Qs, D, q + qoff, HD, BQ, nrows, tid, NTHREADS);
            stage_rows<T, D>(Os, D, dout + qoff, HD, BQ, nrows, tid, NTHREADS);
            const T* bias_bh =
                bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
            const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;
            const size_t kbase = (size_t)b * S * HD + (size_t)h * D;

            // ---- sweep 1: m, l, u of this warp's rows, online per lane ----
            float m[RPW], l[RPW], u[RPW];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                m[r] = NEG_INF;
                l[r] = u[r] = 0.f;
            }
            for (int j = 0; j < nk; ++j) {
                const int c0 = j * BK;
                __syncthreads();  // Q/dO staged, or the previous K/V tile consumed
                stage_rows<T, D>(Ks, KST, k + kbase + (size_t)c0 * HD, HD, BK, S - c0, tid,
                                 NTHREADS);
                stage_rows<T, D>(Vs, KST, v + kbase + (size_t)c0 * HD, HD, BK, S - c0, tid,
                                 NTHREADS);
                __syncthreads();
                float s0[RPW], s1[RPW], dp0[RPW], dp1[RPW];
                row_tile<T, D>(p, qw, ow, Ks, Vs, bias_bh, mask_b, wrow0, c0, lane, s0, s1, dp0,
                               dp1);
                const bool in0 = c0 + lane < S, in1 = c0 + lane + 32 < S;
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    const float mt =
                        fmaxf(m[r], fmaxf(in0 ? s0[r] : NEG_INF, in1 ? s1[r] : NEG_INF));
                    const float a = exp2f(m[r] - mt);  // l = u = 0 while m is NEG_INF
                    const float e0 = in0 ? exp2f(s0[r] - mt) : 0.f;
                    const float e1 = in1 ? exp2f(s1[r] - mt) : 0.f;
                    l[r] = l[r] * a + e0 + e1;
                    u[r] = u[r] * a + e0 * dp0[r] + e1 * dp1[r];
                    m[r] = mt;
                }
            }
            // merge the lanes (a fixed butterfly), then take lane 0's values
            float delta[RPW];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    const float mo = __shfl_xor_sync(FULL, m[r], o);
                    const float lo = __shfl_xor_sync(FULL, l[r], o);
                    const float uo = __shfl_xor_sync(FULL, u[r], o);
                    const float mt = fmaxf(m[r], mo);
                    const float a = exp2f(m[r] - mt), c = exp2f(mo - mt);
                    l[r] = l[r] * a + lo * c;
                    u[r] = u[r] * a + uo * c;
                    m[r] = mt;
                }
                m[r] = __shfl_sync(FULL, m[r], 0);
                l[r] = __shfl_sync(FULL, l[r], 0);  // >= 1: the max contributes exp2(0)
                delta[r] = __shfl_sync(FULL, u[r], 0) / l[r];
                const int tl = wrow0 + r;
                if (lane == 0 && tl < T_) {
                    const size_t ri = ((size_t)b * H + h) * T_ + tl;
                    const size_t plane = (size_t)p.B * H * T_;
                    p.stats[ri] = m[r];
                    p.stats[plane + ri] = l[r];
                    p.stats[2 * plane + ri] = delta[r];
                }
            }

            // ---- sweep 2: p, ds, dbias, dq ----------------------------------
            float* db_bh = db_z ? db_z + (size_t)h * p.db_sh : nullptr;
            float acc[RPW][DPL];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
                for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
            for (int j = 0; j < nk; ++j) {
                const int c0 = j * BK;
                __syncthreads();  // the previous K/V tile consumed
                stage_rows<T, D>(Ks, KST, k + kbase + (size_t)c0 * HD, HD, BK, S - c0, tid,
                                 NTHREADS);
                stage_rows<T, D>(Vs, KST, v + kbase + (size_t)c0 * HD, HD, BK, S - c0, tid,
                                 NTHREADS);
                __syncthreads();
                float s0[RPW], s1[RPW], dp0[RPW], dp1[RPW];
                row_tile<T, D>(p, qw, ow, Ks, Vs, bias_bh, mask_b, wrow0, c0, lane, s0, s1, dp0,
                               dp1);
                const int col0 = c0 + lane, col1 = c0 + lane + 32;
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    const int tl = wrow0 + r;
                    const bool live = tl < T_;
                    const float p0 = live && col0 < S ? exp2f(s0[r] - m[r]) / l[r] : 0.f;
                    const float p1 = live && col1 < S ? exp2f(s1[r] - m[r]) / l[r] : 0.f;
                    const float ds0 = p0 * (dp0[r] - delta[r]);
                    const float ds1 = p1 * (dp1[r] - delta[r]);
                    if (db_bh && live) {
                        float* dr = db_bh + (size_t)tl * S;
                        if (col0 < S) dr[col0] = first ? ds0 : dr[col0] + ds0;
                        if (col1 < S) dr[col1] = first ? ds1 : dr[col1] + ds1;
                    }
                    pw[r * BK + lane] = round_to<T>(ds0);
                    pw[r * BK + lane + 32] = round_to<T>(ds1);
                }
                __syncwarp();

                // acc[r][:] += ds[r, :] @ K for this lane's dims
#pragma unroll 1
                for (int c = 0; c < BK; c += 4) {
                    float kk[4][DPL];
#pragma unroll
                    for (int w = 0; w < 4; ++w)
#pragma unroll
                        for (int cc = 0; cc < DPL; ++cc)
                            kk[w][cc] = Ks[(c + w) * KST + lane + 32 * cc];
#pragma unroll
                    for (int r = 0; r < RPW; ++r) {
                        const float4 z = *reinterpret_cast<const float4*>(pw + r * BK + c);
#pragma unroll
                        for (int cc = 0; cc < DPL; ++cc)
                            acc[r][cc] += z.x * kk[0][cc] + z.y * kk[1][cc] +
                                          z.z * kk[2][cc] + z.w * kk[3][cc];
                    }
                }
                __syncwarp();
            }

#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const int tl = wrow0 + r;
                if (tl >= T_) continue;
                T* dst = dq + ((size_t)b * T_ + tl) * HD + (size_t)h * D;
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc)
                    dst[lane + 32 * cc] = from_f<T>(acc[r][cc] * p.scale);
            }
            first = false;
        }
    }
}

// ---------------------------------------------------------------------------
// launch 2: dk, dv. One block per (64-key tile, head, batch), looping over
// the q tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) enc_bwd_dkv_kernel(const Params p) {
    constexpr int DPL = D / 32;
    constexpr int QST = D + 4;        // padded Q/dO row stride
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);   // [BK][D]
    float* Vs = Ks + BK * D;                       // [BK][D]
    float* Qs = Vs + BK * D;                       // [BQ][QST]
    float* Os = Qs + BQ * QST;                     // [BQ][QST] dO
    float* Pm = Os + BQ * QST;                     // [BK][BQ] p, rounded to dO's type
    float* Dm = Pm + BK * BQ;                      // [BK][BQ] ds, rounded to k's type
    float* Ms = Dm + BK * BQ;                      // [BQ] m
    float* Ls = Ms + BQ;                           // [BQ] l
    float* Dl = Ls + BQ;                           // [BQ] delta

    const T* q = static_cast<const T*>(p.q);
    const T* k = static_cast<const T*>(p.k);
    const T* v = static_cast<const T*>(p.v);
    const T* dout = static_cast<const T*>(p.dout);
    const T* bias = static_cast<const T*>(p.bias);

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int c0 = blockIdx.x * BK;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const int nq = (T_ + BQ - 1) / BQ;
    const size_t plane = (size_t)p.B * p.H * T_;

    const size_t koff = ((size_t)b * S + c0) * HD + (size_t)h * D;
    stage_rows<T, D>(Ks, D, k + koff, HD, BK, S - c0, tid, NTHREADS);
    stage_rows<T, D>(Vs, D, v + koff, HD, BK, S - c0, tid, NTHREADS);

    const float* kw = Ks + warp * KPW * D;
    const float* vw = Vs + warp * KPW * D;
    float* pw = Pm + warp * KPW * BQ;
    float* dw = Dm + warp * KPW * BQ;
    const T* bias_bh = bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;

    float dk[KPW][DPL], dv[KPW][DPL];
#pragma unroll
    for (int c = 0; c < KPW; ++c)
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) dk[c][cc] = dv[c][cc] = 0.f;

    for (int i = 0; i < nq; ++i) {
        const int t0 = i * BQ;
        __syncthreads();  // K/V staged, or the previous Q/dO tile consumed
        const size_t qoff = ((size_t)b * T_ + t0) * HD + (size_t)h * D;
        const int nrows = min(BQ, T_ - t0);
        stage_rows<T, D>(Qs, QST, q + qoff, HD, BQ, nrows, tid, NTHREADS);
        stage_rows<T, D>(Os, QST, dout + qoff, HD, BQ, nrows, tid, NTHREADS);
        for (int t = tid; t < BQ; t += NTHREADS) {
            const size_t ri = ((size_t)b * p.H + h) * T_ + t0 + t;
            Ms[t] = t < nrows ? p.stats[ri] : 0.f;
            Ls[t] = t < nrows ? p.stats[plane + ri] : 1.f;
            Dl[t] = t < nrows ? p.stats[2 * plane + ri] : 0.f;
        }
        __syncthreads();

        // s = k q^T and dp = v dO^T for this warp's keys, rows t0+lane, t0+lane+32
        float s0[KPW], s1[KPW], dp0[KPW], dp1[KPW];
#pragma unroll
        for (int c = 0; c < KPW; ++c) s0[c] = s1[c] = dp0[c] = dp1[c] = 0.f;
        const float* q0 = Qs + lane * QST;
        const float* q1 = Qs + (lane + 32) * QST;
        const float* o0 = Os + lane * QST;
        const float* o1 = Os + (lane + 32) * QST;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(q0 + d);
            const float4 qb = *reinterpret_cast<const float4*>(q1 + d);
            const float4 oa = *reinterpret_cast<const float4*>(o0 + d);
            const float4 ob = *reinterpret_cast<const float4*>(o1 + d);
#pragma unroll
            for (int c = 0; c < KPW; ++c) {
                const float4 x = *reinterpret_cast<const float4*>(kw + c * D + d);
                const float4 y = *reinterpret_cast<const float4*>(vw + c * D + d);
                s0[c] += dot4(x, qa);
                s1[c] += dot4(x, qb);
                dp0[c] += dot4(y, oa);
                dp1[c] += dot4(y, ob);
            }
        }

        const int tl0 = t0 + lane, tl1 = t0 + lane + 32;
        const bool live0 = tl0 < T_, live1 = tl1 < T_;
#pragma unroll
        for (int c = 0; c < KPW; ++c) {
            const int col = c0 + warp * KPW + c;
            const bool in = col < S;
            const bool keep = in && (!mask_b || mask_b[col]);
            float a = s0[c] * p.qscale, e = s1[c] * p.qscale;
            if (bias_bh && keep) {
                if (live0) a += LOG2E * to_f(bias_bh[(size_t)tl0 * S + col]);
                if (live1) e += LOG2E * to_f(bias_bh[(size_t)tl1 * S + col]);
            }
            if (!keep) a = e = NEG_INF;
            const float p0 = live0 && in ? exp2f(a - Ms[lane]) / Ls[lane] : 0.f;
            const float p1 = live1 && in ? exp2f(e - Ms[lane + 32]) / Ls[lane + 32] : 0.f;
            pw[c * BQ + lane] = round_to<T>(p0);
            pw[c * BQ + lane + 32] = round_to<T>(p1);
            dw[c * BQ + lane] = round_to<T>(p0 * (dp0[c] - Dl[lane]));
            dw[c * BQ + lane + 32] = round_to<T>(p1 * (dp1[c] - Dl[lane + 32]));
        }
        __syncwarp();

        // dv[c][:] += p[c, :] @ dO, dk[c][:] += ds[c, :] @ q for this lane's dims
#pragma unroll 1
        for (int t = 0; t < BQ; t += 4) {
            float oo[4][DPL], qq[4][DPL];
#pragma unroll
            for (int w = 0; w < 4; ++w)
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) {
                    oo[w][cc] = Os[(t + w) * QST + lane + 32 * cc];
                    qq[w][cc] = Qs[(t + w) * QST + lane + 32 * cc];
                }
#pragma unroll
            for (int c = 0; c < KPW; ++c) {
                const float4 x = *reinterpret_cast<const float4*>(pw + c * BQ + t);
                const float4 z = *reinterpret_cast<const float4*>(dw + c * BQ + t);
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) {
                    dv[c][cc] += x.x * oo[0][cc] + x.y * oo[1][cc] + x.z * oo[2][cc] +
                                 x.w * oo[3][cc];
                    dk[c][cc] += z.x * qq[0][cc] + z.y * qq[1][cc] + z.z * qq[2][cc] +
                                 z.w * qq[3][cc];
                }
            }
        }
        __syncwarp();
    }

    T* dkp = static_cast<T*>(p.dk);
    T* dvp = static_cast<T*>(p.dv);
#pragma unroll
    for (int c = 0; c < KPW; ++c) {
        const int col = c0 + warp * KPW + c;
        if (col >= S) continue;
        const size_t off = ((size_t)b * S + col) * HD + (size_t)h * D;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) {
            dkp[off + lane + 32 * cc] = from_f<T>(dk[c][cc] * p.scale);
            dvp[off + lane + 32 * cc] = from_f<T>(dv[c][cc]);
        }
    }
}

template <int D> constexpr size_t dq_smem() {
    return (size_t)(2 * BQ * D + 2 * BK * (D + 4) + BQ * BK) * sizeof(float);
}
template <int D> constexpr size_t dkv_smem() {
    return (size_t)(2 * BK * D + 2 * BQ * (D + 4) + 2 * BK * BQ + 3 * BQ) * sizeof(float);
}

// launch 1 over (q tiles, H or 1 when head_sum, groups), then launch 2 over
// (key tiles, H, B)
template <typename K1, typename K2>
cudaError_t launch_pair(K1 dq_kern, size_t dq_bytes, K2 dkv_kern, size_t dkv_bytes, int nthreads,
                        const Params& p, int groups, cudaStream_t stream) {
    cudaError_t err =
        cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkv_bytes);
    if (err != cudaSuccess) return err;
    dim3 grid_dq((p.T + BQ - 1) / BQ, p.head_sum ? 1 : p.H, groups);
    dq_kern<<<grid_dq, nthreads, dq_bytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 grid_dkv((p.S + BK - 1) / BK, p.H, p.B);
    dkv_kern<<<grid_dkv, nthreads, dkv_bytes, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Params& p, int groups, cudaStream_t stream) {
    return launch_pair(enc_bwd_dq_kernel<float, D>, dq_smem<D>(), enc_bwd_dkv_kernel<float, D>,
                       dkv_smem<D>(), NTHREADS, p, groups, stream);
}

}  // namespace enc_bwd
}  // namespace
