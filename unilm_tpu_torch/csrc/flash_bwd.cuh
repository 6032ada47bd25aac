// The shared half of the flash backward: the parameters and tile geometry
// of kernels #6/#7 (csrc/flash_bwd.cu), and #7's dk/dv body, which kernel
// #8's fp32 path (csrc/flash_bwd_fused.cu) runs with FUSED set: the same
// block then also adds ds k into dq, in turn (flash_common.cuh).

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;                // query rows per tile
constexpr int BK = 64;                // keys per tile
constexpr int NWARPS = 8;             // warps per block
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;      // dq kernel: query rows per warp
constexpr int KPW = BK / NWARPS;      // dk/dv kernel: keys per warp

struct Params {
    const void *q, *k, *v, *dout, *bias;
    const float *lse, *delta;
    const int* mask;
    void *dq, *dk, *dv;
    float* dbias;
    int B, T, S, H, bias_sb, bias_sh, q_offset, limit, causal, window, acc_b;
    int* turns;  // FUSED: [B, H, nq] turn counters, zeroed; dq is fp32
    int delta_mode;  // #6 in bf16: DELTA_SWEEP, DELTA_GIVEN or DELTA_ONLY
};

// Where bf16 #6 takes delta: DELTA_SWEEP sums rowsum(p dp) in a first sweep
// over its key tiles and writes it (for #7); DELTA_GIVEN reads the caller's
// (the ring's chunks, whose delta is a whole row's); DELTA_ONLY runs the
// sweep alone and writes delta, no dq (#8's bf16 pre-pass)
enum : int { DELTA_SWEEP = 0, DELTA_GIVEN = 1, DELTA_ONLY = 2 };

// can the (q tile starting at local row t0, key tile starting at c0) pair
// hold a visible (row, col)? Conservative: never false for a visible pair.
__device__ __forceinline__ bool tile_runs(const Params& p, int t0, int c0) {
    return tile_visible(t0, BQ, c0, BK, p.q_offset, p.limit, p.causal, p.window);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col, bool col_ok) {
    return col_ok && (!p.causal || col <= row) && (p.window <= 0 || row - col < p.window);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (64-key tile, head, batch), looping over q tiles.
// With FUSED (fp32 only) the key tiles run in reverse block order and each
// q tile's ds k is added into the fp32 dq after the blocks of the later key
// tiles have added theirs.
// ---------------------------------------------------------------------------
template <typename T, int D, bool FUSED = false>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
    static_assert(!FUSED || sizeof(T) == 4, "the fused fp32 body accumulates dq in place");
    constexpr int DPL = D / 32;
    constexpr int QST = D + 4;        // padded Q/dO row stride
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);   // [BK][D]
    float* Vs = Ks + BK * D;                       // [BK][D]
    float* Qs = Vs + BK * D;                       // [BQ][QST]
    float* Os = Qs + BQ * QST;                     // [BQ][QST] dO
    float* Pm = Os + BQ * QST;                     // [BK][BQ] p
    float* Dm = Pm + BK * BQ;                      // [BK][BQ] ds (rounded)
    float* Ls = Dm + BK * BQ;                      // [BQ] lse
    float* Dl = Ls + BQ;                           // [BQ] delta

    const T* q = static_cast<const T*>(p.q);
    const T* k = static_cast<const T*>(p.k);
    const T* v = static_cast<const T*>(p.v);
    const T* dout = static_cast<const T*>(p.dout);
    const T* bias = static_cast<const T*>(p.bias);

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // FUSED: key tile j waits only on j + 1 .. (lower block indices, so
    // blocks that were dispatched before it)
    const int jt = FUSED ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
    const int c0 = jt * BK;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const int nq = (T_ + BQ - 1) / BQ;

    const size_t koff = ((size_t)b * S + c0) * HD + (size_t)h * D;
    stage_rows<T, D>(Ks, D, k + koff, HD, BK, S - c0, tid, NTHREADS);
    stage_rows<T, D>(Vs, D, v + koff, HD, BK, S - c0, tid, NTHREADS);

    const float* kw = Ks + warp * KPW * D;
    const float* vw = Vs + warp * KPW * D;
    float* pw = Pm + warp * KPW * BQ;
    float* dw = Dm + warp * KPW * BQ;
    bool in[KPW];
#pragma unroll
    for (int c = 0; c < KPW; ++c) {
        const int col = c0 + warp * KPW + c;
        in[c] = col < p.limit && (!p.mask || p.mask[(size_t)b * S + col] != 0);
    }
    const T* bias_bh = bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;

    float dk[KPW][DPL], dv[KPW][DPL];
#pragma unroll
    for (int c = 0; c < KPW; ++c)
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) dk[c][cc] = dv[c][cc] = 0.f;

    for (int i = 0; i < nq; ++i) {
        const int t0 = i * BQ;
        if (!tile_runs(p, t0, c0)) continue;  // uniform over the block
        __syncthreads();  // K/V staged, or the previous Q/dO tile consumed
        const size_t qoff = ((size_t)b * T_ + t0) * HD + (size_t)h * D;
        const int nrows = min(BQ, T_ - t0);
        stage_rows<T, D>(Qs, QST, q + qoff, HD, BQ, nrows, tid, NTHREADS);
        stage_rows<T, D>(Os, QST, dout + qoff, HD, BQ, nrows, tid, NTHREADS);
        for (int t = tid; t < BQ; t += NTHREADS) {
            const size_t ri = ((size_t)b * p.H + h) * T_ + t0 + t;
            Ls[t] = t < nrows ? p.lse[ri] : 0.f;
            Dl[t] = t < nrows ? p.delta[ri] : 0.f;
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
        const int row0 = p.q_offset + tl0, row1 = p.q_offset + tl1;
#pragma unroll
        for (int c = 0; c < KPW; ++c) {
            const int col = c0 + warp * KPW + c;
            float a = s0[c], e = s1[c];
            if (bias_bh && col < S) {
                if (live0) a += to_f(bias_bh[(size_t)tl0 * S + col]);
                if (live1) e += to_f(bias_bh[(size_t)tl1 * S + col]);
            }
            const float p0 = live0 && visible(p, row0, col, in[c]) ? expf(a - Ls[lane]) : 0.f;
            const float p1 = live1 && visible(p, row1, col, in[c]) ? expf(e - Ls[lane + 32]) : 0.f;
            pw[c * BQ + lane] = p0;
            pw[c * BQ + lane + 32] = p1;
            dw[c * BQ + lane] = round_to<T>(p0 * (dp0[c] - Dl[lane]));
            dw[c * BQ + lane + 32] = round_to<T>(p1 * (dp1[c] - Dl[lane + 32]));
        }
        __syncwarp();

        // dv[c][:] += p[c, :] @ dO, dk[c][:] += ds[c, :] @ q for this lane's dims
#pragma unroll 1
        for (int t = 0; t < BQ; t += 4) {
            float oo[4][DPL], qq[4][DPL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) {
                    oo[u][cc] = Os[(t + u) * QST + lane + 32 * cc];
                    qq[u][cc] = Qs[(t + u) * QST + lane + 32 * cc];
                }
#pragma unroll
            for (int c = 0; c < KPW; ++c) {
                const float4 w = *reinterpret_cast<const float4*>(pw + c * BQ + t);
                const float4 z = *reinterpret_cast<const float4*>(dw + c * BQ + t);
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) {
                    dv[c][cc] += w.x * oo[0][cc] + w.y * oo[1][cc] + w.z * oo[2][cc] +
                                 w.w * oo[3][cc];
                    dk[c][cc] += z.x * qq[0][cc] + z.y * qq[1][cc] + z.z * qq[2][cc] +
                                 z.w * qq[3][cc];
                }
            }
        }
        __syncwarp();

        if constexpr (FUSED) {
            // dq[t0 ..] += ds k for this key tile: warp w the rows w*RPW ..,
            // lane the dims lane + 32 cc; ds of every warp's keys (Dm)
            __syncthreads();
            float dq[RPW][DPL];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) dq[r][cc] = 0.f;
#pragma unroll 4
            for (int c = 0; c < BK; ++c) {
                float kk[DPL];
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) kk[cc] = Ks[c * D + lane + 32 * cc];
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    const float w = Dm[c * BQ + warp * RPW + r];
#pragma unroll
                    for (int cc = 0; cc < DPL; ++cc) dq[r][cc] += w * kk[cc];
                }
            }
            int* turn = p.turns + ((size_t)b * p.H + h) * nq + i;
            wait_turn(turn, key_tiles_end(t0, BQ, BK, p.q_offset, p.limit, p.causal) - 1 - jt);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const int tl = t0 + warp * RPW + r;
                if (tl >= T_) continue;
                float* dst = static_cast<float*>(p.dq) + ((size_t)b * T_ + tl) * HD +
                             (size_t)h * D + lane;
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc)
                    __stcg(dst + 32 * cc, __ldcg(dst + 32 * cc) + dq[r][cc]);
            }
            pass_turn(turn);
        }
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
            dkp[off + lane + 32 * cc] = from_f<T>(dk[c][cc]);
            dvp[off + lane + 32 * cc] = from_f<T>(dv[c][cc]);
        }
    }
}

template <int D> constexpr size_t dkv_smem() {
    return (size_t)(2 * BK * D + 2 * BQ * (D + 4) + 2 * BK * BQ + 2 * BQ) * sizeof(float);
}

template <typename T, int D, bool FUSED = false>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
    auto kern = flash_bwd_dkv_kernel<T, D, FUSED>;
    const size_t smem = dkv_smem<D>();
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.S + BK - 1) / BK, p.H, p.B);
    kern<<<grid, NTHREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace
