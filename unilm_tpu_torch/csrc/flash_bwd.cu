// Flash attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dq (+ dbias) and dk/dv, both recomputing the probabilities from
// the forward's row log-sum-exp.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_bwd_dq_kernel` (:1235) and
// `_bwd_dkv_kernel` (:1381), reached through `_flash_backward_pallas`
// (:1718) from the custom VJP `_flash_bwd` (:1920). Same contract: q
// pre-scaled (so dk is the gradient of the unscaled k), p = exp(s - lse)
// under the forward's mask (causal with a query offset, sliding window,
// valid-kv prefix `limit`, int32 key-padding mask, additive bias broadcast
// over [B|1, H|1, T, S]), dp = dO v^T, ds = p (dp - delta) with
// delta = rowsum(dO * out) computed by the caller. p, dp and ds are fp32;
// p is not rounded before p^T dO; ds is rounded to the inputs' type before
// ds k and ds^T q; accumulators are fp32 and outputs take the inputs' type
// (dbias is fp32). Tiles that lie wholly above the causal diagonal, below
// the window or beyond `limit` are skipped; a fully masked row (lse = 0,
// every key masked) contributes nothing.
//
// dbias: with a bias whose batch dim matches (or B = 1) the dq kernel
// writes ds into its own tile of dbias. A [1, H, T, S] bias with B > 1
// (`acc_b`, the TPU kernel's `bias_acc_b` mode) sums ds over the batch: one
// block per (q tile, head) loops over the batch and adds each example's ds
// into the dbias rows that only it owns, so the sum is taken in batch order
// by one thread per element. No float atomics anywhere: both kernels are
// deterministic, run to run.
//
// Layouts are the caller's: q/dO/dq [B, T, H, D], k/v/dk/dv [B, S, H, D],
// lse/delta [B, H, T] fp32, bias [Bb, Hb, T, S] with element strides
// `bias_sb`, `bias_sh` (0 = broadcast), dbias fp32 with the same strides,
// mask [B, S] int32.
//
// What bounds it on the H100: like the forward, this first version runs
// every product on the fp32 CUDA cores (at most ~67 TFLOP/s fp32, against
// 989 TFLOP/s bf16 on the tensor cores), and the backward does 2.5x the
// forward's products (dq: q k^T, dO v^T, ds k; dk/dv: q k^T, dO v^T,
// p^T dO, ds^T q). It is bound by FMA issue and shared-memory loads; wgmma
// tiles fed by TMA are later PRs' work.
// What the design does about it: the dq kernel mirrors the forward (each
// warp owns 8 query rows, each lane two keys of the 64-key tile, K and V
// rows padded so per-lane float4 reads are conflict free, q and dO rows
// read as float4 broadcasts, ds through shared memory for the ds k
// product); the dk/dv kernel is its transpose (each warp owns 8 keys, each
// lane two query rows of the 64-row tile), so one recompute of p and ds
// feeds both of its products. Grids: (q tiles, H, B) and (k tiles, H, B),
// 8 warps per block. The dk/dv kernel, the parameters and the tile geometry
// live in csrc/flash_bwd.cuh, which kernel #8's fp32 path shares.

#include "flash_bwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// dq (+ dbias): one block per (64-row q tile, head, batch), or per (q tile,
// head) looping over the batch in acc_b mode.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
    constexpr int DPL = D / 32;       // dq dims per lane
    constexpr int KST = D + 4;        // padded K/V row stride
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D]
    float* Os = Qs + BQ * D;                       // [BQ][D]   dO
    float* Ks = Os + BQ * D;                       // [BK][KST]
    float* Vs = Ks + BK * KST;                     // [BK][KST]
    float* Ps = Vs + BK * KST;                     // [NWARPS][RPW][BK] ds

    const T* q = static_cast<const T*>(p.q);
    const T* k = static_cast<const T*>(p.k);
    const T* v = static_cast<const T*>(p.v);
    const T* dout = static_cast<const T*>(p.dout);
    const T* bias = static_cast<const T*>(p.bias);
    T* dq = static_cast<T*>(p.dq);

    const int h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * BQ;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const int b_begin = p.acc_b ? 0 : blockIdx.z;
    const int b_end = p.acc_b ? p.B : blockIdx.z + 1;
    const int nrows = min(BQ, T_ - row0);
    const int nk = (S + BK - 1) / BK;

    const float* qw = Qs + warp * RPW * D;
    const float* ow = Os + warp * RPW * D;
    float* pw = Ps + warp * RPW * BK;

    for (int b = b_begin; b < b_end; ++b) {
        __syncthreads();  // previous example's tiles consumed
        const size_t qoff = ((size_t)b * T_ + row0) * HD + (size_t)h * D;
        stage_rows<T, D>(Qs, D, q + qoff, HD, BQ, nrows, tid, NTHREADS);
        stage_rows<T, D>(Os, D, dout + qoff, HD, BQ, nrows, tid, NTHREADS);

        float lse_r[RPW], delta_r[RPW], acc[RPW][DPL];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tl = row0 + warp * RPW + r;
            const size_t ri = ((size_t)b * p.H + h) * T_ + tl;
            lse_r[r] = tl < T_ ? p.lse[ri] : 0.f;
            delta_r[r] = tl < T_ ? p.delta[ri] : 0.f;
#pragma unroll
            for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
        }
        const size_t boff = (size_t)b * p.bias_sb + (size_t)h * p.bias_sh;
        const T* bias_bh = bias ? bias + boff : nullptr;
        float* dbias_bh = p.dbias ? p.dbias + (p.acc_b ? (size_t)h * p.bias_sh : boff) : nullptr;

        for (int j = 0; j < nk; ++j) {
            const int c0 = j * BK;
            if (!tile_runs(p, row0, c0)) continue;  // uniform over the block
            __syncthreads();  // Q/dO staged, or the previous K/V tile consumed
            const size_t koff = ((size_t)b * S + c0) * HD + (size_t)h * D;
            stage_rows<T, D>(Ks, KST, k + koff, HD, BK, S - c0, tid, NTHREADS);
            stage_rows<T, D>(Vs, KST, v + koff, HD, BK, S - c0, tid, NTHREADS);
            __syncthreads();

            // s = q k^T and dp = dO v^T for this lane's keys c0+lane, c0+lane+32
            float s0[RPW], s1[RPW], dp0[RPW], dp1[RPW];
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
            const bool in0 = col0 < p.limit && (!p.mask || p.mask[(size_t)b * S + col0] != 0);
            const bool in1 = col1 < p.limit && (!p.mask || p.mask[(size_t)b * S + col1] != 0);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const int tl = row0 + warp * RPW + r;
                const int row = p.q_offset + tl;
                const bool live = tl < T_;
                float a = s0[r], c = s1[r];
                if (bias_bh && live) {
                    const T* br = bias_bh + (size_t)tl * S;
                    if (col0 < S) a += to_f(br[col0]);
                    if (col1 < S) c += to_f(br[col1]);
                }
                const float p0 = live && visible(p, row, col0, in0) ? expf(a - lse_r[r]) : 0.f;
                const float p1 = live && visible(p, row, col1, in1) ? expf(c - lse_r[r]) : 0.f;
                const float ds0 = p0 * (dp0[r] - delta_r[r]);
                const float ds1 = p1 * (dp1[r] - delta_r[r]);
                if (dbias_bh && live) {
                    float* dr = dbias_bh + (size_t)tl * S;
                    if (col0 < S) dr[col0] = p.acc_b ? dr[col0] + ds0 : ds0;
                    if (col1 < S) dr[col1] = p.acc_b ? dr[col1] + ds1 : ds1;
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
                for (int u = 0; u < 4; ++u)
#pragma unroll
                    for (int cc = 0; cc < DPL; ++cc) kk[u][cc] = Ks[(c + u) * KST + lane + 32 * cc];
#pragma unroll
                for (int r = 0; r < RPW; ++r) {
                    const float4 w = *reinterpret_cast<const float4*>(pw + r * BK + c);
#pragma unroll
                    for (int cc = 0; cc < DPL; ++cc)
                        acc[r][cc] += w.x * kk[0][cc] + w.y * kk[1][cc] + w.z * kk[2][cc] +
                                      w.w * kk[3][cc];
                }
            }
            __syncwarp();
        }

#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tl = row0 + warp * RPW + r;
            if (tl >= T_) continue;
            T* dst = dq + ((size_t)b * T_ + tl) * HD + (size_t)h * D;
#pragma unroll
            for (int cc = 0; cc < DPL; ++cc) dst[lane + 32 * cc] = from_f<T>(acc[r][cc]);
        }
    }
}

template <int D> constexpr size_t dq_smem() {
    return (size_t)(2 * BQ * D + 2 * BK * (D + 4) + BQ * BK) * sizeof(float);
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
    auto kern = flash_bwd_dq_kernel<T, D>;
    const size_t smem = dq_smem<D>();
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.T + BQ - 1) / BQ, p.H, p.acc_b ? 1 : p.B);
    kern<<<grid, NTHREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch_d(int D, const Params& p, cudaStream_t st) {
    switch (D) {
        case 64: return DQ ? launch_dq<T, 64>(p, st) : launch_dkv<T, 64>(p, st);
        case 96: return DQ ? launch_dq<T, 96>(p, st) : launch_dkv<T, 96>(p, st);
        case 128: return DQ ? launch_dq<T, 128>(p, st) : launch_dkv<T, 128>(p, st);
        default: return cudaErrorInvalidValue;
    }
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, const void* bias, const void* mask, void* dq, void* dk, void* dv,
        void* dbias, int B, int T_, int S, int H, int D, int bias_sb, int bias_sh,
        int q_offset, int limit, int causal, int window, int acc_b, int dtype,
        void* stream) {
    if (B <= 0 || T_ <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
    Params p{q, k, v, dout, bias, static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<const int*>(mask), dq, dk, dv,
             static_cast<float*>(dbias), B, T_, S, H, bias_sb, bias_sh, q_offset, limit,
             causal, window, acc_b};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0)
        err = dispatch_d<DQ, float>(D, p, st);
    else if (dtype == 1)
        err = dispatch_d<DQ, __nv_bfloat16>(D, p, st);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Both return cudaGetLastError() after
// the launch. dbias may be null (no bias, or its gradient not wanted); in
// acc_b mode the caller zero-fills it first.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* bias, const void* mask,
                 void* dq, void* dbias, int B, int T_, int S, int H, int D, int bias_sb,
                 int bias_sh, int q_offset, int limit, int causal, int window, int acc_b,
                 int dtype, void* stream) {
    return run<true>(q, k, v, dout, lse, delta, bias, mask, dq, nullptr, nullptr, dbias, B,
                     T_, S, H, D, bias_sb, bias_sh, q_offset, limit, causal, window, acc_b,
                     dtype, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* bias, const void* mask,
                  void* dk, void* dv, int B, int T_, int S, int H, int D, int bias_sb,
                  int bias_sh, int q_offset, int limit, int causal, int window, int dtype,
                  void* stream) {
    return run<false>(q, k, v, dout, lse, delta, bias, mask, nullptr, dk, dv, nullptr, B, T_,
                      S, H, D, bias_sb, bias_sh, q_offset, limit, causal, window, 0, dtype,
                      stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
