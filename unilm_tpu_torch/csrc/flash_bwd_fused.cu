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
// ds = p (dp - delta) in fp32 with delta = rowsum(dO * out) from the
// caller; ds rounded to the inputs' type before ds k and ds^T q (:1598-
// 1611); dv += p^T dO. Key tiles wholly outside the causal / window /
// limit band are skipped; a fully masked row contributes nothing.
//
// The TPU kernel walks a (B, H, nq, nk) grid in order on one core and keeps
// dk and dv for a whole (batch, head) resident in VMEM; it needs no
// ordering for dq because dq[i] accumulates across the inner j loop. On the
// H100 blocks run in parallel. Schedule taken here: one block per (64-key
// tile j, head, batch) keeps dk_j and dv_j in fp32 registers and walks the
// visible query rows of j in steps, and for each step recomputes s and p,
// adds p^T dO to dv, computes dp and ds, adds ds^T q to dk and forms its
// part ds k_j of dq: five products per tile pair against the split pair's
// seven, and one pass over q, k, v and dO where the split pair makes two.
//
// dq: several key tiles add into one dq row tile. They add into an fp32
// accumulator [B, T, H, D], zeroed here per call, in a fixed order: the
// block of key tile j adds its part to a row step after the blocks of key
// tiles j+1 .. end-1 (every later key tile that sees the step) have added
// theirs, counted by one turn counter per (batch, head, row step)
// (flash_common.cuh: acquire / release, L2 loads and stores, no float
// atomics). The key tile runs on blockIdx.x reversed, so a block waits only
// on blocks of lower linear index, dispatched before it: no deadlock.
// Descending j is the order in which causal blocks reach a row step when
// each walks its steps upward (key tile j reaches row tile i at its step
// i - j, key tile j+1 one step earlier), so the turns rarely stall on the
// causal path. A bf16 call ends with a second kernel that casts the
// accumulator to dq; an fp32 call accumulates in dq itself. Two runs on the
// same inputs give the same bits.
//
// What bounds it on the H100: at the train shape (B=2, T=S=2048, H=32,
// D=64, causal, bf16) the five products are 5 * B * H * T^2 * D / 2 =
// 8.6e10 operations over the lower triangle, 0.087 ms at 989 TFLOP/s,
// against 118 MB of q, k, v, dO, lse, delta in and dq, dk, dv out, 0.035
// ms at 3.35 TB/s: bound by the tensor cores. Measured there (H100 80GB
// HBM3, 700 W, chip_smoke.py's flash_bwd_fused phase): 1.23 ms with delta
// and the dq cast, against 6.38 ms for #6 + #7.
//  - bf16 (namespace tc): every product on the tensor cores (mma.sync
//    m16n8k16, fp32 accumulators, mma_common.cuh's fragments), 4 warps of
//    16 keys; a step is 64 query rows (32 at D = 128, for registers), its q
//    and dO tiles double-buffered by cp.async. p and ds leave the
//    accumulators as bf16 A operands of p^T dO and ds^T q (so p is rounded
//    to bf16 for p^T dO, as the TPU's default-precision matmul of an fp32 p
//    rounds it); ds goes through shared memory, row-major, for ds k, which
//    each warp computes for a quarter of the step's dq tile.
//  - fp32: #7's CUDA-core dk/dv body (csrc/flash_bwd.cuh) with FUSED set:
//    the same block adds ds k from its shared-memory ds plane into dq, in
//    turn; exact fp32 products.

#include <cmath>

#include "flash_bwd.cuh"
#include "mma_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

namespace tc {

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int PAD = 8;         // bf16 elements of padding per tile row
static_assert(BK == NW * 16, "a warp owns 16 keys");

// query rows per step: 64, or 32 at D = 128 (dk and dv take 128 registers)
template <int D> __host__ __device__ constexpr int rows_per_step() { return D <= 96 ? 64 : 32; }

template <int D> constexpr size_t smem_bytes() {
    constexpr int R = rows_per_step<D>();
    return (size_t)(2 * BK + 4 * R) * (D + PAD) * sizeof(bf16)  // K, V, 2 x {q, dO}
           + (size_t)R * (BK + PAD) * sizeof(bf16)               // ds [R][BK]
           + (size_t)2 * 2 * R * sizeof(float);                  // 2 x {lse, delta}
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_fused_tc_kernel(const Params p) {
    constexpr int R = rows_per_step<D>();
    constexpr int LD = D + PAD, LDS = BK + PAD;
    constexpr int NJ = R / 8, ND = D / 8, KD = D / 16;
    constexpr int RB = R / 16;          // 16-row blocks of a step
    constexpr int CW = D * RB / NW;     // dq columns per warp
    extern __shared__ float4 smem4[];
    bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [BK][LD]
    bf16* Vs = Ks + BK * LD;                    // [BK][LD]
    bf16* QO = Vs + BK * LD;                    // 2 x {q [R][LD], dO [R][LD]}
    bf16* Ds = QO + 4 * R * LD;                 // [R][LDS] ds, rounded
    float* LDl = reinterpret_cast<float*>(Ds + R * LDS);  // 2 x {lse * log2(e) [R], delta [R]}

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* v = static_cast<const bf16*>(p.v);
    const bf16* dout = static_cast<const bf16*>(p.dout);

    const int b = blockIdx.z, h = blockIdx.y;
    const int j = gridDim.x - 1 - blockIdx.x;  // key tile: see the top of the file
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int c0 = j * BK;
    const int T_ = p.T, S = p.S, H = p.H;
    const size_t HD = (size_t)H * D;
    const int wk = warp * 16;  // this warp's first local key
    // the thread's two keys and whether they may be seen at all
    const int key[2] = {c0 + wk + g, c0 + wk + g + 8};
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;
    bool kok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
        kok[r] = key[r] < p.limit && (!mask_b || mask_b[key[r]] != 0);

    // the row steps that see this key tile: a contiguous range
    const int nsteps = (T_ + R - 1) / R;
    int it_lo = nsteps, it_hi = 0;
    for (int it = 0; it < nsteps; ++it)
        if (tile_visible(it * R, R, c0, BK, p.q_offset, p.limit, p.causal, p.window)) {
            it_lo = min(it_lo, it);
            it_hi = it + 1;
        }

    const size_t koff = ((size_t)b * S + c0) * HD + (size_t)h * D;
    const size_t qbase = (size_t)b * T_ * HD + (size_t)h * D;
    stage_async<D, NT>(Ks, LD, k + koff, HD, BK, S - c0, tid);
    stage_async<D, NT>(Vs, LD, v + koff, HD, BK, S - c0, tid);
    if (it_lo < it_hi) {
        const int t0 = it_lo * R;
        stage_async<D, NT>(QO, LD, q + qbase + (size_t)t0 * HD, HD, R, T_ - t0, tid);
        stage_async<D, NT>(QO + R * LD, LD, dout + qbase + (size_t)t0 * HD, HD, R, T_ - t0, tid);
    }
    cp_commit();

    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int it = it_lo; it < it_hi; ++it) {
        const int t0 = it * R;
        const int par = (it - it_lo) & 1;
        if (it + 1 < it_hi) {  // prefetch the next step's q / dO
            const int tn = t0 + R;
            bf16* nb = QO + (par ^ 1) * 2 * R * LD;
            stage_async<D, NT>(nb, LD, q + qbase + (size_t)tn * HD, HD, R, T_ - tn, tid);
            stage_async<D, NT>(nb + R * LD, LD, dout + qbase + (size_t)tn * HD, HD, R, T_ - tn,
                               tid);
            cp_commit();
        }
        float* Ls = LDl + par * 2 * R;  // lse * log2(e)
        float* Dl = Ls + R;             // delta
        for (int t = tid; t < R; t += NT) {
            const bool live = t0 + t < T_;
            const size_t ri = ((size_t)b * H + h) * T_ + t0 + t;
            Ls[t] = live ? p.lse[ri] * LOG2E : 0.f;
            Dl[t] = live ? p.delta[ri] : 0.f;
        }
        if (it + 1 < it_hi)
            cp_wait<1>();
        else
            cp_wait<0>();
        __syncthreads();
        const bf16* Qs = QO + par * 2 * R * LD;
        const bf16* Os = Qs + R * LD;

        // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys
        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
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

        // p^T (in s) and ds^T (in dp), zero where not visible; ds rounded to
        // bf16 into the row-major ds tile for ds k
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int tt = n * 8 + 2 * tq + (e & 1), r = e >> 1;
                const int row = p.q_offset + t0 + tt, col = key[r];
                const bool ok = kok[r] && t0 + tt < T_ && (!p.causal || col <= row) &&
                                (p.window <= 0 || row - col < p.window);
                const float pr = ok ? exp2f(fmaf(s[n][e], LOG2E, -Ls[tt])) : 0.f;
                const float ds = pr * (dp[n][e] - Dl[tt]);
                s[n][e] = pr;
                dp[n][e] = ds;
                Ds[tt * LDS + wk + g + 8 * r] = __float2bfloat16(ds);
            }
        // dv += p^T dO, dk += ds^T q
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk) {
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
        __syncthreads();  // the ds tile is complete

        // this block's part of dq for the step: ds [R x BK] k [BK x D]; warp
        // w the rows (w % RB) * 16 .., the columns (w / RB) * CW ..
        const int rw = (warp % RB) * 16, cw = (warp / RB) * CW;
        float acc[CW / 8][4];
#pragma unroll
        for (int n = 0; n < CW / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            load_a(a, Ds, LDS, rw, kk * 16, g, tq);
#pragma unroll
            for (int n = 0; n < CW / 8; n += 2) {
                uint32_t bk[4];
                load_bt(bk, Ks, LD, kk * 16, cw + n * 8, lane);
                mma(acc[n], a, bk[0], bk[1]);
                mma(acc[n + 1], a, bk[2], bk[3]);
            }
        }
        int* turn = p.turns + ((size_t)b * H + h) * nsteps + it;
        wait_turn(turn, key_tiles_end(t0, R, BK, p.q_offset, p.limit, p.causal) - 1 - j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int t = t0 + rw + g + 8 * r;
            if (t >= T_) continue;
            float* dst = static_cast<float*>(p.dq) + ((size_t)b * T_ + t) * HD + (size_t)h * D +
                         cw + 2 * tq;
#pragma unroll
            for (int n = 0; n < CW / 8; ++n) {
                float2* d2 = reinterpret_cast<float2*>(dst + n * 8);
                float2 x = __ldcg(d2);
                x.x += acc[n][2 * r];
                x.y += acc[n][2 * r + 1];
                __stcg(d2, x);
            }
        }
        pass_turn(turn);  // its barrier also frees this step's buffers
    }
    cp_wait<0>();

    bf16* dkp = static_cast<bf16*>(p.dk);
    bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (key[r] >= S) continue;
        const size_t off = ((size_t)b * S + key[r]) * HD + (size_t)h * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dkp + off + n * 8) =
                __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dvp + off + n * 8) =
                __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
        }
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
    constexpr int R = rows_per_step<D>();
    const size_t acc_bytes = (size_t)p.B * p.T * p.H * D * sizeof(float);
    cudaError_t err = cudaMemsetAsync(p.dq, 0, acc_bytes, stream);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(p.turns, 0, (size_t)p.B * p.H * ((p.T + R - 1) / R) * sizeof(int),
                          stream);
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes<D>();
    auto kern = flash_bwd_fused_tc_kernel<D>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((p.S + BK - 1) / BK, p.H, p.B), NT, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n4 = acc_bytes / sizeof(float4);
    const size_t want = (n4 + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    dq_cast_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(p.dq),
                                              static_cast<uint2*>(dq), n4);
    return cudaGetLastError();
}

}  // namespace tc

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
    return tc::launch<D>(p, dq, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `mask` is int32 [B, S] or null. Scratch
// from the caller, zeroed here: `turns` int32 of at least B * H * ceil(T /
// 32) and, for bf16, `dq_acc` fp32 [B, T, H, D] (unused for fp32). q_offset
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
        case 64: return (int)launch<64>(dtype, p, dq, dq_acc, st);
        case 96: return (int)launch<96>(dtype, p, dq, dq_acc, st);
        case 128: return (int)launch<128>(dtype, p, dq, dq_acc, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
