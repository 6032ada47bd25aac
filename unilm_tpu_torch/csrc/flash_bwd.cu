// Flash attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dq (+ dbias) and dk/dv, both recomputing the probabilities from
// the forward's row log-sum-exp.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_bwd_dq_kernel` (:1235,
// launched at :1852) and `_bwd_dkv_kernel` (:1381, launched at :1885),
// reached through `_flash_backward_pallas` (:1718) from the custom VJP
// `_flash_bwd` (:1920). Same contract: q pre-scaled (so dk is the gradient
// of the unscaled k), p = exp(s - lse) under the forward's mask (causal
// with a query offset, sliding window, valid-kv prefix `limit`, int32
// key-padding mask, additive bias broadcast over [B|1, H|1, T, S]),
// dp = dO v^T, ds = p (dp - delta), but for delta: JAX's kernels take
// delta = rowsum(dO * out) from the caller, for bf16 from the bf16 out,
// and where a row is near uniform dp - delta is far below dp, so that
// rounding of out swamps the q and k gradients. Here delta is rowsum(p dp):
// the bf16 dq kernel takes it exactly in a first sweep over its key tiles
// and writes it for the dk/dv kernel, launched after it; for fp32 the
// caller passes rowsum(dO * out), equal to it to fp32 rounding. A caller
// may pass delta in bf16 too (`delta_mode` DELTA_GIVEN): the ring's
// chunks (parallel/ring_attention.py) see a part of each row's keys, so
// their delta is the whole row's, taken once by the caller; #6 then skips
// its sweep. `flash_bwd_delta` runs the sweep alone (DELTA_ONLY): kernel
// #8's exact bf16 delta (csrc/flash_bwd_fused.cu). p, dp and
// ds are fp32; ds is rounded to the inputs' type
// before ds k and ds^T q; accumulators are fp32 and outputs take the
// inputs' type (dbias is fp32). Tiles that lie wholly above the causal
// diagonal, below the window or beyond `limit` are skipped; a fully
// masked row (lse = 0, every key masked) contributes nothing. out and lse
// come from the caller, as the ring's chunked backward needs.
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
// bf16 (`flash_bwd_dq_sm90`, `flash_bwd_dkv_sm90`). What bounds them on
// the H100: their products, three for dq (q k^T, dO v^T, ds k; the delta
// sweep runs the first two again) and four for dk/dv (k q^T, v dO^T,
// p^T dO, ds^T q), 2 D operations per visible (query, key) pair each, at
// 989 TFLOP/s on the tensor cores; at the 1.3B train shape (2 x 2048 x 32
// x 64, causal) the bytes take about half that time.
// Every product runs on wgmma with fp32 accumulators in registers, and one
// exp2 per pair on the MUFU. The design, #1's (csrc/flash_fwd.cu) turned to
// the backward:
// - a producer warpgroup (setmaxnreg 40) whose one thread TMA-loads
//   (csrc/hopper.cuh, 4-D maps, rows past the end read as zeros, D = 96 as
//   three 32-column boxes with the 64-byte swizzle) the block's resident
//   tiles once and streams 64-row tiles through a ring of 4 stages with
//   full/empty mbarriers, and consumer warpgroups (setmaxnreg 232) of 64
//   rows (wgmma M) that run the products; a barrier wait that outlasts
//   10 s traps. The role is taken from a warp-uniform value (__shfl_sync):
//   from `threadIdx.x / 128` ptxas cannot tell that a warp takes one
//   branch, ignores setmaxnreg without a word and holds every thread to
//   the 168 registers of a 384-thread block, and #7 at D = 64 spilled;
//   with it, no kernel here spills, and both run faster;
// - dq: a block takes 128 query rows of one (batch, head), two consumers
//   of 64; Q and dO stay resident (reloaded per example in acc_b mode),
//   K/V tiles of 64 keys stream, twice an example: the first sweep sums
//   p dp into each row's delta (a quad's four threads hold a row), which
//   the second uses and the quad's first thread writes out. In both,
//   S = Q K^T and dP = dO V^T are SS wgmma
//   m64n64 in two commit groups, so p is taken from S (exp2 with log2 e
//   folded into each thread's two rows of lse) while dP is in flight; ds
//   is formed on the fragments and goes to bf16 in registers as the A
//   operand of dq += dS K, K read through the transpose bit, and to dbias
//   as fp32 pairs. The producer warp packs each tile's key-padding mask
//   into 64 bits, as #1's does. Key tiles of 64, not #1's 128: S, dP and
//   dq are live together, and 128-key tiles (m64n128 SS products)
//   spilled at D = 128 and gained little at D = 64;
// - dk/dv: a block takes 128 keys of one (batch, head) at D = 64 (two
//   consumers of 64 keys), 64 keys at D = 96 and 128 (one consumer in a
//   256-thread block: dk and dv alone take D fp32 a thread). K and V stay
//   resident, Q/dO tiles of 64 rows stream; the producer warp writes the
//   tile's lse (times log2 e) and delta into the stage with plain loads (a
//   TMA map of fp32 [B H, T] needs 16-byte rows, which T = 45 breaks).
//   S^T = K Q^T and dP^T = V dO^T are SS m64n64; p^T is rounded to bf16
//   as the A operand of dV += P^T dO (as kernel #8 and the TPU's
//   default-precision matmul of an fp32 p round it) and ds^T, formed from
//   the fp32 p^T and dp^T, feeds dK += dS^T Q, dO and Q read through the
//   transpose bit. The fragments are turned into bf16 pairs as they are
//   formed, so the fp32 S^T and dP^T die while the A operands grow (taking
//   dP^T after issuing dV, or starting the accumulators at -lse and
//   -delta, each held more registers and ran slower);
// - tiles: #6 walks the key tiles `flash_tile_plan` gives at 64 keys, #7
//   the q tiles of its transpose `flash_bwd_tile_plan` (ops/
//   flash_attention.py; csrc/flash_common.cuh `key_walk`, `q_walk`,
//   `tile_interior`): skipped tiles are never loaded, interior tiles skip
//   the mask arithmetic but the padding bits, boundary tiles take the full
//   predicate. A causal #6 grid starts with the last q tile and a #7 grid
//   with the first key tile, the longest walks. Outputs are written from
//   the accumulators as bf16 pairs, rows past the end unwritten.
//
// float32 keeps the CUDA-core bodies: the dq kernel below and the dk/dv
// kernel of csrc/flash_bwd.cuh, which kernel #8's fp32 path shares. The
// dq kernel mirrors the forward (each warp owns 8 query rows, each lane
// two keys of the 64-key tile, K and V rows padded so per-lane float4
// reads are conflict free, ds through shared memory for the ds k
// product); the dk/dv kernel is its transpose. Grids: (q tiles, H, B) and
// (k tiles, H, B), 8 warps per block.

#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 dq (+ dbias): one block per (64-row q tile, head, batch), or per (q
// tile, head) looping over the batch in acc_b mode.
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


// ---------------------------------------------------------------------------
// bf16: the Hopper kernels
// ---------------------------------------------------------------------------
namespace hop {

constexpr int ROWS = 64;  // rows of a consumer's tile (wgmma M) and of a streamed tile
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 384-thread blocks
constexpr float LOG2E = 1.4426950408889634f;

// acc[32] = A B^T for two [64, D] tiles A and B, both read K-major; RA and
// RB are the rows of the boxes they lie in
template <int D, int RA, int RB>
__device__ __forceinline__ void ss_product(float* acc, uint32_t a, uint32_t b) {
    using C = sm90::Cols<D>;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
        for (int kk = 0; kk < C::CW / 16; ++kk)
            sm90::wgmma_ss_n64(acc, sm90::kmajor_desc<D, RA>(a, c, kk),
                               sm90::kmajor_desc<D, RB>(b, c, kk), c | kk);
}

// acc[D / 2] += A B for A [64, 64] given as its bf16 fragments a[16] and B
// a [64, D] tile read MN-major (the transpose bit)
template <int D>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
        sm90::wgmma_rs<D>(acc, a + 4 * kk, sm90::mnmajor_desc<D, ROWS>(b, kk));
}

// The A-fragment register of the accumulator pair (row 16 w + r8 + 8 hh,
// columns 8 nn + 2 quad + {0, 1}): k-step nn / 2, m16n8k16 order
// (hopper.cuh), so a product's accumulator repacks with no shuffle.
__device__ __forceinline__ constexpr int afrag(int nn, int hh) {
    return 4 * (nn >> 1) + 2 * (nn & 1) + hh;
}

// ---- #6: dq (+ dbias) --------------------------------------------------------

template <int D> struct DqGeo : sm90::Cols<D> {
    static constexpr int NCW = 2;                  // consumer warpgroups of 64 q rows
    static constexpr int BQ = ROWS * NCW;          // q rows per block
    static constexpr int BK = ROWS;                // keys per tile
    static constexpr int NW = BK / 32;             // mask words per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = 4;                  // stages of the K/V ring
    static constexpr int Q_BYTES = BQ * D * 2;     // Q, then dO
    static constexpr int KV_BYTES = BK * D * 2;    // one K or one V tile
    static constexpr int OFF_K = 2 * Q_BYTES;      // stage s: K, then V
    static constexpr int OFF_BITS = OFF_K + NST * 2 * KV_BYTES;  // [NST][NW] mask words
    static constexpr int OFF_BAR = OFF_BITS + NST * NW * 4;  // q_full, q_empty, full[NST],
                                                             // empty[NST]
    static constexpr int SMEM = OFF_BAR + (2 + 2 * NST) * 8 + 1024;  // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__device__ __forceinline__ void dq_producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                            const CUtensorMap* tk, const CUtensorMap* tv,
                                            const Params& p, uint8_t* smem, int b0, int b1,
                                            int h, int q0, int jb, int je) {
    using G = DqGeo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + G::NST;
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::OFF_BITS);
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tdo);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
    }
    int n = 0;
    for (int b = b0; b < b1; ++b) {
        if (lane == 0) {
            // Q and dO of example b, once both consumers have read b - 1's
            if (b > b0) sm90::mbar_wait(&bars[1], (b - b0 - 1) & 1);
            sm90::mbar_arrive_expect_tx(&bars[0], 2 * G::Q_BYTES);
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(smem + c * G::BQ * G::CB, tq, &bars[0], c * G::CW, h, q0, b);
                sm90::tma_load_4d(smem + G::Q_BYTES + c * G::BQ * G::CB, tdo, &bars[0],
                                  c * G::CW, h, q0, b);
            }
        }
        // every key tile twice: the delta sweep, then the dq sweep (one of
        // them with a caller's delta, or for the delta alone)
        const int pass0 = p.delta_mode == DELTA_GIVEN ? 1 : 0;
        const int pass1 = p.delta_mode == DELTA_ONLY ? 1 : 2;
        for (int pass = pass0; pass < pass1; ++pass)
            for (int j = jb; j < je; ++j, ++n) {
                const int s = n % G::NST;
                if (n >= G::NST) sm90::mbar_wait(&empty[s], (n / G::NST - 1) & 1);
                if (p.mask) {
                    // key j BK + 32 i + bit is kept iff bit `bit` of word i is set
                    const int* mrow = p.mask + (size_t)b * p.S;
#pragma unroll
                    for (int i = 0; i < G::NW; ++i) {
                        const int col = j * G::BK + 32 * i + lane;
                        const uint32_t w =
                            __ballot_sync(FULL, col < p.S && __ldg(mrow + col) != 0);
                        if (lane == 0) bits[G::NW * s + i] = w;
                    }
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

// p = exp(s - lse), 0 where masked, and dP = dO V^T over the key tile c0 in
// the stage at k_base (V after K) for a consumer's 64 rows, on the wgmma
// accumulator fragments: entry 4 nn + 2 hh + e is row tl[hh], key
// c0 + 8 nn + 2 quad + e. `bits` are the stage's mask words.
template <int D>
__device__ __forceinline__ void dq_tile_probs(const Params& p, const uint32_t* bits,
                                              uint32_t q_base, uint32_t do_base, uint32_t k_base,
                                              const bf16* bias_bh, const int* tl,
                                              const float* lse2, int c0, int lo, int hi, int quad,
                                              float* sc, float* dp) {
    using G = DqGeo<D>;
    constexpr int BK = G::BK, NN = BK / 8;
    // S = Q K^T and dP = dO V^T, all operands K-major, in two groups: p is
    // taken from S while dP is in flight
    sm90::wgmma_fence();
    ss_product<D, G::BQ, BK>(sc, q_base, k_base);
    sm90::wgmma_commit();
    ss_product<D, G::BQ, BK>(dp, do_base, k_base + G::KV_BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();

    // this thread's BK / 4 keys: bit 2 nn + e = key c0 + 8 nn + 2 quad + e
    uint32_t keep_bits = ~0u;
    if (p.mask) {
        uint32_t ws[G::NW], all = ~0u;
#pragma unroll
        for (int i = 0; i < G::NW; ++i) all &= ws[i] = bits[i];
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
            if (tl[hh] >= p.T) continue;
            const bf16* br = bias_bh + (size_t)tl[hh] * p.S;
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
            const int row = p.q_offset + tl[hh];
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

    // p = exp(s - lse), 0 where masked, in place
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = sm90::ex2(fmaf(sc[i], LOG2E, -lse2[(i >> 1) & 1]));
    sm90::wgmma_wait<0>();
}

template <int D>
__device__ __forceinline__ void dq_consumer(const Params& p, uint8_t* smem, int cw, int b0,
                                            int b1, int h, int q0, int jb, int je) {
    using G = DqGeo<D>;
    constexpr int BK = G::BK, NN = BK / 8;  // keys per tile, 8-key groups
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + G::NST;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(smem + G::OFF_BITS);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = q0 + cw * ROWS;            // this consumer's first query row
    const int nvalid = min(ROWS, p.T - row0);   // its rows < T (may be <= 0)
    const int lo = p.q_offset + row0, hi = lo + nvalid - 1;
    int cjb = 0, cje = 0;
    if (nvalid > 0) key_walk<BK>(lo, hi, p.limit, p.causal, p.window, cjb, cje);

    const uint32_t q_base = smem_addr(smem) + cw * ROWS * G::CB;
    const uint32_t do_base = q_base + G::Q_BYTES;
    const int tl[2] = {row0 + 16 * w + r8, row0 + 16 * w + r8 + 8};  // this thread's rows
    const bf16* bias = static_cast<const bf16*>(p.bias);
    bf16* dq = static_cast<bf16*>(p.dq);
    // this kernel writes delta, which #7, launched after it, reads
    float* delta = const_cast<float*>(p.delta);
    const bool pairs = (p.S & 1) == 0;  // dbias pairs are 8-byte aligned

    int n = 0;
    for (int b = b0; b < b1; ++b) {
        float lse2[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const size_t ri = ((size_t)b * p.H + h) * p.T + tl[hh];
            lse2[hh] = tl[hh] < p.T ? p.lse[ri] * LOG2E : 0.f;
        }
        const size_t boff = (size_t)b * p.bias_sb + (size_t)h * p.bias_sh;
        const bf16* bias_bh = bias ? bias + boff : nullptr;
        float* dbias_bh =
            p.dbias ? p.dbias + (p.acc_b ? (size_t)h * p.bias_sh : boff) : nullptr;

        sm90::mbar_wait(&bars[0], (b - b0) & 1);

        // the delta sweep: delta = rowsum(p dp) in fp32, exact where
        // rowsum(dO out) from the rounded out is not (a near-uniform row's
        // dp - delta is far below dp); or the caller's
        float dlt[2] = {0.f, 0.f};
        if (p.delta_mode == DELTA_GIVEN) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
                if (tl[hh] < p.T) dlt[hh] = p.delta[((size_t)b * p.H + h) * p.T + tl[hh]];
        } else {
            for (int j = jb; j < je; ++j, ++n) {
                const int s = n % G::NST;
                sm90::mbar_wait(&full[s], (n / G::NST) & 1);
                if (j >= cjb && j < cje) {
                    float sc[BK / 2], dp[BK / 2];
                    dq_tile_probs<D>(p, bits + G::NW * s, q_base, do_base,
                                     smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES), bias_bh, tl,
                                     lse2, j * BK, lo, hi, quad, sc, dp);
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int i = 4 * nn + 2 * hh + e;
                                dlt[hh] = fmaf(sc[i], dp[i], dlt[hh]);
                            }
                }
                sm90::mbar_arrive(&empty[s]);
            }
            // a row's keys lie on the four threads of a quad
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                dlt[hh] += __shfl_xor_sync(FULL, dlt[hh], 1);
                dlt[hh] += __shfl_xor_sync(FULL, dlt[hh], 2);
                if (quad == 0 && tl[hh] < p.T)
                    delta[((size_t)b * p.H + h) * p.T + tl[hh]] = dlt[hh];
            }
        }
        if (p.delta_mode == DELTA_ONLY) {
            sm90::mbar_arrive(&bars[1]);  // this consumer has read Q and dO of example b
            continue;
        }

        // the dq sweep
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        for (int j = jb; j < je; ++j, ++n) {
            const int s = n % G::NST;
            sm90::mbar_wait(&full[s], (n / G::NST) & 1);
            if (j >= cjb && j < cje) {
                const int c0 = j * BK;
                const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
                float sc[BK / 2], dp[BK / 2];
                dq_tile_probs<D>(p, bits + G::NW * s, q_base, do_base, k_base, bias_bh, tl, lse2,
                                 c0, lo, hi, quad, sc, dp);

                // ds = p (dp - delta) in fp32 goes to dbias as it is and,
                // rounded to bf16, to the A operand of dq += dS K
                uint32_t da[BK / 4];
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn) {
                        const int i0 = 4 * nn + 2 * hh;
                        float2 ds = make_float2(sc[i0] * (dp[i0] - dlt[hh]),
                                                sc[i0 + 1] * (dp[i0 + 1] - dlt[hh]));
                        da[afrag(nn, hh)] = pack(ds.x, ds.y);
                        if (dbias_bh && tl[hh] < p.T) {
                            const int col = c0 + 8 * nn + 2 * quad;
                            float* dr = dbias_bh + (size_t)tl[hh] * p.S + col;
                            if (pairs && col < p.S) {
                                if (p.acc_b) {
                                    const float2 x = *reinterpret_cast<const float2*>(dr);
                                    ds.x += x.x;
                                    ds.y += x.y;
                                }
                                *reinterpret_cast<float2*>(dr) = ds;
                            } else {
                                if (col < p.S) dr[0] = p.acc_b ? dr[0] + ds.x : ds.x;
                                if (col + 1 < p.S) dr[1] = p.acc_b ? dr[1] + ds.y : ds.y;
                            }
                        }
                    }

                // dq += dS K: K is [keys, D], MN-major (the transpose bit)
                sm90::wgmma_fence();
                rs_product<D>(acc, da, k_base);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();
            }
            sm90::mbar_arrive(&empty[s]);
        }
        sm90::mbar_arrive(&bars[1]);  // this consumer has read Q and dO of example b

#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            if (tl[hh] >= p.T) continue;
            bf16* dst = dq + (((size_t)b * p.T + tl[hh]) * p.H + h) * D + 2 * quad;
#pragma unroll
            for (int nn = 0; nn < D / 8; ++nn)
                *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                    pack(acc[4 * nn + 2 * hh], acc[4 * nn + 2 * hh + 1]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(DqGeo<D>::THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const Params p) {
    using G = DqGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    // block -> (q tile, batch, head), or (q tile, head) in acc_b mode; a
    // causal grid runs the last q tile, which walks the most key tiles, first
    const int nq = (p.T + G::BQ - 1) / G::BQ;
    const int BH = gridDim.x / nq;
    const int bh = blockIdx.x % BH;
    int qt = blockIdx.x / BH;
    if (p.causal) qt = nq - 1 - qt;
    const int h = bh % p.H;
    const int b0 = p.acc_b ? 0 : bh / p.H, b1 = p.acc_b ? p.B : b0 + 1;
    const int q0 = qt * G::BQ;

    int jb, je;
    key_walk<G::BK>(p.q_offset + q0, p.q_offset + min(q0 + G::BQ, p.T) - 1, p.limit, p.causal,
                    p.window, jb, je);

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(&bars[0], 1);             // Q and dO loaded
        sm90::mbar_init(&bars[1], 128 * G::NCW);  // Q and dO read by every consumer
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&bars[2 + s], 1);                       // stage s loaded
            sm90::mbar_init(&bars[2 + G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp: only
    // then does it give the consumers the registers setmaxnreg asks for
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x < 32) dq_producer<D>(&tq, &tdo, &tk, &tv, p, smem, b0, b1, h, q0, jb, je);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        dq_consumer<D>(p, smem, wg - 1, b0, b1, h, q0, jb, je);
    }
}

// ---- #7: dk, dv ----------------------------------------------------------------

template <int D> struct DkvGeo : sm90::Cols<D> {
    static constexpr int NCW = D == 64 ? 2 : 1;    // consumer warpgroups of 64 keys
    static constexpr int BKB = ROWS * NCW;          // keys per block
    static constexpr int BQ = 64;                   // q rows per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = 4;                   // stages of the Q/dO ring
    static constexpr int KV_BYTES = BKB * D * 2;    // K, then V: a [64, D] tile per consumer
    static constexpr int Q_BYTES = BQ * D * 2;      // one Q or one dO tile
    static constexpr int OFF_Q = 2 * KV_BYTES;      // stage s: Q, then dO
    static constexpr int OFF_LD = OFF_Q + NST * 2 * Q_BYTES;   // [NST][2][BQ]: lse log2 e, delta
    static constexpr int OFF_BAR = OFF_LD + NST * 2 * BQ * 4;  // kv_full, full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;  // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

template <int D>
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tq, const CUtensorMap* tdo,
                                             const CUtensorMap* tk, const CUtensorMap* tv,
                                             const Params& p, uint8_t* smem, int b, int h,
                                             int c0, int ib, int ie) {
    using G = DkvGeo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    float* lds = reinterpret_cast<float*>(smem + G::OFF_LD);
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
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
    const size_t rbase = ((size_t)b * p.H + h) * p.T;
    for (int i = ib, n = 0; i < ie; ++i, ++n) {
        const int s = n % G::NST;
        if (n >= G::NST) sm90::mbar_wait(&empty[s], (n / G::NST - 1) & 1);
        float* ld = lds + s * 2 * G::BQ;
        for (int r = lane; r < G::BQ; r += 32) {
            const int tr = i * G::BQ + r;
            ld[r] = tr < p.T ? p.lse[rbase + tr] * LOG2E : 0.f;
            ld[G::BQ + r] = tr < p.T ? p.delta[rbase + tr] : 0.f;
        }
        // every lane arrives (the barrier counts 32), releasing its writes
        if (lane == 0) {
            sm90::mbar_arrive_expect_tx(&full[s], 2 * G::Q_BYTES);
            uint8_t* qst = smem + G::OFF_Q + 2 * s * G::Q_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(qst + c * G::BQ * G::CB, tq, &full[s], c * G::CW, h,
                                  i * G::BQ, b);
                sm90::tma_load_4d(qst + G::Q_BYTES + c * G::BQ * G::CB, tdo, &full[s],
                                  c * G::CW, h, i * G::BQ, b);
            }
        } else {
            sm90::mbar_arrive(&full[s]);
        }
    }
}

template <int D>
__device__ __forceinline__ void dkv_consumer(const Params& p, uint8_t* smem, int cw, int b,
                                             int h, int kc0, int ib, int ie) {
    using G = DkvGeo<D>;
    constexpr int BQ = G::BQ;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    const float* lds = reinterpret_cast<const float*>(smem + G::OFF_LD);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int c0 = kc0 + cw * ROWS;  // this consumer's first key
    int cib, cie;
    q_walk<BQ>(c0, c0 + ROWS - 1, p.T, p.q_offset, p.limit, p.causal, p.window, cib, cie);

    const uint32_t k_base = smem_addr(smem) + cw * ROWS * D * 2;
    const uint32_t v_base = k_base + G::KV_BYTES;
    const int kc[2] = {c0 + 16 * w + r8, c0 + 16 * w + r8 + 8};  // this thread's keys
    bool key_ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
        key_ok[hh] = kc[hh] < p.limit &&
                     (!p.mask || __ldg(p.mask + (size_t)b * p.S + kc[hh]) != 0);
    const bf16* bias = static_cast<const bf16*>(p.bias);
    const bf16* bias_bh = bias ? bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(&bars[0], 0);
    for (int i = ib, n = 0; i < ie; ++i, ++n) {
        const int s = n % G::NST;
        sm90::mbar_wait(&full[s], (n / G::NST) & 1);
        if (i >= cib && i < cie) {
            const int t0 = i * BQ;
            const uint32_t q_st = smem_addr(smem + G::OFF_Q + 2 * s * G::Q_BYTES);
            const uint32_t do_st = q_st + G::Q_BYTES;
            const float* ld = lds + s * 2 * BQ;

            // S^T = K Q^T and dP^T = V dO^T, [keys, rows]: sc[4 nn + 2 hh + e]
            // is key kc[hh], row t0 + 8 nn + 2 quad + e
            float sc[32], dp[32];
            sm90::wgmma_fence();
            ss_product<D, ROWS, BQ>(sc, k_base, q_st);
            ss_product<D, ROWS, BQ>(dp, v_base, do_st);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();

            if (bias_bh) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    if (kc[hh] >= p.S) continue;
#pragma unroll
                    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int tr = t0 + 8 * nn + 2 * quad + e;
                            if (tr < p.T)
                                sc[4 * nn + 2 * hh + e] +=
                                    __bfloat162float(bias_bh[(size_t)tr * p.S + kc[hh]]);
                        }
                }
            }
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
            // pair turned into a bf16 A operand as it is formed: p^T of
            // dV += P^T dO, ds^T of dK += dS^T Q
            uint32_t pa[16], da[16];
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                const float2 l2 = *reinterpret_cast<const float2*>(ld + 8 * nn + 2 * quad);
                const float2 dl = *reinterpret_cast<const float2*>(ld + BQ + 8 * nn + 2 * quad);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int i0 = 4 * nn + 2 * hh;
                    const float p0 = sm90::ex2(fmaf(sc[i0], LOG2E, -l2.x));
                    const float p1 = sm90::ex2(fmaf(sc[i0 + 1], LOG2E, -l2.y));
                    pa[afrag(nn, hh)] = pack(p0, p1);
                    da[afrag(nn, hh)] = pack(p0 * (dp[i0] - dl.x), p1 * (dp[i0 + 1] - dl.y));
                }
            }

            // dO and Q are [rows, D], MN-major (the transpose bit)
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
__global__ void __launch_bounds__(DkvGeo<D>::THREADS, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const Params p) {
    using G = DkvGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    // block -> (key tile, batch, head); key tile 0, which a causal grid's
    // q tiles all see, runs first
    const int BH = p.B * p.H;
    const int bh = blockIdx.x % BH, kt = blockIdx.x / BH;
    const int b = bh / p.H, h = bh % p.H, c0 = kt * G::BKB;
    int ib, ie;
    q_walk<G::BQ>(c0, c0 + G::BKB - 1, p.T, p.q_offset, p.limit, p.causal, p.window, ib, ie);

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(&bars[0], 1);  // K and V loaded
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&bars[1 + s], 32);                      // stage s loaded
            sm90::mbar_init(&bars[1 + G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp: only
    // then does it give the consumers the registers setmaxnreg asks for
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x < 32) dkv_producer<D>(&tq, &tdo, &tk, &tv, p, smem, b, h, c0, ib, ie);
    } else {
        if constexpr (G::NCW > 1) sm90::setmaxnreg_inc<CONSUMER_REGS>();
        dkv_consumer<D>(p, smem, wg - 1, b, h, c0, ib, ie);
    }
}

template <int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
    using G = DqGeo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tdo, tk, tv;
    if (!sm90::make_map<D>(enc, &tq, p.q, p.B, p.T, p.H, G::BQ) ||
        !sm90::make_map<D>(enc, &tdo, p.dout, p.B, p.T, p.H, G::BQ) ||
        !sm90::make_map<D>(enc, &tk, p.k, p.B, p.S, p.H, G::BK) ||
        !sm90::make_map<D>(enc, &tv, p.v, p.B, p.S, p.H, G::BK))
        return cudaErrorInvalidValue;
    auto kern = flash_bwd_dq_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    const int nq = (p.T + G::BQ - 1) / G::BQ;
    kern<<<nq * (p.acc_b ? 1 : p.B) * p.H, G::THREADS, G::SMEM, stream>>>(tq, tdo, tk, tv, p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
    using G = DkvGeo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tdo, tk, tv;
    if (!sm90::make_map<D>(enc, &tq, p.q, p.B, p.T, p.H, G::BQ) ||
        !sm90::make_map<D>(enc, &tdo, p.dout, p.B, p.T, p.H, G::BQ) ||
        !sm90::make_map<D>(enc, &tk, p.k, p.B, p.S, p.H, ROWS) ||
        !sm90::make_map<D>(enc, &tv, p.v, p.B, p.S, p.H, ROWS))
        return cudaErrorInvalidValue;
    auto kern = flash_bwd_dkv_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    const int nk = (p.S + G::BKB - 1) / G::BKB;
    kern<<<nk * p.B * p.H, G::THREADS, G::SMEM, stream>>>(tq, tdo, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace hop

template <bool DQ>
cudaError_t dispatch(int D, int dtype, const Params& p, cudaStream_t st) {
    if (dtype == 0 && p.delta_mode == DELTA_ONLY) return cudaErrorInvalidValue;
    if (dtype == 0) {  // fp32 (the caller's delta): the CUDA-core bodies
        switch (D) {
            case 64: return DQ ? launch_dq<float, 64>(p, st) : launch_dkv<float, 64>(p, st);
            case 96: return DQ ? launch_dq<float, 96>(p, st) : launch_dkv<float, 96>(p, st);
            case 128: return DQ ? launch_dq<float, 128>(p, st) : launch_dkv<float, 128>(p, st);
        }
    } else if (dtype == 1) {  // bf16: the Hopper kernels
        switch (D) {
            case 64: return DQ ? hop::launch_dq<64>(p, st) : hop::launch_dkv<64>(p, st);
            case 96: return DQ ? hop::launch_dq<96>(p, st) : hop::launch_dkv<96>(p, st);
            case 128: return DQ ? hop::launch_dq<128>(p, st) : hop::launch_dkv<128>(p, st);
        }
    }
    return cudaErrorInvalidValue;
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, const void* bias, const void* mask, void* dq, void* dk, void* dv,
        void* dbias, int B, int T_, int S, int H, int D, int bias_sb, int bias_sh,
        int q_offset, int limit, int causal, int window, int acc_b, int delta_mode, int dtype,
        void* stream) {
    if (B <= 0 || T_ <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
    if (delta_mode < DELTA_SWEEP || delta_mode > DELTA_ONLY) return (int)cudaErrorInvalidValue;
    Params p{q, k, v, dout, bias, static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<const int*>(mask), dq, dk, dv,
             static_cast<float*>(dbias), B, T_, S, H, bias_sb, bias_sh, q_offset, limit,
             causal, window, acc_b, nullptr, delta_mode};
    return (int)dispatch<DQ>(D, dtype, p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// the launch. dbias may be null (no bias, or its gradient not wanted); in
// acc_b mode the caller zero-fills it first. delta_mode (bf16): DELTA_SWEEP
// writes rowsum(p dp) to delta, DELTA_GIVEN reads the caller's; fp32
// always reads the caller's.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* bias, const void* mask,
                 void* dq, void* dbias, int B, int T_, int S, int H, int D, int bias_sb,
                 int bias_sh, int q_offset, int limit, int causal, int window, int acc_b,
                 int delta_mode, int dtype, void* stream) {
    if (delta_mode == DELTA_ONLY) return (int)cudaErrorInvalidValue;
    return run<true>(q, k, v, dout, lse, delta, bias, mask, dq, nullptr, nullptr, dbias, B,
                     T_, S, H, D, bias_sb, bias_sh, q_offset, limit, causal, window, acc_b,
                     delta_mode, dtype, stream);
}

// bf16 only: #6's delta sweep alone (no bias), delta = rowsum(p dp) written
// to `delta` [B, H, T] fp32: the exact delta kernel #8 reads
int flash_bwd_delta(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, void* delta, const void* mask, int B, int T_, int S, int H,
                    int D, int q_offset, int limit, int causal, int window, void* stream) {
    return run<true>(q, k, v, dout, lse, delta, nullptr, mask, nullptr, nullptr, nullptr,
                     nullptr, B, T_, S, H, D, 0, 0, q_offset, limit, causal, window, 0,
                     DELTA_ONLY, 1, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* bias, const void* mask,
                  void* dk, void* dv, int B, int T_, int S, int H, int D, int bias_sb,
                  int bias_sh, int q_offset, int limit, int causal, int window, int dtype,
                  void* stream) {
    return run<false>(q, k, v, dout, lse, delta, bias, mask, nullptr, dk, dv, nullptr, B, T_,
                      S, H, D, bias_sb, bias_sh, q_offset, limit, causal, window, 0,
                      DELTA_GIVEN, dtype, stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
