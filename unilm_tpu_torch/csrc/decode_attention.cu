// One-token decode attention over contiguous KV page runs, Hopper (sm_90a),
// plain C interface.
//
// Replaces: unilm_tpu/ops/paged_attention.py `_run_decode_kernel` (:497),
// reached through `run_decode_append_attention` (:647), in both variants:
//  - `decode_attention`: bf16 or fp32 pools (mode RUN). Sequence b's tokens
//    live in the flat pool [P, page, H*D] from page `bases[b]` on, one
//    contiguous run; the wrapper has already written this step's K/V row at
//    token L = lengths[b]; the kernel attends q over the L + 1 tokens. The
//    TPU kernel merges the new token analytically from k_new/v_new; here it
//    is read back from the pool (bit-identical, since the row was written
//    first) and, as there, its probability enters the PV sum unrounded
//    while the pool tokens' are rounded to the pool's storage type.
//  - `decode_attention_int8`: int8 pools with per-token scales in the slab
//    sidecar (mode RUN_I8, the TPU kernel's `quantized=True`). The wrapper
//    has written the quantized row and both scales; the kernel reads only
//    tokens 0..L-1 and merges the new token from the unquantized
//    k_new/v_new, as the TPU kernel does (:619-631): a read-back of the
//    int8 row would give a different result.
// Both read only the pages that hold tokens (within the TPU kernel's
// ceil(L / (chunk * page)) slabs), never the rest of the run's page budget.
//
// What bounds it on the H100: bytes. Each step reads 2 * L * D elements per
// (sequence, head) — 1 byte each for int8 plus 8 bytes of scales per token —
// and does ~4 flops per element, far below the ~295 flop/byte ridge, so HBM
// bandwidth (3.35 TB/s) is the limit once enough bytes are in flight on
// every SM: at the slice's B = 1, H = 16 that is 12.6 MB in 3.8 us, at the
// serving step's B = 8, L = 2047 int8 50 MB in 15 us. At B = 1 the launch
// and the merge's latency weigh as much as the bytes.
//
// bf16 and int8 pools: the split walk `decode_run_split_sm90` (flash
// decoding), one launch. The plan (`ops/paged_attention.decode_split_plan`,
// computed by the wrapper and passed in; tests/test_torch_decode_split.py
// pins it) gives each block one head of one sequence and one of nsplit
// ranges of whole 32-token tiles of its L + 1 (RUN) or L (RUN_I8) tokens:
// at the slice's B * H = 16, 8 splits (128 blocks, two an SM); at the
// serving step's B * H = 128 int8, one (128 blocks, one an SM). In a block,
// one producer thread TMA-loads each tile's K and V rows (the head's D
// elements of each) as boxes of a 3-D map of the pool, one copy each, into
// a ring of stages (mbarriers, 10 s trap); the tiles are aligned to the
// run's start, so only the run's last tile reaches past its last token, by
// at most 31 rows (inside its page where a page holds a multiple of 32
// rows, as the pools' 64 do; masked: the scores are set to -1e30 and no
// P V sum takes them), and rows past the pool read as zeros. Fifteen
// consumer warps, the token groups, take every ngrp-th tile:
//  - bf16 pools (and int8 ones under fp32 q), on the CUDA cores: the scores
//    with a lane per 4-byte word of the head's row (q in registers, K from
//    shared memory, conflict-free), a 31-shuffle butterfly that leaves
//    token t's score in lane t, the tile's online softmax there, then P V
//    with the lanes on the words again;
//  - int8 pools under bf16 q, on the tensor cores (mma.sync m16n8k16, f16
//    operands, fp32 sums; row 0 of A is q or p): the int8 conversions and
//    FMAs bound the CUDA-core walk at the serving step, and this path does
//    about half their instructions (the note above `mma_row0`).
// The CUDA-core token groups, the groups' merge and the pool's TMA map are
// csrc/decode_split.cuh's, shared with #11's walk over block tables
// (csrc/paged_attention.cu). The block merges its warps through shared
// memory. The nsplit blocks of a
// (sequence, head) are one thread block cluster (at most 8, the portable
// size): after a cluster barrier the first block reads the others'
// partials (m, l, acc[D]) from their shared memory, merges them in split
// order (deterministic; a split with no tokens holds m = -1e30, l = 0)
// and, in RUN_I8, adds the new token's term exactly once; a second barrier
// keeps the others until it has read them.
//
// fp32 pools keep decode_common.cuh's CUDA-core body (32 warps per
// (sequence, head), one merge through shared memory).

#include <cuda_fp16.h>

#include "decode_split.cuh"

namespace {
namespace split {

// The plan (ops/paged_attention.decode_split_plan computes it): nsplit
// splits a (sequence, head) (the cluster), ngrp token groups of one
// consumer warp, a ring of nst stages (a multiple of ngrp, so that a stage
// is always read by the same group and no barrier phase is skipped).
struct Plan {
    int nsplit, ngrp, nst;
};

// ---- int8 pools, bf16 q: the scores and P V on the tensor cores -----------
//
// One query row makes mma.sync m16n8k16 (f16 operands, f32 sums) 1/16
// useful, but it replaces the CUDA cores' conversions and FMAs, which bound
// this case. Row 0 of A is q (scores) or p (P V), rows 1-15 zero. int8
// values go to f16 exactly: the biased byte x + 128 into the mantissa of
// 1024 (a byte permute) less 1152. q and p go to f16 by rounding, exact
// for bf16 values of magnitude 2^-14 .. 65504 (below, f16 keeps them to
// 2^-25). The k index of a fragment may stand for any element as long as
// A and B agree: lane t's four k take the contiguous bytes 4t .. 4t + 3 of
// the head's row (scores: one 4-byte load) and the tokens t + 4 j (P V).

// c[0..1] (row 0, columns 2t, 2t + 1) += a b; rows 8-15 of A are zero
__device__ __forceinline__ void mma_row0(float* c, uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
    float z2 = 0.f, z3 = 0.f;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(z2), "+f"(z3)
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// (1024 + 128 + x) in each f16 half, less 1152: the two int8 x exactly
__device__ __forceinline__ uint32_t h2_less1152(uint32_t h) {
    uint32_t r;
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
    return r;
}

// one byte of shared memory, kept in program order (asm volatile)
__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ uint32_t h2_of(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, typename PT, int D, int MODE>
__host__ __device__ constexpr bool tensor_cores() {
    return MODE == RUN_I8 && sizeof(T) == 2;
}

template <typename T, typename PT, int D, int MODE>
__global__ void __launch_bounds__(THREADS, (tensor_cores<T, PT, D, MODE>() ? 1 : 2))
decode_run_split_sm90(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const DecodeArgs a,
                      const Plan pl) {
    using G = Geo<PT, D>;
    extern __shared__ __align__(128) uint8_t smem[];
    const int nst = pl.nst, ngrp = pl.ngrp, ns = pl.nsplit;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + nst;
    uint8_t* ring = smem + G::off_ring(nst);
    float* wm = reinterpret_cast<float*>(smem + G::off_w(nst));  // [NCW]
    float* wl = wm + NCW;                                          // [NCW]
    float* wacc = wl + NCW;                                        // [NCW][D]
    float* pm = wacc + NCW * D;  // the block's partial max
    float* pl_ = pm + 1;         // its sum
    float* snew = pl_ + 1;       // s_new (the cluster's first block)
    float* pacc = snew + 1;      // [D]: its PV sums

    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31;
    const int H = a.H, page = a.page;
    const int L = a.lengths[b];
    const long long row0 = (long long)a.idx[b] * page;
    long long nl = min((long long)L + (MODE == RUN ? 1 : 0), (long long)a.max_pages * page);
    nl = min(nl, a.pool_rows - row0);
    const int n = (int)max(nl, 0ll);
    // this split's tokens [t0, t1): ranges of whole tiles, equal but the last
    const int span = ((n + ns - 1) / ns + TT - 1) / TT * TT;
    const int t0 = min(n, split * span), t1 = min(n, t0 + span);
    const int ntile = (t1 - t0 + TT - 1) / TT;

    if (tid == 0) {
        for (int s = 0; s < nst; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 1);  // the warp of the stage's group
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, warp-uniform through __shfl_sync
    const int warp = __shfl_sync(FULL, tid / 32, 0);
    const T* q = static_cast<const T*>(a.q);
    constexpr int rb = G::ROW;

    if (warp == 0) {
        // producer: tile i (K and V boxes of [TT rows][D]) into
        // stage i % nst once the stage's group has read tile i - nst; the
        // last tile of the run may reach past its last token (masked),
        // rows past the pool read as zeros
        if (lane == 0) {
            sm90::prefetch_tensormap(&tk);
            sm90::prefetch_tensormap(&tv);
            for (int i = 0; i < ntile; ++i) {
                const int s = i % nst;
                if (i >= nst) sm90::mbar_wait(&empty[s], (i / nst - 1) & 1);
                sm90::mbar_arrive_expect_tx(&full[s], 2 * TT * rb);
                uint8_t* st = ring + (size_t)s * G::STAGE;
                const int row = (int)(row0 + t0 + i * TT);
                sm90::tma_load_3d(st, &tk, &full[s], 0, h, row);
                sm90::tma_load_3d(st + TT * rb, &tv, &full[s], 0, h, row);
            }
        }
    } else if (tensor_cores<T, PT, D, MODE>() && warp - 1 < ngrp) {
        const int w = warp - 1;  // token group w: tiles w, w + ngrp, ..
        const int t = lane & 3, g = lane >> 2;
        constexpr int KS = D / 16, ND = D / 8;
        const T* qh = q + ((size_t)b * H + h) * D;
        // row 0 of A: q, elements 16 ks + 4 t + 2 half ..; kept in
        // registers but at D = 128, where they are read again (from L1)
        // for each tile: sixteen more registers spill there
        auto qfrag = [&](int ks, int half) {
            const int d = 16 * ks + 4 * t + 2 * half;
            return lane < 4 ? h2_of(to_f(qh[d]), to_f(qh[d + 1])) : 0u;
        };
        uint32_t qa[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            qa[ks][0] = D == 128 ? 0u : qfrag(ks, 0);
            qa[ks][1] = D == 128 ? 0u : qfrag(ks, 1);
        }
        float acc[ND][2];  // lanes 0-3: elements 8 nd + 2 t + {0, 1}
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = 0.f;
        float m = NEG_INF, lpart = 0.f;
        const int S = a.chunk * page;
        for (int i = w; i < ntile; i += ngrp) {
            const int s = i % nst;
            sm90::mbar_wait(&full[s], (i / nst) & 1);
            const uint8_t* st = ring + (size_t)s * G::STAGE;
            const uint32_t* Kw = reinterpret_cast<const uint32_t*>(st);
            const uint8_t* Vb = st + TT * rb;
            const int tok0 = t0 + i * TT, rows = min(TT, t1 - tok0);
            const int tok = tok0 + lane;
            const bool valid = lane < rows;
            float ksc = 1.f, vsc = 1.f;
            if (valid) {  // lane t's token scales, loaded before the scores
                const int row = (int)row0 + tok, pid = row / page;
                const int slab = pid / a.chunk;
                const size_t si = (size_t)slab * 8 * S + (pid - slab * a.chunk) * page +
                                  (row - pid * page);
                ksc = a.scales[si];
                vsc = a.scales[si + S];
            }
            // scores of tokens 8 n + g (B's columns), bytes 16 ks + 4 t ..;
            // token 8 n + 2 t + e comes out in lane t's c[e] and goes to
            // lane 8 n + 2 t + e
            float sc = 0.f;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                float c[2] = {0.f, 0.f};
#pragma unroll
                for (int ks = 0; ks < KS; ++ks) {
                    const uint32_t x = Kw[(8 * n + g) * (rb / 4) + 4 * ks + t] ^ 0x80808080u;
                    mma_row0(c, D == 128 ? qfrag(ks, 0) : qa[ks][0],
                             D == 128 ? qfrag(ks, 1) : qa[ks][1],
                             h2_less1152(__byte_perm(x, 0x64u, 0x4140)),
                             h2_less1152(__byte_perm(x, 0x64u, 0x4342)));
                }
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float v = __shfl_sync(FULL, c[e], (lane & 7) >> 1);
                    if ((lane >> 3) == n && (lane & 1) == e) sc = v;
                }
            }
            sc = valid ? sc * ksc : NEG_INF;
            float mx = sc;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
            const float m_new = fmaxf(m, mx);
            const float p = valid ? expf(sc - m_new) : 0.f;
            const float alpha = expf(m - m_new);
            lpart = lpart * alpha + p;
            m = m_new;
            const float pr = round_to<T>(p * vsc);
#pragma unroll
            for (int nd = 0; nd < ND; ++nd) {
                acc[nd][0] *= alpha;
                acc[nd][1] *= alpha;
            }
            // P V over the tile's two k-steps of 16 tokens: lane t's k take
            // tokens 16 j + t + 4 {0, 1, 2, 3}; the tokens past the last
            // have p = 0 (their rows hold finite int8)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float p0 = __shfl_sync(FULL, pr, 16 * j + t);
                const float p1 = __shfl_sync(FULL, pr, 16 * j + t + 4);
                const float p2 = __shfl_sync(FULL, pr, 16 * j + t + 8);
                const float p3 = __shfl_sync(FULL, pr, 16 * j + t + 12);
                const uint32_t a0 = lane < 4 ? h2_of(p0, p1) : 0u;
                const uint32_t a2 = lane < 4 ? h2_of(p2, p3) : 0u;
                const uint32_t vr = smem_addr(Vb + (16 * j + t) * rb + g);
#pragma unroll
                for (int nd = 0; nd < ND; ++nd) {
                    // in program order next to their product: hoisted, the
                    // 4 ND byte loads would not fit the registers
                    const uint32_t v01 = lds_u8(vr + 8 * nd) | (lds_u8(vr + 4 * rb + 8 * nd) << 16);
                    const uint32_t v23 =
                        lds_u8(vr + 8 * rb + 8 * nd) | (lds_u8(vr + 12 * rb + 8 * nd) << 16);
                    mma_row0(acc[nd], a0, a2, h2_less1152((v01 ^ 0x00800080u) | 0x64006400u),
                             h2_less1152((v23 ^ 0x00800080u) | 0x64006400u));
                }
            }
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(&empty[s]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) lpart += __shfl_xor_sync(FULL, lpart, o);
        if (lane == 0) {
            wm[w] = m;
            wl[w] = lpart;
        }
        if (lane < 4) {
#pragma unroll
            for (int nd = 0; nd < ND; ++nd) {
                wacc[w * D + 8 * nd + 2 * t] = acc[nd][0];
                wacc[w * D + 8 * nd + 2 * t + 1] = acc[nd][1];
            }
        }
    } else if (!tensor_cores<T, PT, D, MODE>() && warp - 1 < ngrp) {
        // token group warp - 1: tiles warp - 1, warp - 1 + ngrp, ..
        group_walk<T, PT, D, MODE>(a, q + ((size_t)b * H + h) * D, ring, full, empty, nst,
                                   ngrp, warp - 1, lane, t0, t1, L, row0, wm, wl, wacc);
    }
    const int rank = sm90::cluster_rank();
    const size_t off = ((size_t)b * H + h) * D;  // this head's q, out rows
    if (MODE == RUN_I8 && rank == 0 && warp == 0) {
        // s_new = q . k_new, unquantized, added once, by the cluster's
        // first block
        const T* kn = static_cast<const T*>(a.knew) + off;
        float x = 0.f;
        for (int d = lane; d < D; d += 32) x += to_f(q[off + d]) * to_f(kn[d]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
        if (lane == 0) *snew = x;
    }
    __syncthreads();

    // the block's partial: its token groups merged in order
    merge_groups<D>(wm, wl, wacc, ngrp, tid, THREADS, pm, pl_, pacc);

    // the cluster's splits, merged in split order by its first block from
    // the others' shared memory; the second barrier keeps them until read
    sm90::cluster_sync();
    if (rank == 0) {
        T* out = static_cast<T*>(a.out);
        for (int d = tid; d < D; d += THREADS) {
            float M = MODE == RUN_I8 ? *snew : NEG_INF;
            for (int r = 0; r < ns; ++r) M = fmaxf(M, sm90::ld_cluster(pm, r));
            float l = 0.f, o = 0.f;
            for (int r = 0; r < ns; ++r) {
                const float e = expf(sm90::ld_cluster(pm, r) - M);
                l += sm90::ld_cluster(pl_, r) * e;
                o += sm90::ld_cluster(pacc + d, r) * e;
            }
            if constexpr (MODE == RUN_I8) {
                const float a_new = expf(*snew - M);
                l += a_new;
                o += a_new * to_f(static_cast<const T*>(a.vnew)[off + d]);
            }
            out[off + d] = from_f<T>(o / (l > 0.f ? l : 1.f));
        }
    }
    sm90::cluster_sync();
}

template <typename T, typename PT, int MODE, int D>
cudaError_t launch_d(const DecodeArgs& a, const Plan& pl, int B, cudaStream_t stream) {
    using G = Geo<PT, D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tk, tv;
    if (!pool_map<PT>(enc, &tk, a.kp, a.pool_rows, a.H, D, TT) ||
        !pool_map<PT>(enc, &tv, a.vp, a.pool_rows, a.H, D, TT))
        return cudaErrorInvalidValue;
    const int smem = G::smem(pl.nst);
    auto kern = decode_run_split_sm90<T, PT, D, MODE>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(pl.nsplit, a.H, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.nsplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, tk, tv, a, pl);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, typename PT, int MODE>
cudaError_t launch(const DecodeArgs& a, const Plan& pl, int B, int D, cudaStream_t stream) {
    if (pl.nsplit <= 0 || pl.nsplit > 8 || pl.ngrp <= 0 || pl.ngrp > NCW || pl.nst <= 0 ||
        pl.nst % pl.ngrp)
        return cudaErrorInvalidValue;
    switch (D) {
        case 64: return launch_d<T, PT, MODE, 64>(a, pl, B, stream);
        case 96: return launch_d<T, PT, MODE, 96>(a, pl, B, stream);
        case 128: return launch_d<T, PT, MODE, 128>(a, pl, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace split
}  // namespace

extern "C" {

// q [B, H, D] pre-scaled; pools [P, page, H*D] of q's type; bases/lengths
// [B] int32; out [B, H, D]. dtype: 0 = float32, 1 = bfloat16. bf16 takes
// the split walk with the plan (nsplit, ngrp, nst) of
// ops/paged_attention.decode_split_plan; fp32 ignores it.
int decode_attention(const void* q, void* k_pool, void* v_pool, const void* bases,
                     const void* lengths, void* out, int nsplit, int ngrp, int nst,
                     int B, int H, int D, int page, int max_pages, int num_pages, int dtype,
                     void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    DecodeArgs a{q, k_pool, v_pool, static_cast<const int*>(bases),
                 static_cast<const int*>(lengths), nullptr, nullptr, nullptr, out,
                 H, page, 1, max_pages, (long long)num_pages * page};
    const split::Plan pl{nsplit, ngrp, nst};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_decode<float, float, RUN>(a, B, D, st);
    if (dtype == 1)
        return (int)split::launch<__nv_bfloat16, __nv_bfloat16, RUN>(a, pl, B, D, st);
    return (int)cudaErrorInvalidValue;
}

// q, k_new, v_new [B, H, D] of type dtype (q pre-scaled); pools
// [P, page, H*D] int8; scales [P/chunk, 8, chunk*page] f32; out [B, H, D];
// the split walk's plan as for decode_attention.
int decode_attention_int8(const void* q, void* k_pool, void* v_pool, const void* bases,
                          const void* lengths, const void* scales, const void* k_new,
                          const void* v_new, void* out, int nsplit, int ngrp, int nst,
                          int B, int H, int D, int page, int chunk, int max_pages,
                          int num_pages, int dtype, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    DecodeArgs a{q, k_pool, v_pool, static_cast<const int*>(bases),
                 static_cast<const int*>(lengths), static_cast<const float*>(scales),
                 k_new, v_new, out, H, page, chunk, max_pages,
                 (long long)num_pages * page};
    const split::Plan pl{nsplit, ngrp, nst};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)split::launch<float, int8_t, RUN_I8>(a, pl, B, D, st);
    if (dtype == 1) return (int)split::launch<__nv_bfloat16, int8_t, RUN_I8>(a, pl, B, D, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
