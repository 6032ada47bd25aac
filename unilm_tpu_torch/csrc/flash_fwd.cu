// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_flash_kernel` (:99), reached
// through `_flash_forward` (:268) from `flash_attention` (:1979). Same
// contract: q pre-scaled, fp32 scores and online softmax, causal with a
// query offset, sliding window, valid-kv prefix (`limit`), per-key padding
// mask, additive bias broadcast over [B|1, H|1, T, S]; key tiles that lie
// wholly above the causal diagonal, below the window or beyond `limit` are
// skipped; fully masked rows give out = 0 and lse = 0 (the keep-guard, as
// the TPU kernel does). The probabilities are rounded to the storage type
// of V before the PV product, as the TPU kernel's `p.astype(v.dtype)`
// does, and the row sum adds the unrounded ones.
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D]
// (row stride H*D), bias [Bb, Hb, T, S] with element strides `bias_sb`,
// `bias_sh` (0 = broadcast), mask [B, S] int32, lse [B, H, T] float32.
//
// bf16 (`flash_fwd_sm90`). What bounds it on the H100: the two products,
// 4 T S D flops per (query, key) pair, at 989 TFLOP/s on the tensor cores;
// the softmax's exp2 per pair on the MUFU (16 a clock per SM) costs about
// as much as the products at D = 64, so the exponentials and the products
// must overlap. The design:
// - a block of 384 threads takes 128 query rows of one (batch, head): one
//   producer warpgroup, trimmed to 40 registers by setmaxnreg, and two
//   consumer warpgroups of 64 rows each, raised to 232;
// - one producer thread loads Q once and K/V tiles of 128 keys into a
//   ring of 3 stages (2 at D = 128) by TMA from 4-D tensor maps (D, H,
//   rows, B), so a box never crosses a head or a batch and rows past the
//   end read as zeros; each stage has a full and an empty mbarrier; the
//   producer warp also packs the stage's key-padding mask into 128 bits;
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//   (128-byte swizzle; D = 96 goes as three 32-column boxes with 64-byte
//   swizzle), fp32 accumulators in registers; the online softmax runs on
//   the accumulator fragments (ex2 with log2 e folded in, quad shuffles
//   for the row max); P is cast to bf16 in registers and is the A operand
//   of the register-sourced wgmma O += P V, with V read [keys, D] through
//   the descriptor's transpose bit;
// - each consumer classifies the key tiles for its 64 rows by the rule of
//   `flash_tile_plan` (ops/flash_attention.py): skipped, interior (no
//   mask arithmetic but the padding bits, and none when a tile's bits are
//   all set) or boundary (the full predicate);
// - out goes through padded shared memory as 16-byte stores, rows >= T
//   unwritten; causal grids start with the last (longest) q tile. No
//   atomics: two runs are bit-equal.
// The two consumers share the tensor cores, so while one exponentiates the
// other's products may run; nothing orders them. An explicit ping-pong
// (a turn issuing the previous tile's PV and this tile's QK^T, P carried
// across the turn) was slower at the main path's shapes and spilled at
// D = 96/128: ptxas budgets 168 registers a thread here whatever
// setmaxnreg asks for, and S, O and a carried P do not fit in that.
//
// float32 keeps the CUDA-core body `fwd::tile` (csrc/flash_fwd.cuh), which
// kernel #2's fp32 path shares: one block per (64-row q tile, head,
// batch), 4 warps.

#include "flash_fwd.cuh"
#include "hopper.cuh"

#include <cmath>

namespace {

template <int D>
__global__ void __launch_bounds__(fwd::NWARPS * 32)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               const int* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
               int T_, int S, int H, int bias_sb, int bias_sh, int q_offset, int limit,
               int causal, int window) {
    fwd::tile<float, D>(q, k, v, bias, mask, out, lse, blockIdx.z, blockIdx.y,
                        blockIdx.x * fwd::BQ, T_, S, H, bias_sb, bias_sh, q_offset, limit,
                        causal, window);
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* bias,
                        const int* mask, void* out, float* lse, int B, int T_, int S, int H,
                        int bias_sb, int bias_sh, int q_offset, int limit, int causal,
                        int window, cudaStream_t stream) {
    const size_t smem = fwd::smem_bytes<D>();
    auto kern = flash_fwd_fp32<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + fwd::BQ - 1) / fwd::BQ, H, B);
    kern<<<grid, fwd::NWARPS * 32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias), mask,
        static_cast<float*>(out), lse, T_, S, H, bias_sb, bias_sh, q_offset, limit, causal,
        window);
    return cudaGetLastError();
}

// ---- bf16: the Hopper kernel ------------------------------------------------

namespace hop {

constexpr int BQ = 128;          // query rows per block
constexpr int BK = 128;          // keys per tile
constexpr int CROWS = 64;        // query rows per consumer warpgroup (wgmma M)
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Geo : sm90::Cols<D> {     // CW, CB, NC, SWZ: the TMA boxes
    static constexpr int NST = D == 128 ? 2 : 3;       // stages of the K/V ring
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;        // one K or one V tile
    static constexpr int OST = D + 8;                  // staged out row stride, elements
    static constexpr int O_BYTES = CROWS * OST * 2;    // one consumer's staged out
    static constexpr int OFF_K = Q_BYTES;              // stage s: K, then V
    static constexpr int OFF_O = OFF_K + NST * 2 * KV_BYTES;
    static constexpr int OFF_BITS = OFF_O + 2 * O_BYTES;   // [NST][4] mask words
    static constexpr int OFF_BAR = OFF_BITS + NST * 16;    // q_full, full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + (1 + 2 * NST) * 8 + 1024;  // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
    const bf16* bias;
    const int* mask;
    bf16* out;
    float* lse;
    int T, S, H, nq, bias_sb, bias_sh, q_offset, limit, causal, window;
};

template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Params& p, uint8_t* smem,
                                         int b, int h, int q0, int jb, int je) {
    using G = Geo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::OFF_BITS);
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
        sm90::mbar_arrive_expect_tx(bars, G::Q_BYTES);
#pragma unroll
        for (int c = 0; c < G::NC; ++c)
            sm90::tma_load_4d(smem + c * BQ * G::CB, tq, bars, c * G::CW, h, q0, b);
    }
    for (int j = jb, n = 0; j < je; ++j, ++n) {
        const int s = n % G::NST;
        if (n >= G::NST) sm90::mbar_wait(&empty[s], (n / G::NST - 1) & 1);
        if (p.mask) {
            // key c0 + 32 i + bit is kept iff bit `bit` of word i is set
            const int* mrow = p.mask + (size_t)b * p.S;
            uint32_t w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int col = j * BK + 32 * i + lane;
                w[i] = __ballot_sync(FULL, col < p.S && __ldg(mrow + col) != 0);
            }
            if (lane == 0) {
#pragma unroll
                for (int i = 0; i < 4; ++i) bits[4 * s + i] = w[i];
            }
        }
        if (lane == 0) {
            // the arrive releases the mask words written above
            sm90::mbar_arrive_expect_tx(&full[s], 2 * G::KV_BYTES);
            uint8_t* kst = smem + G::OFF_K + 2 * s * G::KV_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(kst + c * BK * G::CB, tk, &full[s], c * G::CW, h, j * BK, b);
                sm90::tma_load_4d(kst + G::KV_BYTES + c * BK * G::CB, tv, &full[s], c * G::CW,
                                  h, j * BK, b);
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, int cw, int b, int h,
                                         int q0, int jb, int je) {
    using G = Geo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + G::NST;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(smem + G::OFF_BITS);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = q0 + cw * CROWS;         // this consumer's first query row
    const int nvalid = min(CROWS, p.T - row0);  // its rows < T (may be <= 0)
    const int lo = p.q_offset + row0, hi = lo + nvalid - 1;
    int cjb = 0, cje = 0;
    if (nvalid > 0) key_walk<BK>(lo, hi, p.limit, p.causal, p.window, cjb, cje);

    const uint32_t q_base = smem_addr(smem) + cw * CROWS * G::CB;
    const bf16* bias_bh =
        p.bias ? p.bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(bars, 0);
    for (int j = jb, n = 0; j < je; ++j, ++n) {
        const int s = n % G::NST;
        sm90::mbar_wait(&full[s], (n / G::NST) & 1);
        if (j >= cjb && j < cje) {
            const int c0 = j * BK;
            const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
            const uint32_t v_base = k_base + G::KV_BYTES;

            // S = Q K^T: D / 16 k-steps, both operands K-major
            float sc[64];
            sm90::wgmma_fence();
#pragma unroll
            for (int c = 0; c < G::NC; ++c)
#pragma unroll
                for (int kk = 0; kk < G::CW / 16; ++kk)
                    sm90::wgmma_ss_n128(sc, sm90::kmajor_desc<D, BQ>(q_base, c, kk),
                                        sm90::kmajor_desc<D, BK>(k_base, c, kk), c | kk);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();

            // this thread's 32 keys of the tile: bit 2n + e = key c0 + 8n + 2 quad + e
            uint32_t keep_bits = ~0u;
            if (p.mask) {
                const uint32_t w0 = bits[4 * s], w1 = bits[4 * s + 1], w2 = bits[4 * s + 2],
                               w3 = bits[4 * s + 3];
                if ((w0 & w1 & w2 & w3) != ~0u) {
                    const uint32_t ws[4] = {w0, w1, w2, w3};
                    keep_bits = 0;
#pragma unroll
                    for (int nn = 0; nn < 16; ++nn)
                        keep_bits |= ((ws[nn >> 2] >> (8 * (nn & 3) + 2 * quad)) & 3u) << (2 * nn);
                }
            }
            if (bias_bh) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int tl = row0 + 16 * w + r8 + 8 * hh;
                    if (tl >= p.T) continue;
                    const bf16* br = bias_bh + (size_t)tl * p.S;
#pragma unroll
                    for (int nn = 0; nn < 16; ++nn)
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
                    const int row = lo + 16 * w + r8 + 8 * hh;
#pragma unroll
                    for (int nn = 0; nn < 16; ++nn)
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
                for (int nn = 0; nn < 16; ++nn)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (!((keep_bits >> (2 * nn + e)) & 1u)) {
                            sc[4 * nn + e] = -INFINITY;
                            sc[4 * nn + 2 + e] = -INFINITY;
                        }
            }

            // online softmax on the fragments; a row with no kept key so far
            // has m = -inf and exponentiates against 0 (the keep-guard). Each
            // pair of probabilities is cast to bf16 as soon as it is taken:
            // pa[4 kk + r] is the A operand of the k-step of keys 16 kk ..
            // 16 kk + 15 (r = 2 (nn & 1) + hh for the keys 8 nn + 2 quad + e)
            uint32_t pa[32];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float mx = -INFINITY;
#pragma unroll
                for (int nn = 0; nn < 16; ++nn)
                    mx = fmaxf(mx, fmaxf(sc[4 * nn + 2 * hh], sc[4 * nn + 2 * hh + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
                const float m_new = fmaxf(m[hh], mx);
                const float m_use = m_new == -INFINITY ? 0.f : m_new;
                const float alpha = sm90::ex2((m[hh] - m_use) * LOG2E);
                const float ms = m_use * LOG2E;
                m[hh] = m_new;
                float sum = 0.f;
#pragma unroll
                for (int nn = 0; nn < 16; ++nn) {
                    const float p0 = sm90::ex2(fmaf(sc[4 * nn + 2 * hh], LOG2E, -ms));
                    const float p1 = sm90::ex2(fmaf(sc[4 * nn + 2 * hh + 1], LOG2E, -ms));
                    sum += p0 + p1;
                    pa[4 * (nn >> 1) + 2 * (nn & 1) + hh] = pack(p0, p1);
                }
                l[hh] = l[hh] * alpha + sum;
#pragma unroll
                for (int nn = 0; nn < D / 8; ++nn) {
                    o[4 * nn + 2 * hh] *= alpha;
                    o[4 * nn + 2 * hh + 1] *= alpha;
                }
            }

            // O += P V: V is [keys, D], MN-major (the transpose bit)
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                sm90::wgmma_rs<D>(o, pa + 4 * kk, sm90::mnmajor_desc<D, BK>(v_base, kk));
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
        }
        sm90::mbar_arrive(&empty[s]);
    }

    // out = O / l (0 for a row with no kept key), staged row-major with 16
    // bytes of padding per row, then written as 16-byte stores
    bf16* ost = reinterpret_cast<bf16*>(smem + G::OFF_O + cw * G::O_BYTES);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float lt = l[hh];
        lt += __shfl_xor_sync(FULL, lt, 1);
        lt += __shfl_xor_sync(FULL, lt, 2);
        const float inv = lt > 0.f ? 1.f / lt : 0.f;
        const int r = 16 * w + r8 + 8 * hh;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
            *reinterpret_cast<uint32_t*>(ost + r * G::OST + 8 * nn + 2 * quad) =
                pack(o[4 * nn + 2 * hh] * inv, o[4 * nn + 2 * hh + 1] * inv);
        if (quad == 0 && r < nvalid)
            p.lse[((size_t)b * p.H + h) * p.T + row0 + r] =
                lt > 0.f ? m[hh] + logf(fmaxf(lt, 1e-37f)) : 0.f;
    }
    sm90::named_sync(1 + cw, 128);
    constexpr int V8 = D / 8;  // 16-byte vectors per row
    for (int i = t; i < CROWS * V8; i += 128) {
        const int r = i / V8, c = i % V8;
        if (r >= nvalid) break;
        *reinterpret_cast<uint4*>(p.out + (((size_t)b * p.T + row0 + r) * p.H + h) * D + 8 * c) =
            *reinterpret_cast<const uint4*>(ost + r * G::OST + 8 * c);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
    using G = Geo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    // block -> (q tile, batch, head); a causal grid runs the last q tile,
    // which walks the most key tiles, first
    const int BH = gridDim.x / p.nq;
    const int bh = blockIdx.x % BH;
    int qt = blockIdx.x / BH;
    if (p.causal) qt = p.nq - 1 - qt;
    const int b = bh / p.H, h = bh % p.H, q0 = qt * BQ;

    int jb, je;
    key_walk<BK>(p.q_offset + q0, p.q_offset + min(q0 + BQ, p.T) - 1, p.limit, p.causal,
                 p.window, jb, je);

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(bars, 1);  // Q loaded
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(bars + 1 + s, 1);             // stage s loaded
            sm90::mbar_init(bars + 1 + G::NST + s, 256);  // stage s read by both consumers
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x < 32) producer<D>(&tq, &tk, &tv, p, smem, b, h, q0, jb, je);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        consumer<D>(p, smem, wg - 1, b, h, q0, jb, je);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const int* mask, void* out, float* lse, int B, int T_, int S, int H,
                   int bias_sb, int bias_sh, int q_offset, int limit, int causal, int window,
                   cudaStream_t stream) {
    using G = Geo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    if (!sm90::make_map<D>(enc, &tq, q, B, T_, H, BQ) ||
        !sm90::make_map<D>(enc, &tk, k, B, S, H, BK) ||
        !sm90::make_map<D>(enc, &tv, v, B, S, H, BK))
        return cudaErrorInvalidValue;
    Params p{static_cast<const bf16*>(bias), mask, static_cast<bf16*>(out), lse, T_, S, H,
             (T_ + BQ - 1) / BQ, bias_sb, bias_sh, q_offset, limit, causal, window};
    auto kern = flash_fwd_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    kern<<<p.nq * B * H, THREADS, G::SMEM, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace hop

typedef cudaError_t (*Launcher)(const void*, const void*, const void*, const void*, const int*,
                                void*, float*, int, int, int, int, int, int, int, int, int, int,
                                cudaStream_t);

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
              const void* mask, void* out, void* lse, int B, int T_, int S, int H,
              int D, int bias_sb, int bias_sh, int q_offset, int limit, int causal,
              int window, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (S <= 0) {  // no key: every row is out 0, lse 0
        const size_t elem = dtype == 0 ? 4 : 2;
        cudaError_t err = cudaMemsetAsync(out, 0, (size_t)B * T_ * H * D * elem, st);
        if (err == cudaSuccess) err = cudaMemsetAsync(lse, 0, (size_t)B * H * T_ * 4, st);
        return (int)err;
    }
    Launcher fn = nullptr;
    if (dtype == 0)
        fn = D == 64 ? &launch_fp32<64> : D == 96 ? &launch_fp32<96> : &launch_fp32<128>;
    else if (dtype == 1)
        fn = D == 64 ? &hop::launch<64> : D == 96 ? &hop::launch<96> : &hop::launch<128>;
    if (D != 64 && D != 96 && D != 128) fn = nullptr;
    if (!fn) return (int)cudaErrorInvalidValue;
    return (int)fn(q, k, v, bias, static_cast<const int*>(mask), out, static_cast<float*>(lse),
                   B, T_, S, H, bias_sb, bias_sh, q_offset, limit, causal, window, st);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
