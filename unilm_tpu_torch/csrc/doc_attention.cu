// Blocked document attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/doc_attention.py `_doc_fwd_kernel` (:69), launched
// by `_doc_fwd_impl` (:251) from `doc_attention` (:412): the JAX
// dispatcher's non-causal, full-kv encoder attention at S <= 2048 with a
// key-padding mask and/or a per-example bias (LayoutLMv3 at the FUNSD shape
// B=32, T=S=709, H=12, D=64; the Pix2Struct tower at <= 2048 patch slots).
// Same function, per (batch, head):
//   out = softmax(scale q k^T + bias, masked keys at -1e30) v
// in the exp2 domain: q is multiplied by scale * log2(e) and rounded to its
// own type before the product (the TPU wrapper pre-scales q in its dtype),
// the bias is multiplied by log2(e) as it is added, and a masked key takes
// the finite -1e30, so a row whose keys are all masked gets the uniform
// average of v over its S keys, not NaN. The softmax is exact, not online:
// the row max first, then p = exp2(s - max) rounded to v's type, the row
// sum adding the rounded values (the TPU kernel's exact path, :98-100).
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D] (row
// stride H*D, the projection layout, no transposes), the mask int32 [B, S]
// (nonzero = valid key) or null, the bias [., ., T, S] rows with element
// strides `bias_sb` (batch) and `bias_sh` (head), 0 for a broadcast axis.
// A head-major bias [H, B|1, T, S] (`HeadMajorBias`) is only another pair of
// strides (sh = B*T*S or T*S, sb = T*S or 0), so no separate path: the TPU
// kernel needed its own BlockSpec for it (:238). The ragged edge (T, S not
// multiples of a tile) is masked here; the TPU wrapper pads instead.
//
// What bounds it on the H100: at the FUNSD shape in bf16 the bias alone is
// 386 MB of the 526 MB that must move once, against 4.9e10 FLOP: 0.157 ms
// at 3.35 TB/s against 0.050 ms of bf16 tensor time, so it is bound by
// memory if the products run on the tensor cores. What the design does:
//  - bf16 (namespace hop, `doc_fwd_sm90`; the machinery of #10's statistics
//    launch, csrc/doc_attention_bwd.cu, and of csrc/hopper.cuh): a block per
//    128 q rows of one (batch, head), the blocks of one (batch, head)
//    neighbours in the grid, so that their K/V reads after the first come
//    from L2. Two consumer warpgroups of 64 rows (setmaxnreg 224, the role
//    through __shfl_sync) read their rows of q once from memory into
//    registers as q' (the A operand of an RS wgmma) and sweep the keys
//    twice: sweep 0 takes S = Q' K^T, adds log2(e) bias and the mask, and
//    keeps only the running row max; sweep 1 takes S again, rounds
//    p = exp2(s - max) to bf16 in registers, adds the rounded values into l
//    and feeds the same registers as the A operand of O += P V (RS wgmma,
//    V through the transpose bit). out = O / l goes out as bf16 pairs. A
//    producer warpgroup (setmaxnreg 56) takes every key tile's mask words
//    at the block's start and streams 64-key K tiles (V in sweep 1 only) by
//    TMA through a ring of full/empty mbarriers, with the matching
//    [128, 64] bias tile in the same stage in both sweeps. The bias rows
//    hold S bf16 (1418 bytes at S = 709, no multiple of 16), so no TMA map
//    takes them: they go by 16-byte cp.async (hopper.cuh `stage_plane`).
//    The tile rule is ops/doc_attention.py's `doc_fwd_tile_plan`
//    (tests/test_torch_doc_fwd_plan.py). What was tried at the FUNSD shape
//    (chip_smoke.py's doc_attn phase and experiment builds timed side by
//    side on one card, H100 80GB HBM3 at 700 W): the earlier design
//    (mma.sync over 64-row blocks, the bias and the mask read from global
//    memory in the accumulators' fragment layout) 0.9295 ms; this design
//    with each tile's mask words read inside the ring loop 0.84; the bias rows
//    resident in shared memory for both sweeps (read once, all tiles
//    issued at once, a two-stage K/V ring beside them) 0.83 against 0.79
//    streamed; deeper rings no faster; a consumer that issued the next
//    tile's product before its element-wise work 0.84-0.90 (ptxas
//    serialised its wgmma even with every wgmma outside a branch, and it
//    spilled at D = 96, 128); l summed on the tensor cores (P times a tile
//    of ones) no faster. Without a bias the kernel takes 0.54
//    and its producer alone (the K/V tiles into shared memory, no
//    products) 0.20: what holds it back is the K/V bytes every block pulls
//    through its ring (K twice, V once, per 128 rows) and each consumer's
//    element-wise work between its products.
//  - fp32: the CUDA-core body of #3 itself (encoder_attention.cuh, shared
//    with csrc/encoder_attention.cu), whole score rows in shared memory,
//    given the mask; exact fp32 products for the parity runs (the FUNSD
//    eval CLI's fp32 configuration).

#include <cmath>

#include "encoder_attention.cuh"
#include "hopper.cuh"

namespace {

using enc_fwd::LOG2E;
using enc_fwd::Params;

// ---------------------------------------------------------------------------
// bf16 inputs: two sweeps on wgmma (see the top of the file).
// ---------------------------------------------------------------------------
namespace hop {

constexpr int ROWS = 64;  // rows of a consumer's tile (wgmma M)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // 384-thread blocks
constexpr int MAXT = 2048 / 64;  // key tiles at the longest S the wrapper takes

using sm90::afrag;
using sm90::bf_lo;
using sm90::Plane;
using sm90::rs_product;
using sm90::stage_off;
using sm90::stage_plane;

// the geometry `doc_fwd_tile_plan` mirrors
template <int D> struct FwdGeo : sm90::Cols<D> {
    static constexpr int NCW = 2;                  // consumer warpgroups of 64 rows
    static constexpr int BQ = ROWS * NCW;          // q rows per block
    static constexpr int BK = 64;                  // keys per tile
    static constexpr int NW = BK / 32;             // mask words per tile
    static constexpr int THREADS = 128 * (1 + NCW);
    static constexpr int NST = D == 128 ? 3 : 4;   // stages of the K/V/bias ring
    static constexpr int KV_BYTES = BK * D * 2;    // one K or one V tile
    static constexpr int B_BYTES = BQ * Plane<BK>::BYTES_PER_ROW;  // a bias tile
    static constexpr int OFF_B = NST * 2 * KV_BYTES;        // stage s: K, then V at 0
    static constexpr int OFF_BITS = OFF_B + NST * B_BYTES;  // [MAXT][NW] mask words
    static constexpr int OFF_BAR = OFF_BITS + MAXT * NW * 4;  // full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + 2 * NST * 8 + 1024;  // + alignment slack
    static_assert(KV_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ size_t bias_base(const Params& p, int b, int h) {
    return (size_t)b * p.bias_sb + (size_t)h * p.bias_sh;
}

// Every key tile's mask words at once (warp 0 of the producer, before the
// ring starts): key 32 w + bit is kept iff bit `bit` of word w is set. The
// loads go out eight words at a time, so the block waits on one memory
// latency per 256 keys; thread 0's first arrive on a full barrier releases
// the words.
__device__ __forceinline__ void mask_words(const Params& p, int b, uint32_t* bits) {
    const int* mrow = p.mask + (size_t)b * p.S;
    const int lane = threadIdx.x & 31, nw = (p.S + 31) / 32;
    for (int w0 = 0; w0 < nw; w0 += 8) {
        int v[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            const int col = 32 * (w0 + x) + lane;
            v[x] = col < p.S ? __ldg(mrow + col) : 0;
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            const uint32_t m = __ballot_sync(FULL, v[x] != 0);
            if (lane == 0 && w0 + x < nw) bits[w0 + x] = m;
        }
    }
}

// Ring step i of 2 nk: key tile i % nk of sweep i / nk. K in both sweeps, V
// in the second; the producer warpgroup stages the [128, 64] bias tile into
// the same stage in both sweeps.
template <int D>
__device__ __forceinline__ void fwd_producer(const CUtensorMap* tk, const CUtensorMap* tv,
                                             const Params& p, uint8_t* smem, int b, int h,
                                             int q0) {
    using G = FwdGeo<D>;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* empty = full + G::NST;
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::OFF_BITS);
    const int t = threadIdx.x;
    const bf16* bias = static_cast<const bf16*>(p.bias);
    const size_t base = bias_base(p, b, h);
    const int nk = (p.S + G::BK - 1) / G::BK;
    if (t == 0) {
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
    }
    if (t < 32 && p.mask) mask_words(p, b, bits);
    for (int i = 0; i < 2 * nk; ++i) {
        const int j = i % nk, s = i % G::NST;
        const bool sweep1 = i >= nk;
        if (i >= G::NST) sm90::mbar_wait(&empty[s], (i / G::NST - 1) & 1);
        if (bias)
            stage_plane<G::BQ, G::BK>(reinterpret_cast<uint32_t*>(smem + G::OFF_B + s * G::B_BYTES),
                                      bias, base, p.S, p.T, q0, j * G::BK, t);
        sm90::cp_async_arrive(&full[s]);
        if (t == 0) {
            // the first arrive releases the mask words
            sm90::mbar_arrive_expect_tx(&full[s], (sweep1 ? 2 : 1) * G::KV_BYTES);
            uint8_t* kst = smem + 2 * s * G::KV_BYTES;
#pragma unroll
            for (int c = 0; c < G::NC; ++c) {
                sm90::tma_load_4d(kst + c * G::BK * G::CB, tk, &full[s], c * G::CW, h,
                                  j * G::BK, b);
                if (sweep1)
                    sm90::tma_load_4d(kst + G::KV_BYTES + c * G::BK * G::CB, tv, &full[s],
                                      c * G::CW, h, j * G::BK, b);
            }
        }
    }
}

template <int D>
__device__ __forceinline__ void fwd_consumer(const Params& p, uint8_t* smem, int cw, int b,
                                             int h, int q0) {
    using G = FwdGeo<D>;
    constexpr int BK = G::BK, NN = BK / 8, KS = D / 16;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* empty = full + G::NST;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(smem + G::OFF_BITS);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = q0 + cw * ROWS;  // this consumer's first query row
    const bool live = row0 < p.T;
    const int tl[2] = {row0 + 16 * w + r8, row0 + 16 * w + r8 + 8};  // this thread's rows
    const bool has_bias = p.bias != nullptr;
    const size_t base = bias_base(p, b, h);
    const size_t HD = (size_t)p.H * D;
    // each row's bias as bf16 bits: key c0 + k of stage s at
    // brow[hh][s * B_BYTES / 2 + k]
    const unsigned short* brow[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
        brow[hh] = reinterpret_cast<const unsigned short*>(smem + G::OFF_B) +
                   (tl[hh] - q0) * 2 * Plane<BK>::LDW + stage_off(base, tl[hh], p.S, 0);

    // q' = q * scale * log2 e rounded to bf16, as the A operand of S = Q' K^T
    // (m16n8k16 fragments: rows tl, columns 16 ks + 2 quad + {0, 1} + 8 x)
    uint32_t qa[4 * KS];
    const bf16* q = static_cast<const bf16*>(p.q);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int row = tl[x & 1], col = 16 * ks + 2 * quad + 8 * (x >> 1);
            qa[4 * ks + x] =
                row < p.T ? scale2(ld32(q + ((size_t)b * p.T + row) * HD + (size_t)h * D + col),
                                   p.qscale)
                          : 0u;
        }

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const int nk = (p.S + BK - 1) / BK;
    for (int i = 0; i < 2 * nk; ++i) {
        const int s = i % G::NST, j = i % nk;
        sm90::mbar_wait(&full[s], (i / G::NST) & 1);
        if (live) {
            const int c0 = j * BK;
            const uint32_t k_base = smem_addr(smem + 2 * s * G::KV_BYTES);
            float sc[BK / 2];
            sm90::wgmma_fence();
#pragma unroll
            for (int c = 0; c < G::NC; ++c)
#pragma unroll
                for (int kk = 0; kk < G::CW / 16; ++kk)
                    sm90::wgmma_rs_n64_k(sc, qa + 4 * (c * (G::CW / 16) + kk),
                                         sm90::kmajor_desc<D, BK>(k_base, c, kk), c | kk);
            sm90::wgmma_commit();
            uint32_t keep_bits = ~0u;  // bit 2 nn + e: key c0 + 8 nn + 2 quad + e
            if (p.mask) {
                const uint32_t* tb = bits + G::NW * j;
                keep_bits = 0;
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
                    keep_bits |= ((tb[nn >> 2] >> (8 * (nn & 3) + 2 * quad)) & 3u) << (2 * nn);
            }
            const int bofs = s * G::B_BYTES / 2;  // the stage's tile in brow's halfwords
            sm90::wgmma_wait<0>();

            // s in the exp2 domain: + log2(e) bias, a masked key -1e30,
            // past S -inf
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int k = 8 * nn + 2 * quad + e, col = c0 + k;
                        const bool keep = (keep_bits >> (2 * nn + e)) & 1u;
                        const float bv = has_bias ? bf_lo(brow[hh][bofs + k]) : 0.f;
                        const int x = 4 * nn + 2 * hh + e;
                        sc[x] = col >= p.S ? -INFINITY : keep ? fmaf(LOG2E, bv, sc[x]) : NEG_INF;
                    }
            if (i < nk) {  // sweep 0: the running row max
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int nn = 0; nn < NN; ++nn)
                        m[hh] = fmaxf(m[hh], fmaxf(sc[4 * nn + 2 * hh], sc[4 * nn + 2 * hh + 1]));
                if (i == nk - 1) {  // the quad's maxima: each row's max
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        m[hh] = fmaxf(m[hh], __shfl_xor_sync(FULL, m[hh], 1));
                        m[hh] = fmaxf(m[hh], __shfl_xor_sync(FULL, m[hh], 2));
                    }
                }
            } else {  // sweep 1: p = exp2(s - m) in bf16, l of the rounded p, O += P V
                uint32_t pa[BK / 4];
#pragma unroll
                for (int nn = 0; nn < NN; ++nn)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int x = 4 * nn + 2 * hh;
                        const uint32_t pp =
                            pack(sm90::ex2(sc[x] - m[hh]), sm90::ex2(sc[x + 1] - m[hh]));
                        l[hh] += bf_lo(pp) + __uint_as_float(pp & 0xffff0000u);
                        pa[afrag(nn, hh)] = pp;
                    }
                sm90::wgmma_fence();
                rs_product<D>(o, pa, k_base + G::KV_BYTES);
                sm90::wgmma_commit();
                sm90::wgmma_wait<0>();
            }
        }
        sm90::mbar_arrive(&empty[s]);
    }
    if (!live) return;

    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
        l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
        if (tl[hh] >= p.T) continue;
        const float inv = 1.f / l[hh];  // >= 1: the row max contributes exp2(0)
        bf16* dst = out + ((size_t)b * p.T + tl[hh]) * HD + (size_t)h * D + 2 * quad;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
            *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                pack(o[4 * nn + 2 * hh] * inv, o[4 * nn + 2 * hh + 1] * inv);
    }
}

template <int D>
__global__ void __launch_bounds__(FwdGeo<D>::THREADS, 1)
doc_fwd_sm90(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             const Params p) {
    using G = FwdGeo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    // block -> (q tile, batch, head), the q tiles of one (batch, head)
    // neighbours
    const int ntiles = (p.T + G::BQ - 1) / G::BQ;
    const int bh = blockIdx.x / ntiles;
    const int b = bh / p.H, h = bh % p.H, q0 = (blockIdx.x % ntiles) * G::BQ;

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        for (int s = 0; s < G::NST; ++s) {
            // stage s loaded: the producer warpgroup's copies, then the TMA
            sm90::mbar_init(&bars[s], 128 + 1);
            sm90::mbar_init(&bars[G::NST + s], 128 * G::NCW);  // stage s read
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        fwd_producer<D>(&tk, &tv, p, smem, b, h, q0);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        fwd_consumer<D>(p, smem, wg - 1, b, h, q0);
    }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    using G = FwdGeo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tk, tv;
    if (!sm90::make_map<D>(enc, &tk, p.k, B, p.S, p.H, G::BK) ||
        !sm90::make_map<D>(enc, &tv, p.v, B, p.S, p.H, G::BK))
        return cudaErrorInvalidValue;
    auto kern = doc_fwd_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    const int ntiles = (p.T + G::BQ - 1) / G::BQ;
    kern<<<ntiles * B * p.H, G::THREADS, G::SMEM, stream>>>(tk, tv, p);
    return cudaGetLastError();
}

}  // namespace hop

template <int D>
cudaError_t launch(int dtype, const Params& p, int B, cudaStream_t stream) {
    return dtype == 0 ? enc_fwd::launch<float, D>(p, B, stream) : hop::launch<D>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `scale` multiplies q k^T. `mask` is
// int32 [B, S] or null; `bias` is null or addressed as bias + b * bias_sb +
// h * bias_sh + t * S + s. Returns cudaGetLastError() after the launch.
int doc_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                 const void* mask, void* out, int B, int T_, int S, int H, int D, int bias_sb,
                 int bias_sh, float scale, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    if (S <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    const Params p{q, k, v, bias, static_cast<const int*>(mask), out, T_, S, H, bias_sb,
                   bias_sh, scale * LOG2E};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: return (int)launch<64>(dtype, p, B, st);
        case 96: return (int)launch<96>(dtype, p, B, st);
        case 128: return (int)launch<128>(dtype, p, B, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
