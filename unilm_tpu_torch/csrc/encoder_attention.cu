// Fused encoder attention for Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_vit_kernel` (:580), reached
// through `_vit_forward` (:632) from `fused_encoder_attention` (:701), the
// JAX dispatcher's encoder hot path (BEiT / DiT / ViT shapes: non-causal,
// full kv, no key-padding mask, S <= 2048). Same function:
//   out = softmax(scale * q k^T + bias) v      per (batch, head)
// with an EXACT softmax: p = exp2(s - row max) in the exp2 domain (scale *
// log2(e) applied to the fp32 scores, the bias multiplied by log2(e) as it
// is added), rounded to the storage type of V before the PV product, and
// the row sum adds the rounded values, as the TPU kernel's exact (fp32)
// path does (`p = exp2(s - m).astype(v.dtype)`, :622-623). On bf16 inputs
// the TPU kernel takes a "fast" path that also rounds s - m to bf16
// (:605, 618-623); the port keeps the exact rounding (ROADMAP Queue 3,
// "Kept on purpose"). No lse is written.
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D] (row
// stride H*D, the natural projection layout, so no transposes), bias
// [Bb, Hb, T, S] with element strides `bias_sb`, `bias_sh` (0 = broadcast).
// The TPU wrapper pads T and S to multiples of 8 with a NEG_INF bias; here
// nothing is padded in memory: rows and keys past the end read as zeros
// from TMA and keys past S are masked to -inf.
//
// What bounds it on the H100: bytes. At BEiT-B (B=128, T=S=197, H=12,
// D=64, bf16) q, k, v and out are 155 MB, 0.046 ms at 3.35 TB/s, against
// 1.5e10 FLOP, 0.015 ms at 989 TFLOP/s. So K and V of a (batch, head)
// should come from device memory once, the products run on the tensor
// cores, and the [1, H, T, S] bias, which every batch item shares (0.93
// MB at BEiT-B), should not be read again for each item.
//
// bf16 (`encoder_attn_sm90`), the design of #1 (csrc/flash_fwd.cu; PTX in
// hopper.cuh), non-causal and without a mask:
//  - a persistent grid of about one block per SM, each block on one head
//    and a strided set of batch items: one producer warpgroup
//    (setmaxnreg 40) and two consumer warpgroups (232), the role from a
//    warp-uniform value (__shfl_sync), so ptxas honours setmaxnreg;
//  - one producer thread TMA-loads, through 4-D maps over the natural
//    [B, rows, H, D] layouts (rows past the end read as zeros), each q
//    group of 128 rows (a ring of 2; one 64-row tile per consumer) and the
//    group's K/V tiles of 128 keys (a ring of up to 3 stages, full/empty
//    mbarriers). A K/V tile read again for a group after the first comes
//    from L2;
//  - S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//    the softmax runs on the accumulator fragments (ex2, scale * log2 e
//    applied to the fp32 scores), p is rounded to bf16 in registers, the
//    row sum adds the rounded values, and P is the A operand of O += P V
//    (RS wgmma, V through the transpose bit). S <= 128 is one tile: the
//    exact softmax of whole rows, the twin's rounding. Longer rows take
//    the tiles in turn with #1's online softmax (p against the running
//    max, l and O rescaled when it moves): the exact softmax's result
//    within the bf16 tolerance, not its bits. Whole rows of up to 256
//    keys in registers (two n128 products, 128 fp32 scores a thread) were
//    built and measured: ptxas spilled them at every D (92-1748 bytes, the
//    wgmma serialised), and they ran slower (PERF.md, Findings);
//  - the bias: a bias without a batch dim is copied once into shared
//    memory as the head's [T, S] plane (rows padded to 8 mod 64 elements,
//    so a fragment's rows fall in distinct banks) where it fits beside 2
//    K/V stages (BEiT-B's 197 x 197), and every batch item of the block
//    reads it there; otherwise (a per-example bias, or BEiT-L/384's 577 x
//    577) it is read from L2. Either way it goes into the accumulators as
//    bias / scale before the product adds q k^T, its loads issued ahead of
//    the stage's wait;
//  - out is written from the fragments as 4-byte pairs, rows < T only.
// ops/flash_attention.py `encoder_tile_plan` mirrors the row and key plan
// (tests/test_torch_hopper_plans.py).
//
// float32 keeps the CUDA-core body of encoder_attention.cuh (shared with
// the fp32 path of csrc/doc_attention.cu, #9): whole score rows in shared
// memory, 16 query rows per block, 4 warps.

#include "encoder_attention.cuh"
#include "hopper.cuh"

namespace {
namespace hop {

constexpr int GROUP = 128;       // q rows per group: one 64-row tile per consumer
constexpr int CROWS = 64;        // q rows per consumer warpgroup (wgmma M)
constexpr int BK = 128;          // keys per K/V tile (the S = Q K^T product's wgmma N)
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int NQ = 2;            // stages of the q ring
constexpr int NST_MAX = 3;       // stages of the K/V ring, at most
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may opt into
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Geo : sm90::Cols<D> {  // CW, CB, NC, SWZ: the TMA boxes
    static constexpr int Q_BYTES = GROUP * D * 2;  // one q group
    static constexpr int KV_BYTES = BK * D * 2;    // one K or one V tile
    static constexpr int OFF_K = NQ * Q_BYTES;     // stage s: K, then V
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
};

struct Params {
    const bf16* bias;
    bf16* out;
    int B, T, S, H, bias_sb, bias_sh;
    float qscale;   // scale * log2(e)
    float bscale;   // 1 / scale
    int nbh;        // blocks per head: block x takes head x % H, batch items x / H + k nbh
    int nst;        // stages of the K/V ring
    int wb;         // row stride of the resident bias plane, elements; 0: no plane
    int off_plane, off_bar;  // byte offsets in shared memory
};

// Shared memory: the q ring, the K/V ring of p.nst stages, the bias plane
// [T, wb] of the block's head (a bias without a batch dim, where it fits),
// the barriers q_full[NQ], q_empty[NQ], full[NST_MAX], empty[NST_MAX].
constexpr int NBARS = 2 * NQ + 2 * NST_MAX;

struct Bars {
    uint64_t *q_full, *q_empty, *full, *empty;
    __device__ Bars(uint8_t* smem, const Params& p) {
        uint64_t* b = reinterpret_cast<uint64_t*>(smem + p.off_bar);
        q_full = b;
        q_empty = b + NQ;
        full = b + 2 * NQ;
        empty = b + 2 * NQ + NST_MAX;
    }
};

// The producer thread: for each batch item of the block's head and each
// q group, the group's q rows, then its K/V tiles.
template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Params& p,
                                         uint8_t* smem) {
    using G = Geo<D>;
    const Bars bar(smem, p);
    sm90::prefetch_tensormap(tq);
    sm90::prefetch_tensormap(tk);
    sm90::prefetch_tensormap(tv);
    const int ng = (p.T + GROUP - 1) / GROUP, nt = (p.S + BK - 1) / BK;
    const int h = blockIdx.x % p.H;
    int n = 0, qn = 0;  // K/V tiles and q groups loaded so far
    for (int b = blockIdx.x / p.H; b < p.B; b += p.nbh) {
        for (int g = 0; g < ng; ++g, ++qn) {
            const int qs = qn % NQ;
            if (qn >= NQ) sm90::mbar_wait(&bar.q_empty[qs], (qn / NQ - 1) & 1);
            sm90::mbar_arrive_expect_tx(&bar.q_full[qs], G::Q_BYTES);
#pragma unroll
            for (int cc = 0; cc < G::NC; ++cc)
                sm90::tma_load_4d(smem + qs * G::Q_BYTES + cc * GROUP * G::CB, tq,
                                  &bar.q_full[qs], cc * G::CW, h, g * GROUP, b);
            for (int j = 0; j < nt; ++j, ++n) {
                const int s = n % p.nst;
                if (n >= p.nst) sm90::mbar_wait(&bar.empty[s], (n / p.nst - 1) & 1);
                sm90::mbar_arrive_expect_tx(&bar.full[s], 2 * G::KV_BYTES);
                uint8_t* kst = smem + G::OFF_K + 2 * s * G::KV_BYTES;
#pragma unroll
                for (int cc = 0; cc < G::NC; ++cc) {
                    sm90::tma_load_4d(kst + cc * BK * G::CB, tk, &bar.full[s], cc * G::CW, h,
                                      j * BK, b);
                    sm90::tma_load_4d(kst + G::KV_BYTES + cc * BK * G::CB, tv, &bar.full[s],
                                      cc * G::CW, h, j * BK, b);
                }
            }
        }
    }
}

// One consumer's 64 rows of a group against the K/V tile in stage s (keys
// c0 .. c0 + 127, landed once `full[s]` completes this parity): the
// scores, the softmax update of (m, l, o) and O += P V.
template <int D>
__device__ __forceinline__ void tile(const Params& p, uint8_t* smem, const Bars& bar,
                                     uint32_t q_base, int s, uint32_t parity, int c0, int row0,
                                     const bf16* bias_bh, bool first, float* o, float* m,
                                     float* l) {
    using G = Geo<D>;
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
    const uint32_t v_base = k_base + G::KV_BYTES;

    // The bias goes into the accumulators as bias / scale, and the products
    // add q k^T onto it; its loads are issued before the stage's wait, so
    // they are in flight while the tile lands. From the resident plane a
    // pair of keys is one 4-byte read, from device memory (through L2) one
    // read a key. Rows past T read row T - 1's bias (their output is not
    // written); keys past S start at 0 (K's rows there read as zeros).
    float sc[64];
    if (bias_bh) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = min(row0 + 16 * w + r8 + 8 * hh, p.T - 1);
            if (p.wb) {
                const bf16* br = reinterpret_cast<const bf16*>(smem + p.off_plane) +
                                 r * p.wb + c0 + 2 * quad;
#pragma unroll
                for (int nn = 0; nn < 16; ++nn) {  // keys c0 + 8 nn + 2 quad + {0, 1}
                    float2 f = make_float2(0.f, 0.f);
                    if (c0 + 8 * nn + 2 * quad < p.S)  // the row holds the pair's second key
                        f = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(br + 8 * nn));
                    sc[4 * nn + 2 * hh] = f.x * p.bscale;
                    sc[4 * nn + 2 * hh + 1] = f.y * p.bscale;
                }
            } else {
                const bf16* br = bias_bh + (size_t)r * p.S;
#pragma unroll
                for (int nn = 0; nn < 16; ++nn)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = c0 + 8 * nn + 2 * quad + e;
                        sc[4 * nn + 2 * hh + e] =
                            col < p.S ? __bfloat162float(br[col]) * p.bscale : 0.f;
                    }
            }
        }
    }
    sm90::mbar_wait(&bar.full[s], parity);

    // S (+)= Q K^T: D / 16 k-steps, both operands K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < G::NC; ++cc)
#pragma unroll
        for (int kk = 0; kk < G::CW / 16; ++kk)
            sm90::wgmma_ss_n128(sc, sm90::kmajor_desc<D, GROUP>(q_base, cc, kk),
                                sm90::kmajor_desc<D, BK>(k_base, cc, kk),
                                bias_bh != nullptr || (cc | kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();

    // exp2-domain scores, (q k^T + bias / scale) scale log2(e); -inf past S
#pragma unroll
    for (int nn = 0; nn < 16; ++nn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const bool in = c0 + 8 * nn + 2 * quad + e < p.S;
            sc[4 * nn + e] = in ? sc[4 * nn + e] * p.qscale : -INFINITY;
            sc[4 * nn + 2 + e] = in ? sc[4 * nn + 2 + e] * p.qscale : -INFINITY;
        }

    // the softmax update on the fragments: every tile holds a key < S, so
    // its row max is finite. p = exp2(s - m) is rounded to bf16 as it is
    // taken and l adds the rounded values; on a later tile the max may move,
    // and l and O are rescaled first. pa[4 kk + r] is the A operand of the
    // k-step of keys 16 kk .. 16 kk + 15 (r = 2 (nn & 1) + hh)
    uint32_t pa[32];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int nn = 0; nn < 16; ++nn)
            mx = fmaxf(mx, fmaxf(sc[4 * nn + 2 * hh], sc[4 * nn + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = first ? mx : fmaxf(m[hh], mx);
        float sum = 0.f;
#pragma unroll
        for (int nn = 0; nn < 16; ++nn) {
            const uint32_t pk = pack(sm90::ex2(sc[4 * nn + 2 * hh] - m_new),
                                     sm90::ex2(sc[4 * nn + 2 * hh + 1] - m_new));
            sum += __uint_as_float(pk << 16) + __uint_as_float(pk & 0xffff0000u);
            pa[4 * (nn >> 1) + 2 * (nn & 1) + hh] = pk;
        }
        if (first) {
            l[hh] = sum;
        } else {
            const float alpha = sm90::ex2(m[hh] - m_new);
            l[hh] = l[hh] * alpha + sum;
#pragma unroll
            for (int nn = 0; nn < D / 8; ++nn) {
                o[4 * nn + 2 * hh] *= alpha;
                o[4 * nn + 2 * hh + 1] *= alpha;
            }
        }
        m[hh] = m_new;
    }
    if (first) {
#pragma unroll
        for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    }

    // O += P V: V is [keys, D], MN-major (the transpose bit); its rows past
    // S read as zeros and their p is 0
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_rs<D>(o, pa + 4 * kk, sm90::mnmajor_desc<D, BK>(v_base, kk));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
}

template <int D>
__device__ __forceinline__ void consumer(const Params& p, uint8_t* smem, int cw) {
    using G = Geo<D>;
    const Bars bar(smem, p);
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int ng = (p.T + GROUP - 1) / GROUP, nt = (p.S + BK - 1) / BK;
    const int h = blockIdx.x % p.H;
    int n = 0, qn = 0;  // K/V tiles and q groups consumed so far

    if (p.wb) {  // the head's bias plane, once: every batch item shares it
        const bf16* src = p.bias + (size_t)h * p.bias_sh;
        bf16* plane = reinterpret_cast<bf16*>(smem + p.off_plane);
        for (int i = threadIdx.x - 128; i < p.T * p.S; i += 256) {
            const int r = i / p.S;
            plane[r * p.wb + i - r * p.S] = src[i];
        }
        if (p.S & 1)  // the key past S completes the last pair
            for (int r = threadIdx.x - 128; r < p.T; r += 256)
                plane[r * p.wb + p.S] = __float2bfloat16(0.f);
        sm90::named_sync(1, 256);
    }

    for (int b = blockIdx.x / p.H; b < p.B; b += p.nbh) {
        const bf16* bias_bh =
            p.bias ? p.bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;
        for (int g = 0; g < ng; ++g, ++qn) {
            const int qs = qn % NQ;
            sm90::mbar_wait(&bar.q_full[qs], (qn / NQ) & 1);
            const int row0 = g * GROUP + cw * CROWS;
            const int nvalid = min(CROWS, p.T - row0);  // may be <= 0
            const uint32_t q_base = smem_addr(smem + qs * G::Q_BYTES) + cw * CROWS * G::CB;

            float o[D / 2], m[2], l[2];  // set by the first tile
            for (int j = 0; j < nt; ++j, ++n) {
                const int s = n % p.nst;
                const uint32_t parity = (n / p.nst) & 1;
                if (nvalid > 0)
                    tile<D>(p, smem, bar, q_base, s, parity, j * BK, row0, bias_bh, j == 0, o,
                            m, l);
                else  // rows past T: the stage passes
                    sm90::mbar_wait(&bar.full[s], parity);
                sm90::mbar_arrive(&bar.empty[s]);
            }
            sm90::mbar_arrive(&bar.q_empty[qs]);

            // out = O / l (l >= 1: the row max contributes 1), rows < T
            if (nvalid > 0) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    float lt = l[hh];
                    lt += __shfl_xor_sync(FULL, lt, 1);
                    lt += __shfl_xor_sync(FULL, lt, 2);
                    const int r = 16 * w + r8 + 8 * hh;
                    if (r >= nvalid) continue;
                    const float inv = 1.f / lt;
                    bf16* dst = p.out + (((size_t)b * p.T + row0 + r) * p.H + h) * D + 2 * quad;
#pragma unroll
                    for (int nn = 0; nn < D / 8; ++nn)
                        *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                            pack(o[4 * nn + 2 * hh] * inv, o[4 * nn + 2 * hh + 1] * inv);
                }
            }
        }
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attn_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    if (threadIdx.x == 0) {
        const Bars bar(smem, p);
        for (int i = 0; i < NQ; ++i) {
            sm90::mbar_init(&bar.q_full[i], 1);     // q group loaded
            sm90::mbar_init(&bar.q_empty[i], 256);  // q group read by both consumers
        }
        for (int s = 0; s < p.nst; ++s) {
            sm90::mbar_init(&bar.full[s], 1);     // stage s loaded
            sm90::mbar_init(&bar.empty[s], 256);  // stage s read by both consumers
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp: only
    // then does it give the consumers the registers setmaxnreg asks for
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) producer<D>(&tq, &tk, &tv, p, smem);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        consumer<D>(p, smem, wg - 1);
    }
}

inline int sm_count() {
    static int n = 0;
    if (!n) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            n = 132;
    }
    return n;
}

// The shared-memory plan of a call, in p (nst, wb, offsets); returns the
// bytes it takes. A bias without a batch dim keeps its head's plane
// resident where it fits beside a K/V ring of 2 stages; the ring then
// takes as many stages as fit, up to 3.
template <int D> int smem_plan(Params& p) {
    using G = Geo<D>;
    auto bytes = [&](int nst, int wb) {
        return G::OFF_K + nst * 2 * G::KV_BYTES + ((p.T * wb * 2 + 15) & ~15) + NBARS * 8 +
               1024;
    };
    // the plane's row stride: the keys rounded up to a pair, 4 (mod 32)
    // words long so that the 8 rows of a fragment read fall in distinct banks
    const int wb = (p.S + 1 + 55) / 64 * 64 + 8;
    p.wb = p.bias && !p.bias_sb && bytes(2, wb) <= SMEM_MAX ? wb : 0;
    p.nst = NST_MAX;
    while (p.nst > 1 && bytes(p.nst, p.wb) > SMEM_MAX) --p.nst;
    p.off_plane = G::OFF_K + p.nst * 2 * G::KV_BYTES;
    p.off_bar = p.off_plane + ((p.T * p.wb * 2 + 15) & ~15);
    return bytes(p.nst, p.wb);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, Params p, cudaStream_t stream) {
    const int smem = smem_plan<D>(p);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    if (!sm90::make_map<D>(enc, &tq, q, p.B, p.T, p.H, GROUP) ||
        !sm90::make_map<D>(enc, &tk, k, p.B, p.S, p.H, BK) ||
        !sm90::make_map<D>(enc, &tv, v, p.B, p.S, p.H, BK))
        return cudaErrorInvalidValue;
    auto kern = encoder_attn_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // blocks per head: about one block per SM over the card, each on one head
    p.nbh = max(1, min(p.B, sm_count() / p.H));
    kern<<<p.H * p.nbh, THREADS, smem, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace hop

cudaError_t launch_fp32(int D, const enc_fwd::Params& p, int B, cudaStream_t stream) {
    switch (D) {
        case 64: return enc_fwd::launch<float, 64>(p, B, stream);
        case 96: return enc_fwd::launch<float, 96>(p, B, stream);
        case 128: return enc_fwd::launch<float, 128>(p, B, stream);
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t launch_bf16(int D, const void* q, const void* k, const void* v,
                        const hop::Params& p, cudaStream_t stream) {
    switch (D) {
        case 64: return hop::launch<64>(q, k, v, p, stream);
        case 96: return hop::launch<96>(q, k, v, p, stream);
        case 128: return hop::launch<128>(q, k, v, p, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `scale` multiplies q k^T. Returns
// cudaGetLastError() after the launch.
int encoder_attn_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                     int B, int T_, int S, int H, int D, int bias_sb, int bias_sh, float scale,
                     int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    if (S <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0) {
        const enc_fwd::Params p{q, k, v, bias, nullptr, out, T_, S, H, bias_sb, bias_sh,
                                scale * enc_fwd::LOG2E};
        err = launch_fp32(D, p, B, st);
    } else if (dtype == 1) {
        const hop::Params p{static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, T_, S,
                            H, bias_sb, bias_sh, scale * hop::LOG2E, 1.f / scale};
        err = launch_bf16(D, q, k, v, p, st);
    } else {
        err = cudaErrorInvalidValue;
    }
    return (int)err;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
