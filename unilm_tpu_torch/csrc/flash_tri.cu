// Causal flash attention forward over the lower triangle of tiles, for
// Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_flash_tri_kernel` (:404),
// launched by `_flash_forward_tri` (:479) from `flash_attention` (:1979)
// when UNILM_TPU_TRI_FLASH is set and the call is causal with window 0, no
// query offset, no kv_len and T == S (:2030). Same function as #1
// (csrc/flash_fwd.cu) with causal fixed: q pre-scaled, fp32 scores and an
// online softmax, an optional int32 key-padding mask [B, S] and an optional
// additive bias [Bb, Hb, T, S] (element strides `bias_sb`, `bias_sh`, 0 =
// broadcast); out [B, T, H, D] in the inputs' type and lse [B, H, T] fp32;
// a row with no visible key gives out = 0 and lse = 0 (the keep-guard); p
// is rounded to v's type before the p v product (:463-467), the row sum
// adds the unrounded p.
//
// The TPU kernel flattens the visible (q tile i, k tile j <= i) pairs into
// one linear grid, so no grid step is spent on a tile above the diagonal,
// and applies the causal mask only where j == i (:450-452). On the H100
// the point of the schedule is balance: #1's block of the last q tile does
// nq times the work of the first. Schedule taken here: folded pairs
// (ops/flash_attention.py `tri_fold_plan` mirrors it; tests/
// test_torch_hopper_plans.py holds it). Block c (of ceil(nq / 2) per
// (head, batch), nq = ceil(T / 128)) takes q tile nq-1-c, then q tile c,
// and walks the k tiles 0..i of each: nq + 1 tiles of work for every
// block but the middle one of an odd nq ((nq + 1) / 2), one launch, no
// partial-softmax scratch and no combine pass. Within a pair only the
// diagonal tile (j == i) reads the causal predicate. A plain grid, not a
// persistent one: every block does the same work, so the hardware's
// block scheduler already balances the card, and at the train shape the
// 512 blocks make 3.9 waves of 132.
//
// What bounds it on the H100: at the train shape (B=2, T=S=2048, H=32,
// D=64, bf16) the two products are 2 * B * H * T^2 * D = 3.4e10 operations
// over the lower triangle, 0.035 ms at 989 TFLOP/s, against 67 MB of q, k,
// v and out that must move once, 0.020 ms at 3.35 TB/s: bound by the
// tensor cores, so both products run on wgmma and the exponentials must
// overlap them. The design, #1's (csrc/flash_fwd.cu, PTX in hopper.cuh):
//  - bf16 (`flash_tri_sm90`): a block of 384 threads, one producer
//    warpgroup trimmed to 40 registers by setmaxnreg and two consumer
//    warpgroups of 64 q rows each raised to 232. The role comes from a
//    warp-uniform value (__shfl_sync): from `threadIdx.x / 128` ptxas
//    ignores setmaxnreg (see csrc/flash_bwd.cu);
//  - one producer thread TMA-loads both q tiles of the pair at the start
//    (two buffers, 4-D maps over [B, T, H, D], rows past T read as zeros)
//    and streams the K/V tiles of 128 keys of both walks through one ring
//    of 3 stages (2 at D = 128) with full/empty mbarriers: the ring runs
//    on from the first tile's walk into the second's, so the second q
//    tile's first K/V tiles are in flight while the first q tile ends; the
//    producer warp packs each stage's key-padding mask into 128 bits;
//  - S = Q K^T is wgmma m64n128k16, both operands K-major in shared
//    memory; the online softmax runs on the accumulator fragments (ex2
//    with log2 e folded in); P goes to bf16 in registers as the A operand
//    of O += P V (RS wgmma, V through the transpose bit);
//  - out is written from the fragments as 4-byte pairs (the ring and two
//    q buffers leave no room to stage it at D = 128), lse by one lane of
//    each row quad. No atomics: two runs are bit-equal.
//  - fp32: #1's CUDA-core body (csrc/flash_fwd.cuh) run on the same folded
//    pairs of 64-row tiles, exact fp32 products.

#include <cmath>

#include "flash_fwd.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 inputs: wgmma fed by TMA, warp-specialised.
// ---------------------------------------------------------------------------
namespace hop {

constexpr int BQ = 128;          // query rows per q tile (two consumers)
constexpr int BK = 128;          // keys per K/V tile; BQ == BK puts the diagonal in one tile
constexpr int CROWS = 64;        // query rows per consumer warpgroup (wgmma M)
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Geo : sm90::Cols<D> {     // CW, CB, NC, SWZ: the TMA boxes
    static constexpr int NST = D == 128 ? 2 : 3;       // stages of the K/V ring
    static constexpr int Q_BYTES = BQ * D * 2;         // one q tile
    static constexpr int KV_BYTES = BK * D * 2;        // one K or one V tile
    static constexpr int OFF_K = 2 * Q_BYTES;          // stage s: K, then V
    static constexpr int OFF_BITS = OFF_K + NST * 2 * KV_BYTES;  // [NST][4] mask words
    static constexpr int OFF_BAR = OFF_BITS + NST * 16;  // q_full[2], full[NST], empty[NST]
    static constexpr int SMEM = OFF_BAR + (2 + 2 * NST) * 8 + 1024;  // + alignment slack
    static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms aligned");
    static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
    const bf16* bias;
    const int* mask;  // [B, T], nonzero = valid key; null = every key valid
    bf16* out;
    float* lse;
    int T, H, nq, bias_sb, bias_sh;
};

// the pair of block c: q tile nq-1-c first (the longer walk), then q tile
// c; one tile for the middle block of an odd nq
__device__ __forceinline__ int pair_tiles(int nq, int c, int* tiles) {
    tiles[0] = nq - 1 - c;
    tiles[1] = c;
    return c == nq - 1 - c ? 1 : 2;
}

template <int D>
__device__ __forceinline__ void producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const Params& p, uint8_t* smem,
                                         int b, int h, int c) {
    using G = Geo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + G::NST;
    uint32_t* bits = reinterpret_cast<uint32_t*>(smem + G::OFF_BITS);
    const int lane = threadIdx.x & 31;
    int tiles[2];
    const int np = pair_tiles(p.nq, c, tiles);
    if (lane == 0) {
        sm90::prefetch_tensormap(tq);
        sm90::prefetch_tensormap(tk);
        sm90::prefetch_tensormap(tv);
        for (int u = 0; u < np; ++u) {
            sm90::mbar_arrive_expect_tx(&bars[u], G::Q_BYTES);
#pragma unroll
            for (int cc = 0; cc < G::NC; ++cc)
                sm90::tma_load_4d(smem + u * G::Q_BYTES + cc * BQ * G::CB, tq, &bars[u],
                                  cc * G::CW, h, tiles[u] * BQ, b);
        }
    }
    int n = 0;  // K/V tiles loaded so far, across both walks
    for (int u = 0; u < np; ++u) {
        for (int j = 0; j <= tiles[u]; ++j, ++n) {
            const int s = n % G::NST;
            if (n >= G::NST) sm90::mbar_wait(&empty[s], (n / G::NST - 1) & 1);
            if (p.mask) {
                // key j BK + 32 i + bit is kept iff bit `bit` of word i is set
                const int* mrow = p.mask + (size_t)b * p.T;
                uint32_t w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int col = j * BK + 32 * i + lane;
                    w[i] = __ballot_sync(FULL, col < p.T && __ldg(mrow + col) != 0);
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
                for (int cc = 0; cc < G::NC; ++cc) {
                    sm90::tma_load_4d(kst + cc * BK * G::CB, tk, &full[s], cc * G::CW, h,
                                      j * BK, b);
                    sm90::tma_load_4d(kst + G::KV_BYTES + cc * BK * G::CB, tv, &full[s],
                                      cc * G::CW, h, j * BK, b);
                }
            }
        }
    }
}

// One consumer's 64 rows of q tile i: k tiles 0..i from the ring (stage
// counter n, carried over from the pair's first tile), out and lse written.
template <int D>
__device__ __forceinline__ void consumer_tile(const Params& p, uint8_t* smem, int cw, int b,
                                              int h, int i, int u, int& n) {
    using G = Geo<D>;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    uint64_t* full = bars + 2;
    uint64_t* empty = bars + 2 + G::NST;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(smem + G::OFF_BITS);

    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
    const int quad = lane & 3, r8 = lane >> 2;
    const int row0 = i * BQ + cw * CROWS;       // this consumer's first query row
    const int nvalid = min(CROWS, p.T - row0);  // its rows < T (may be <= 0)

    const uint32_t q_base = smem_addr(smem + u * G::Q_BYTES) + cw * CROWS * G::CB;
    const bf16* bias_bh =
        p.bias ? p.bias + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh : nullptr;

    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(&bars[u], 0);
    for (int j = 0; j <= i; ++j, ++n) {
        const int s = n % G::NST;
        sm90::mbar_wait(&full[s], (n / G::NST) & 1);
        if (nvalid > 0) {
            const int c0 = j * BK;
            const uint32_t k_base = smem_addr(smem + G::OFF_K + 2 * s * G::KV_BYTES);
            const uint32_t v_base = k_base + G::KV_BYTES;

            // S = Q K^T: D / 16 k-steps, both operands K-major
            float sc[64];
            sm90::wgmma_fence();
#pragma unroll
            for (int cc = 0; cc < G::NC; ++cc)
#pragma unroll
                for (int kk = 0; kk < G::CW / 16; ++kk)
                    sm90::wgmma_ss_n128(sc, sm90::kmajor_desc<D, BQ>(q_base, cc, kk),
                                        sm90::kmajor_desc<D, BK>(k_base, cc, kk), cc | kk);
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();

            // this thread's 32 keys of the tile: bit 2 nn + e = key c0 + 8 nn + 2 quad + e
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
                    const bf16* br = bias_bh + (size_t)tl * p.T;
#pragma unroll
                    for (int nn = 0; nn < 16; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int col = c0 + 8 * nn + 2 * quad + e;
                            if (col <= tl) sc[4 * nn + 2 * hh + e] += __bfloat162float(br[col]);
                        }
                }
            }
            if (j == i) {  // the diagonal tile: the causal predicate (col <= row < T)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int row = row0 + 16 * w + r8 + 8 * hh;
#pragma unroll
                    for (int nn = 0; nn < 16; ++nn)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int col = c0 + 8 * nn + 2 * quad + e;
                            if (col > row || !((keep_bits >> (2 * nn + e)) & 1u))
                                sc[4 * nn + 2 * hh + e] = -INFINITY;
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
            // pair of probabilities goes to bf16 as soon as it is taken:
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
    if (nvalid <= 0) return;

    // out = O / l (0 for a row with no kept key), 4-byte pairs straight
    // from the fragments; lse = m + log l (0 for such a row)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float lt = l[hh];
        lt += __shfl_xor_sync(FULL, lt, 1);
        lt += __shfl_xor_sync(FULL, lt, 2);
        const int r = 16 * w + r8 + 8 * hh;
        if (r >= nvalid) continue;
        const float inv = lt > 0.f ? 1.f / lt : 0.f;
        bf16* dst = p.out + (((size_t)b * p.T + row0 + r) * p.H + h) * D + 2 * quad;
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
            *reinterpret_cast<uint32_t*>(dst + 8 * nn) =
                pack(o[4 * nn + 2 * hh] * inv, o[4 * nn + 2 * hh + 1] * inv);
        if (quad == 0)
            p.lse[((size_t)b * p.H + h) * p.T + row0 + r] =
                lt > 0.f ? m[hh] + logf(fmaxf(lt, 1e-37f)) : 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tri_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
    using G = Geo<D>;
    extern __shared__ uint8_t smem_raw[];
    // swizzle atoms start on 1024-byte boundaries of the shared window
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

    // block -> (pair c, batch, head)
    const int BH = gridDim.x / ((p.nq + 1) / 2);
    const int bh = blockIdx.x % BH, c = blockIdx.x / BH;
    const int b = bh / p.H, h = bh % p.H;

    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
    if (threadIdx.x == 0) {
        sm90::mbar_init(&bars[0], 1);  // q tile of the pair's first walk loaded
        sm90::mbar_init(&bars[1], 1);  // ... of its second
        for (int s = 0; s < G::NST; ++s) {
            sm90::mbar_init(&bars[2 + s], 1);             // stage s loaded
            sm90::mbar_init(&bars[2 + G::NST + s], 256);  // stage s read by both consumers
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, as a value ptxas can see is uniform over each warp: only
    // then does it give the consumers the registers setmaxnreg asks for
    const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        sm90::setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x < 32) producer<D>(&tq, &tk, &tv, p, smem, b, h, c);
    } else {
        sm90::setmaxnreg_inc<CONSUMER_REGS>();
        int tiles[2];
        const int np = pair_tiles(p.nq, c, tiles);
        int n = 0;
        for (int u = 0; u < np; ++u) consumer_tile<D>(p, smem, wg - 1, b, h, tiles[u], u, n);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const int* mask, void* out, float* lse, int B, int T_, int H, int bias_sb,
                   int bias_sh, cudaStream_t stream) {
    using G = Geo<D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tq, tk, tv;
    if (!sm90::make_map<D>(enc, &tq, q, B, T_, H, BQ) ||
        !sm90::make_map<D>(enc, &tk, k, B, T_, H, BK) ||
        !sm90::make_map<D>(enc, &tv, v, B, T_, H, BK))
        return cudaErrorInvalidValue;
    const int nq = (T_ + BQ - 1) / BQ;
    Params p{static_cast<const bf16*>(bias), mask, static_cast<bf16*>(out), lse, T_, H, nq,
             bias_sb, bias_sh};
    auto kern = flash_tri_sm90<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    kern<<<(nq + 1) / 2 * B * H, THREADS, G::SMEM, stream>>>(tq, tk, tv, p);
    return cudaGetLastError();
}

}  // namespace hop

// ---------------------------------------------------------------------------
// fp32 inputs: #1's CUDA-core body on the same folded pairs of 64-row tiles.
// ---------------------------------------------------------------------------
struct Fp32Params {
    const float *q, *k, *v, *bias;
    const int* mask;
    float* out;
    float* lse;
    int T, H, bias_sb, bias_sh, nq;
};

template <int D>
__global__ void __launch_bounds__(fwd::NWARPS * 32) flash_tri_fp32_kernel(const Fp32Params p) {
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int far = p.nq - 1 - c;
    // one inlined body for both tiles (two spilled at D = 96 and 128)
#pragma unroll 1
    for (int u = 0; u < (c == far ? 1 : 2); ++u) {
        if (u) __syncthreads();  // the first tile's shared memory is free
        fwd::tile<float, D>(p.q, p.k, p.v, p.bias, p.mask, p.out, p.lse, b, h,
                            (u ? c : far) * fwd::BQ, p.T, p.T, p.H, p.bias_sb, p.bias_sh, 0,
                            p.T, 1, 0);
    }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* bias,
                        const int* mask, void* out, float* lse, int B, int T_, int H,
                        int bias_sb, int bias_sh, cudaStream_t stream) {
    const Fp32Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(bias), mask,
                       static_cast<float*>(out), lse, T_, H, bias_sb, bias_sh,
                       (T_ + fwd::BQ - 1) / fwd::BQ};
    const size_t smem = fwd::smem_bytes<D>();
    auto kern = flash_tri_fp32_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((p.nq + 1) / 2, H, B), fwd::NWARPS * 32, smem, stream>>>(p);
    return cudaGetLastError();
}

typedef cudaError_t (*Launcher)(const void*, const void*, const void*, const void*, const int*,
                                void*, float*, int, int, int, int, int, cudaStream_t);

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. T = S. `mask` is int32 [B, T] or
// null; `bias` is null or addressed as bias + b * bias_sb + h * bias_sh +
// t * T + s. Returns cudaGetLastError() after the launch.
int flash_tri_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, void* out, void* lse, int B, int T_, int H, int D,
                  int bias_sb, int bias_sh, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    Launcher fn = nullptr;
    if (dtype == 0)
        fn = D == 64 ? &launch_fp32<64> : D == 96 ? &launch_fp32<96> : &launch_fp32<128>;
    else if (dtype == 1)
        fn = D == 64 ? &hop::launch<64> : D == 96 ? &hop::launch<96> : &hop::launch<128>;
    if (D != 64 && D != 96 && D != 128) fn = nullptr;
    if (!fn) return (int)cudaErrorInvalidValue;
    return (int)fn(q, k, v, bias, static_cast<const int*>(mask), out, static_cast<float*>(lse),
                   B, T_, H, bias_sb, bias_sh, static_cast<cudaStream_t>(stream));
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
