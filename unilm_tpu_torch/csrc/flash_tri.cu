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
// a fully masked row gives out = 0 and lse = 0 (NEG_INF = -1e30 and the
// keep-guard); p is rounded to v's type before the p v product (:463-467),
// the row sum adds the unrounded p.
//
// The TPU kernel flattens the visible (q tile i, k tile j <= i) pairs into
// one linear grid, so no grid step is spent on a tile above the diagonal,
// and applies the causal mask only where j == i (:450-452). #1 already
// skips the dead tiles inside its loop on the H100; what it lacks is
// balance: the block of the last q tile does nq times the work of the
// first. Schedule taken here: folded pairs. Block c (of ceil(nq / 2) per
// (head, batch)) takes q tile nq-1-c, then q tile c, and walks the visible
// k tiles of each: nq + 1 tiles of work for every block (one tile less for
// the middle block of an odd nq), one launch, no partial-softmax scratch
// and no combine pass. Within a tile pair only j == i reads the causal
// predicate.
//
// What bounds it on the H100: at the train shape (B=2, T=S=2048, H=32,
// D=64, bf16) the two products are 2 * B * H * T^2 * D = 3.4e10 operations
// over the lower triangle, 0.035 ms at 989 TFLOP/s, against 67 MB of q, k,
// v and out that must move once, 0.020 ms at 3.35 TB/s: bound by the
// tensor cores. Measured there (H100 80GB HBM3, 700 W, chip_smoke.py's
// flash_tri phase): 0.53 ms, against 1.64 ms for #1 on the same inputs.
//  - bf16 (namespace tc): both products on the tensor cores (mma.sync
//    m16n8k16, fp32 accumulators, mma_common.cuh's fragments), 4 warps of
//    16 query rows, K and V tiles of 64 keys double-buffered by cp.async;
//    p leaves the accumulators as the bf16 A operand of p v without going
//    through shared memory. The tile's mask and bias are read before its
//    products so their latency hides behind the mma work.
//  - fp32: #1's CUDA-core body (csrc/flash_fwd.cuh) run on the same folded
//    pairs, exact fp32 products.

#include <cmath>

#include "flash_fwd.cuh"
#include "mma_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;  // query rows per tile (4 warps x 16)
constexpr int BK = 64;  // keys per tile; BQ == BK puts the diagonal in one tile
static_assert(BQ == fwd::BQ && BK == fwd::BK, "the fp32 body's tiles");

struct Params {
    const void *q, *k, *v, *bias;
    const int* mask;  // [B, S], nonzero = valid key; null = every key valid
    void* out;
    float* lse;
    int T, H, bias_sb, bias_sh, nq;
};

// ---------------------------------------------------------------------------
// bf16 inputs: the tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NW = 4;        // warps per block
constexpr int NT = NW * 32;
constexpr int PAD = 8;       // bf16 elements of padding per tile row
static_assert(BQ == NW * 16, "a warp owns 16 query rows");

template <int D> constexpr size_t smem_bytes() {
    return (size_t)(BQ + 4 * BK) * (D + PAD) * sizeof(bf16);
}

// out and lse of q tile i of (batch b, head h): k tiles 0..i, online
// softmax in the exp2 domain (scores times log2(e) in fp32, after the
// product, so the scores are #1's)
template <int D>
__device__ __forceinline__ void tile(const Params& p, int b, int h, int i) {
    constexpr int LD = D + PAD;
    constexpr int NJ = BK / 8, ND = D / 8, KD = D / 16;
    extern __shared__ float4 smem4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BQ][LD]
    bf16* KV = Qs + BQ * LD;                    // 2 x {K [BK][LD], V [BK][LD]}

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* v = static_cast<const bf16*>(p.v);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int T_ = p.T, S = p.T;
    const size_t HD = (size_t)p.H * D;
    const int row0 = i * BQ;
    const int wr = warp * 16;
    // the thread's two rows; clamped for the bias reads of rows past T
    const int tl[2] = {row0 + wr + g, row0 + wr + g + 8};
    const int tr[2] = {min(tl[0], T_ - 1), min(tl[1], T_ - 1)};
    const size_t kbase = (size_t)b * S * HD + (size_t)h * D;
    const bf16* bias_bh =
        p.bias ? static_cast<const bf16*>(p.bias) + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh
               : nullptr;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;

    stage_async<D, NT>(Qs, LD, q + ((size_t)b * T_ + row0) * HD + (size_t)h * D, HD, BQ,
                       T_ - row0, tid);
    stage_async<D, NT>(KV, LD, k + kbase, HD, BK, S, tid);
    stage_async<D, NT>(KV + BK * LD, LD, v + kbase, HD, BK, S, tid);
    cp_commit();

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int j = 0; j <= i; ++j) {
        const int c0 = j * BK;
        if (j < i) {  // prefetch tile j + 1 into the other buffer
            const int cn = c0 + BK;
            bf16* nb = KV + ((j + 1) & 1) * 2 * BK * LD;
            stage_async<D, NT>(nb, LD, k + kbase + (size_t)cn * HD, HD, BK, S - cn, tid);
            stage_async<D, NT>(nb + BK * LD, LD, v + kbase + (size_t)cn * HD, HD, BK, S - cn,
                               tid);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();  // tile j (and, at j = 0, q) is visible
        const bf16* Ks = KV + (j & 1) * 2 * BK * LD;
        const bf16* Vs = Ks + BK * LD;

        // the tile's keep bits and log2(e) * bias, read before the products
        // (a clamped column past S, then selected)
        unsigned keep = 0u;
        float add[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = c0 + n * 8 + 2 * tq + (e & 1);
                const int cc = min(col, S - 1);
                add[n][e] = bias_bh ? LOG2E * __bfloat162float(bias_bh[(size_t)tr[e >> 1] * S + cc])
                                    : 0.f;
                const bool ok = col < S && (!mask_b || mask_b[cc] != 0) &&
                                (j < i || col <= tl[e >> 1]);
                keep |= (unsigned)ok << (n * 4 + e);
            }

        float s[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t aq[4];
            load_a(aq, Qs, LD, wr, kk * 16, g, tq);
#pragma unroll
            for (int n = 0; n < NJ; ++n) {
                const bf16* kr = Ks + (n * 8 + g) * LD + kk * 16 + 2 * tq;
                mma(s[n], aq, ld32(kr), ld32(kr + 8));
            }
        }

        // exp2-domain scores, NEG_INF where masked; the tile's row maxima
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = (keep >> (n * 4 + e)) & 1u;
                s[n][e] = ok ? fmaf(s[n][e], LOG2E, add[n][e]) : NEG_INF;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            alpha[r] = exp2f(m[r] - m_new);  // 1 while the row is masked so far
            m[r] = m_new;
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }
        // keep-guard: a masked element is 0, not exp2(NEG_INF - NEG_INF)
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = (keep >> (n * 4 + e)) & 1u;
                const float pr = ok ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
                s[n][e] = pr;
                l[e >> 1] += pr;
            }
        // acc += p v, p rounded to bf16 as the A operand
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < ND; n += 2) {
                uint32_t bv[4];
                load_bt(bv, Vs, LD, kk * 16, n * 8, lane);
                mma(acc[n], a, bv[0], bv[1]);
                mma(acc[n + 1], a, bv[2], bv[3]);
            }
        }
        __syncthreads();  // this buffer is free for tile j + 2
    }

    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        if (tl[r] >= T_) continue;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 1.f;
        bf16* dst = out + ((size_t)b * T_ + tl[r]) * HD + (size_t)h * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        if (tq == 0)
            p.lse[((size_t)b * p.H + h) * T_ + tl[r]] =
                l[r] > 0.f ? (m[r] + log2f(fmaxf(l[r], 1e-37f))) / LOG2E : 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 3 : 2) flash_tri_tc_kernel(const Params p) {
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int far = p.nq - 1 - c;  // the longer tile of the pair first
    tile<D>(p, b, h, far);
    if (c != far) {
        __syncthreads();  // the first tile's q and k/v buffers are free
        tile<D>(p, b, h, c);
    }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    auto kern = flash_tri_tc_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((p.nq + 1) / 2, p.H, B), NT, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 inputs: #1's CUDA-core body on the same folded pairs.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(fwd::NWARPS * 32) flash_tri_fp32_kernel(const Params p) {
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int far = p.nq - 1 - c;
    const float* q = static_cast<const float*>(p.q);
    const float* k = static_cast<const float*>(p.k);
    const float* v = static_cast<const float*>(p.v);
    const float* bias = static_cast<const float*>(p.bias);
    float* out = static_cast<float*>(p.out);
    fwd::tile<float, D>(q, k, v, bias, p.mask, out, p.lse, b, h, far * BQ, p.T, p.T, p.H,
                        p.bias_sb, p.bias_sh, 0, p.T, 1, 0);
    if (c != far) {
        __syncthreads();  // the first tile's shared memory is free
        fwd::tile<float, D>(q, k, v, bias, p.mask, out, p.lse, b, h, c * BQ, p.T, p.T, p.H,
                            p.bias_sb, p.bias_sh, 0, p.T, 1, 0);
    }
}

template <int D>
cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
    const size_t smem = fwd::smem_bytes<D>();
    auto kern = flash_tri_fp32_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((p.nq + 1) / 2, p.H, B), fwd::NWARPS * 32, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Params& p, int B, cudaStream_t stream) {
    return dtype == 0 ? launch_fp32<D>(p, B, stream) : tc::launch<D>(p, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. T = S. `mask` is int32 [B, T] or
// null; `bias` is null or addressed as bias + b * bias_sb + h * bias_sh +
// t * T + s. Returns cudaGetLastError() after the launch.
int flash_tri_fwd(const void* q, const void* k, const void* v, const void* bias,
                  const void* mask, void* out, void* lse, int B, int T_, int H, int D,
                  int bias_sb, int bias_sh, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
    const Params p{q, k, v, bias, static_cast<const int*>(mask), out, static_cast<float*>(lse),
                   T_, H, bias_sb, bias_sh, (T_ + BQ - 1) / BQ};
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
