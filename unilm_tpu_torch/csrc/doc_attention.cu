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
//  - bf16 (namespace tc): every product on the tensor cores (mma.sync
//    m16n8k16, fp32 accumulators). One block per (64-row q tile, head,
//    batch), 4 warps of 16 rows; K and V tiles of 64 keys double-buffered by
//    cp.async. Two sweeps over the keys instead of whole score rows in
//    shared memory: sweep 0 takes the row max of q k^T + bias, sweep 1
//    recomputes the scores, rounds p = exp2(s - max) to bf16 in the
//    accumulator layout and feeds it straight to the p v product as the A
//    operand. The bias is read once per sweep, twice in all; the q k^T
//    product is paid twice, which the tensor cores can afford here. A
//    tile's bias and mask are read into registers before its products, both
//    unconditionally, and then selected: the first version read them after
//    the products with the bias read behind a branch on the mask, so every
//    bias read waited on a mask read, and took 3.2163 ms at the FUNSD shape
//    against 0.9355 ms now (chip_smoke.py's doc_attn phase, H100 80GB HBM3
//    at 700 W), the same bits. (The fp32 path keeps its reads behind
//    the mask: read unconditionally they made the eval CLI's batch slower,
//    its padded keys' bias being read for nothing.)
//  - fp32: the CUDA-core body of #3 itself (encoder_attention.cuh, shared
//    with csrc/encoder_attention.cu), whole score rows in shared memory,
//    given the mask; exact fp32 products for the parity runs (the FUNSD
//    eval CLI's fp32 configuration).

#include <cmath>

#include "encoder_attention.cuh"
#include "mma_common.cuh"

namespace {

using enc_fwd::LOG2E;
using enc_fwd::Params;

// ---------------------------------------------------------------------------
// bf16 inputs: two sweeps on the tensor cores (see the top of the file).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NW = 4;        // warps per block
constexpr int NT = NW * 32;
constexpr int BQ = NW * 16;  // query rows per block: a warp owns 16
constexpr int BK = 64;       // keys per tile
constexpr int PAD = 8;       // bf16 elements of padding per tile row

// log2(e) * bias[row][col], 0 without a bias
__device__ __forceinline__ float bias_log2(const bf16* bias_bh, int S, int row, int col) {
    return bias_bh ? LOG2E * __bfloat162float(bias_bh[(size_t)row * S + col]) : 0.f;
}

template <int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 3 : 2) doc_fwd_tc_kernel(const Params p) {
    constexpr int LD = D + PAD;
    constexpr int NJ = BK / 8, ND = D / 8, KD = D / 16;
    extern __shared__ float4 smem4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BQ][LD], q * qscale
    bf16* KV = Qs + BQ * LD;                    // 2 x {K [BK][LD], V [BK][LD]}

    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* k = static_cast<const bf16*>(p.k);
    const bf16* v = static_cast<const bf16*>(p.v);
    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int row0 = blockIdx.x * BQ;
    const int T_ = p.T, S = p.S;
    const size_t HD = (size_t)p.H * D;
    const int nk = (S + BK - 1) / BK;
    const size_t kbase = (size_t)b * S * HD + (size_t)h * D;
    const int wr = warp * 16;  // this warp's first local row
    // the thread's two rows, clamped for the bias reads of rows past T
    const int tl[2] = {row0 + wr + g, row0 + wr + g + 8};
    const int tr[2] = {min(tl[0], T_ - 1), min(tl[1], T_ - 1)};
    const bf16* bias_bh =
        p.bias ? static_cast<const bf16*>(p.bias) + (size_t)b * p.bias_sb + (size_t)h * p.bias_sh
               : nullptr;
    const int* mask_b = p.mask ? p.mask + (size_t)b * S : nullptr;

    stage_async<D, NT>(Qs, LD, q + ((size_t)b * T_ + row0) * HD + (size_t)h * D, HD, BQ,
                       T_ - row0, tid);
    stage_async<D, NT>(KV, LD, k + kbase, HD, BK, S, tid);  // sweep 0 reads K only
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // q * scale * log2(e), rounded to bf16, in place
    for (int i = tid; i < BQ * D / 2; i += NT) {
        uint32_t* x = reinterpret_cast<uint32_t*>(Qs + (i / (D / 2)) * LD + (i % (D / 2)) * 2);
        *x = scale2(*x, p.qscale);
    }

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    // tiles 0..nk-1: sweep 0, the row max; tiles nk..2nk-1: sweep 1, p and
    // p v
    for (int i = 0; i < 2 * nk; ++i) {
        const int c0 = (i % nk) * BK;
        const bool sweep1 = i >= nk;
        if (i + 1 < 2 * nk) {  // prefetch the next tile into the other buffer
            const int cn = ((i + 1) % nk) * BK;
            bf16* nb = KV + ((i + 1) & 1) * 2 * BK * LD;
            stage_async<D, NT>(nb, LD, k + kbase + (size_t)cn * HD, HD, BK, S - cn, tid);
            if (i + 1 >= nk)
                stage_async<D, NT>(nb + BK * LD, LD, v + kbase + (size_t)cn * HD, HD, BK, S - cn,
                                   tid);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();  // the tile (and, at i = 0, the scaled q) is visible
        const bf16* Ks = KV + (i & 1) * 2 * BK * LD;
        const bf16* Vs = Ks + BK * LD;

        // what the tile adds to the exp2-domain scores: log2(e) * bias, a
        // masked key -1e30 (s + -1e30 rounds to -1e30 for any score), past
        // S -inf. Read from global memory before the products, so their
        // latency hides behind the mma work; the bias and the mask are both
        // read (a clamped column past S) and then selected, so that neither
        // read waits on the other.
        float add[NJ][4];
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = c0 + n * 8 + 2 * tq + (e & 1);
                const int cc = min(col, S - 1);
                const float bv = bias_log2(bias_bh, S, tr[e >> 1], cc);
                const bool keep = !mask_b || mask_b[cc];
                add[n][e] = col >= S ? -INFINITY : keep ? bv : NEG_INF;
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
#pragma unroll
        for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += add[n][e];

        if (!sweep1) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int n = 0; n < NJ; ++n)
                    m[r] = fmaxf(m[r], fmaxf(s[n][2 * r], s[n][2 * r + 1]));
            if (i == nk - 1) {  // the quad's maxima: each row's max
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    m[r] = fmaxf(m[r], __shfl_xor_sync(FULL, m[r], 1));
                    m[r] = fmaxf(m[r], __shfl_xor_sync(FULL, m[r], 2));
                }
            }
        } else {
            // p = exp2(s - m) rounded to bf16; l adds the rounded values
#pragma unroll
            for (int n = 0; n < NJ; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float pr = round_to<bf16>(exp2f(s[n][e] - m[e >> 1]));
                    s[n][e] = pr;
                    l[e >> 1] += pr;
                }
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
        }
        __syncthreads();  // this buffer is free for tile i + 2
    }

    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        if (tl[r] >= T_) continue;
        const float inv = 1.f / l[r];  // >= 1: the row max contributes exp2(0)
        bf16* dst = out + ((size_t)b * T_ + tl[r]) * HD + (size_t)h * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    const size_t smem = (size_t)(BQ + 4 * BK) * (D + PAD) * sizeof(bf16);
    auto kern = doc_fwd_tc_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((p.T + BQ - 1) / BQ, p.H, B);
    kern<<<grid, NT, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch(int dtype, const Params& p, int B, cudaStream_t stream) {
    return dtype == 0 ? enc_fwd::launch<float, D>(p, B, stream) : tc::launch<D>(p, B, stream);
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
