// Fused encoder attention for Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_vit_kernel` (:580), reached
// through `_vit_forward` (:632) from `fused_encoder_attention` (:701), the
// JAX dispatcher's encoder hot path (BEiT / DiT / ViT shapes: non-causal,
// full kv, no key-padding mask, S <= 2048). Same function:
//   out = softmax(scale * q k^T + bias) v      per (batch, head)
// with an EXACT softmax, not an online one: a block keeps its query rows'
// whole score rows in shared memory, takes the row max, then exp2, then the
// sum, in the exp2 domain (scale * log2(e) folded into q as it is staged,
// the bias multiplied by log2(e) as it is added). The probabilities are
// rounded to the storage type of V before the PV product, and the row sum
// adds the rounded values, as the TPU kernel's exact (fp32) path does
// (`p = exp2(s - m).astype(v.dtype)`, :622-623). No lse is written.
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D] (row
// stride H*D, the natural projection layout, so no transposes), bias
// [Bb, Hb, T, S] with element strides `bias_sb`, `bias_sh` (0 = broadcast).
// The TPU wrapper pads T and S to multiples of 8 with a NEG_INF bias; here
// the kernel masks the ragged edge itself and nothing is padded.
//
// What bounds it on the H100: this first version computes both products
// on the fp32 CUDA cores (at most ~67 TFLOP/s fp32), not the tensor cores
// (989 TFLOP/s bf16), so it is bound by the issue of fp32 FMAs and
// shared-memory loads. The work itself is memory-bound on the card: at
// BEiT-B (B=128, T=S=197, H=12, D=64, bf16) q, k, v and out are 155 MB
// against 1.5e10 FLOP, ~46 us at 3.35 TB/s against ~15 us of bf16 tensor
// time. Tensor-core tiles (mma.sync / wgmma) and TMA-fed K/V are later
// work.
// What the design does about it: each warp owns RPW query rows and each
// lane two keys of a 64-key tile, so one K value loaded from shared memory
// feeds RPW FMAs and q is read as float4 broadcasts; K rows are padded by
// 4 floats so the per-lane float4 reads are bank-conflict free; the PV
// product reads the probabilities as float4 broadcasts from the score rows
// and skips the columns past S. RPW = 4 rows per warp (16 per block): at
// S = 2048 and D = 128 the block takes 170 KB of shared memory, and at
// BEiT's S = 197 small blocks keep more warps resident and pad T less.
// Against 16 rows per warp (64 per block) it took 1.07 instead of 1.61 ms
// at BEiT-B on an H100 80GB HBM3 at 700 W (chip_smoke.py, encoder_attn).
// Grid: one block per (q tile of 16 rows, head, batch), 4 warps.

#include "flash_common.cuh"

namespace {

constexpr int BK = 64;               // keys per K / V tile
constexpr int NWARPS = 4;            // warps per block
constexpr int RPW = 4;               // query rows per warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_MAX = 232448;  // bytes of shared memory a block may opt into

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
encoder_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ bias,
                    T* __restrict__ out, int T_, int S, int Sp, int H, int bias_sb,
                    int bias_sh, float qscale) {
    constexpr int BQ = NWARPS * RPW;  // query rows per block
    constexpr int DPL = D / 32;       // output dims per lane
    constexpr int KST = D + 4;        // padded K row stride (float4 aligned)
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D], scaled by qscale
    float* KV = Qs + BQ * D;                      // [BK][KST] K tile, then [BK][D] V tile
    float* Ss = KV + BK * KST;                    // [BQ][Sp] scores, then probabilities

    const int b = blockIdx.z, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row0 = blockIdx.x * BQ;
    const size_t HD = (size_t)H * D;
    const int ntiles = Sp / BK;

    const T* qb = q + ((size_t)b * T_ + row0) * HD + (size_t)h * D;
    stage_rows<T, D>(Qs, D, qb, HD, BQ, T_ - row0, tid, NWARPS * 32);
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NWARPS * 32) Qs[i] *= qscale;

    const float* qw = Qs + warp * RPW * D;
    float* sw = Ss + (size_t)warp * RPW * Sp;
    const T* bias_bh =
        bias ? bias + (size_t)b * bias_sb + (size_t)h * bias_sh : nullptr;
    const T* kb = k + (size_t)b * S * HD + (size_t)h * D;
    const T* vb = v + (size_t)b * S * HD + (size_t)h * D;

    // ---- phase 1: the score rows s = q k^T (+ bias), log2 domain -------
    for (int j = 0; j < ntiles; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // Q scaled / previous K tile consumed
        stage_rows<T, D>(KV, KST, kb + (size_t)c0 * HD, HD, BK, S - c0, tid, NWARPS * 32);
        __syncthreads();

        float s0[RPW], s1[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) s0[r] = s1[r] = 0.f;
        const float* k0 = KV + lane * KST;
        const float* k1 = KV + (lane + 32) * KST;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(k0 + d);
            const float4 c = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 x = *reinterpret_cast<const float4*>(qw + r * D + d);
                s0[r] += dot4(x, a);
                s1[r] += dot4(x, c);
            }
        }
        const int col0 = c0 + lane, col1 = c0 + lane + 32;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
            const int tl = row0 + warp * RPW + r;
            float a = s0[r], c = s1[r];
            if (bias_bh && tl < T_) {
                const T* br = bias_bh + (size_t)tl * S;
                if (col0 < S) a += LOG2E * to_f(br[col0]);
                if (col1 < S) c += LOG2E * to_f(br[col1]);
            }
            sw[(size_t)r * Sp + col0] = col0 < S ? a : NEG_INF;
            sw[(size_t)r * Sp + col1] = col1 < S ? c : NEG_INF;
        }
    }
    __syncwarp();

    // ---- phase 2: exact softmax of each whole row (this warp's rows) ---
    float inv_l[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        float* row = sw + (size_t)r * Sp;
        float m = NEG_INF;
        for (int c = lane; c < S; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        float l = 0.f;
        for (int c = lane; c < Sp; c += 32) {
            const float p = c < S ? round_to<T>(exp2f(row[c] - m)) : 0.f;
            row[c] = p;
            l += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(FULL, l, o);
        inv_l[r] = 1.f / l;  // the row max contributes exp2(0) = 1, so l >= 1
    }
    __syncwarp();

    // ---- phase 3: out = P V / l -----------------------------------------
    float acc[RPW][DPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) acc[r][cc] = 0.f;
    for (int j = 0; j < ntiles; ++j) {
        const int c0 = j * BK;
        __syncthreads();  // every warp is done with the previous tile
        stage_rows<T, D>(KV, D, vb + (size_t)c0 * HD, HD, BK, S - c0, tid, NWARPS * 32);
        __syncthreads();
        const int cend = min(BK, (S - c0 + 3) & ~3);  // columns past S have p = 0
#pragma unroll 1
        for (int c = 0; c < cend; c += 4) {
            float vv[4][DPL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc) vv[u][cc] = KV[(c + u) * D + lane + 32 * cc];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float4 p = *reinterpret_cast<const float4*>(sw + (size_t)r * Sp + c0 + c);
#pragma unroll
                for (int cc = 0; cc < DPL; ++cc)
                    acc[r][cc] += p.x * vv[0][cc] + p.y * vv[1][cc] + p.z * vv[2][cc] +
                                  p.w * vv[3][cc];
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        const int tl = row0 + warp * RPW + r;
        if (tl >= T_) continue;
        T* orow = out + ((size_t)b * T_ + tl) * HD + (size_t)h * D;
#pragma unroll
        for (int cc = 0; cc < DPL; ++cc) orow[lane + 32 * cc] = from_f<T>(acc[r][cc] * inv_l[r]);
    }
}

constexpr size_t smem_bytes(int D, int Sp) {
    return (size_t)(NWARPS * RPW * D + BK * (D + 4) + NWARPS * RPW * Sp) * sizeof(float);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                   int B, int T_, int S, int H, int bias_sb, int bias_sh, float qscale,
                   cudaStream_t stream) {
    const int Sp = (S + BK - 1) / BK * BK;
    const size_t smem = smem_bytes(D, Sp);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;  // S too long for whole rows
    auto kern = encoder_attn_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + NWARPS * RPW - 1) / (NWARPS * RPW), H, B);
    kern<<<grid, NWARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(bias), static_cast<T*>(out), T_, S, Sp, H, bias_sb, bias_sh,
        qscale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* bias,
                       void* out, int B, int T_, int S, int H, int bias_sb, int bias_sh,
                       float qscale, cudaStream_t stream) {
    switch (D) {
        case 64:
            return launch<T, 64>(q, k, v, bias, out, B, T_, S, H, bias_sb, bias_sh,
                                       qscale, stream);
        case 96:
            return launch<T, 96>(q, k, v, bias, out, B, T_, S, H, bias_sb, bias_sh,
                                       qscale, stream);
        case 128:
            return launch<T, 128>(q, k, v, bias, out, B, T_, S, H, bias_sb, bias_sh,
                                        qscale, stream);
        default:
            return cudaErrorInvalidValue;
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
    const float qscale = scale * LOG2E;
    cudaError_t err;
    if (dtype == 0)
        err = dispatch_d<float>(D, q, k, v, bias, out, B, T_, S, H, bias_sb, bias_sh, qscale,
                                st);
    else if (dtype == 1)
        err = dispatch_d<__nv_bfloat16>(D, q, k, v, bias, out, B, T_, S, H, bias_sb, bias_sh,
                                        qscale, st);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
