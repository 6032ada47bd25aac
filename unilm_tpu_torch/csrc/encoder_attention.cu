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
// The body is encoder_attention.cuh's, which the fp32 path of
// csrc/doc_attention.cu (#9) shares with a key-padding mask; here the mask
// is null.

#include "encoder_attention.cuh"

namespace {

template <typename T>
cudaError_t dispatch_d(int D, const enc_fwd::Params& p, int B, cudaStream_t stream) {
    switch (D) {
        case 64: return enc_fwd::launch<T, 64>(p, B, stream);
        case 96: return enc_fwd::launch<T, 96>(p, B, stream);
        case 128: return enc_fwd::launch<T, 128>(p, B, stream);
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
    const enc_fwd::Params p{q, k, v, bias, nullptr, out, T_, S, H, bias_sb, bias_sh,
                            scale * enc_fwd::LOG2E};
    cudaError_t err;
    if (dtype == 0)
        err = dispatch_d<float>(D, p, B, st);
    else if (dtype == 1)
        err = dispatch_d<__nv_bfloat16>(D, p, B, st);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
