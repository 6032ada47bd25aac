// One-token decode attention over contiguous KV page runs, Hopper (sm_90a),
// plain C interface. The kernel itself is decode_kernel in decode_common.cuh.
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
// Both read only the rows that hold tokens, i.e. only the
// ceil(L / (chunk * page)) slabs of the TPU kernel, never the rest of the
// run's page budget.
//
// What bounds it on the H100: bytes. Each step reads 2 * L * D elements per
// (sequence, head) — 1 byte each for int8 plus 8 bytes of scales per token —
// and does ~4 flops per element, far below the ~295 flop/byte ridge, so HBM
// bandwidth (3.35 TB/s) is the limit if enough loads are in flight. One
// block per (sequence, head) gives B * H blocks: 128 at B = 8, H = 16, about
// one per SM; at B = 1 only 16, which cannot reach the bandwidth bound —
// splitting each sequence over several blocks (split-K with a merge pass)
// is a later PR's work.
// What the design does about it: see decode_common.cuh (32 warps walk
// 32-token tiles in parallel; K rows with vector loads, one token per lane;
// V rows lane-contiguous, 8 tokens in flight; one merge through shared
// memory). The int8 variant halves the pool bytes of the bf16 one.

#include "decode_common.cuh"

extern "C" {

// q [B, H, D] pre-scaled; pools [P, page, H*D] of q's type; bases/lengths
// [B] int32; out [B, H, D]. dtype: 0 = float32, 1 = bfloat16.
int decode_attention(const void* q, void* k_pool, void* v_pool, const void* bases,
                     const void* lengths, void* out, int B, int H, int D, int page,
                     int max_pages, int num_pages, int dtype, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    DecodeArgs a{q, k_pool, v_pool, static_cast<const int*>(bases),
                 static_cast<const int*>(lengths), nullptr, nullptr, nullptr, out,
                 H, page, 1, max_pages, (long long)num_pages * page};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_decode<float, float, RUN>(a, B, D, st);
    if (dtype == 1)
        return (int)launch_decode<__nv_bfloat16, __nv_bfloat16, RUN>(a, B, D, st);
    return (int)cudaErrorInvalidValue;
}

// q, k_new, v_new [B, H, D] of type dtype (q pre-scaled); pools
// [P, page, H*D] int8; scales [P/chunk, 8, chunk*page] f32; out [B, H, D].
int decode_attention_int8(const void* q, void* k_pool, void* v_pool, const void* bases,
                          const void* lengths, const void* scales, const void* k_new,
                          const void* v_new, void* out, int B, int H, int D, int page,
                          int chunk, int max_pages, int num_pages, int dtype,
                          void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    DecodeArgs a{q, k_pool, v_pool, static_cast<const int*>(bases),
                 static_cast<const int*>(lengths), static_cast<const float*>(scales),
                 k_new, v_new, out, H, page, chunk, max_pages,
                 (long long)num_pages * page};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_decode<float, int8_t, RUN_I8>(a, B, D, st);
    if (dtype == 1)
        return (int)launch_decode<__nv_bfloat16, int8_t, RUN_I8>(a, B, D, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
