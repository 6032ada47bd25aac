// Fused serving decode step over block tables, Hopper (sm_90a), plain C
// interface. The kernel itself is decode_kernel in decode_common.cuh, mode
// TABLE.
//
// Replaces: unilm_tpu/ops/paged_attention.py `_paged_append_batched_kernel`
// (:213), reached through `paged_decode_append_attention` (:387). Same
// contract: sequence b's token t lives at page tables[b, t / page], offset
// t % page, of the flat pool [P, page, H*D]; the kernel writes this step's
// K/V row (cast to the pool type) at token L = lengths[b] and attends over
// the L + 1 tokens. As in the TPU kernel the new row is part of the walk,
// so its probability is rounded to the pool type like every other token's
// (:328, :360). The TPU kernel patches the row into the page while the page
// is resident in VMEM and DMAs the page back; here the block of (b, h)
// writes exactly the D columns of head h of that row and then reads them
// back itself, so no two blocks touch the same columns of an active
// sequence's row. Inactive slots (all-zero table rows, length 0) all write
// row 0 of the trash page at once, as on the TPU: their outputs and the
// trash page are meaningless.
//
// What bounds it on the H100: bytes, as for decode_attention.cu (2 * (L+1)
// * D pool elements per (sequence, head), ~4 flops each), plus one table
// lookup per token, which hits L1. The TPU kernel stacks all sequences'
// pages in one grid program to fill the MXU; on Hopper the B * H blocks run
// in parallel instead, one per (sequence, head).

#include "decode_common.cuh"

extern "C" {

// q, k_new, v_new [B, H, D] (q pre-scaled); pools [P, page, H*D] of the same
// type, updated in place; tables [B, max_pages] int32; lengths [B] int32;
// out [B, H, D]. dtype: 0 = float32, 1 = bfloat16.
int paged_append_attention(const void* q, void* k_pool, void* v_pool, const void* tables,
                           const void* lengths, const void* k_new, const void* v_new,
                           void* out, int B, int H, int D, int page, int max_pages,
                           int num_pages, int dtype, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (max_pages <= 0) return (int)cudaErrorInvalidValue;
    DecodeArgs a{q, k_pool, v_pool, static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), nullptr, k_new, v_new, out,
                 H, page, 1, max_pages, (long long)num_pages * page};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_decode<float, float, TABLE>(a, B, D, st);
    if (dtype == 1)
        return (int)launch_decode<__nv_bfloat16, __nv_bfloat16, TABLE>(a, B, D, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
