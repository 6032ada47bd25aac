// Paged decode attention over block tables, read only, Hopper (sm_90a),
// plain C interface. The kernel itself is decode_kernel in
// decode_common.cuh, mode TABLE_RO.
//
// Replaces: unilm_tpu/ops/paged_attention.py `_paged_kernel` (:44), reached
// through `paged_decode_attention` (:149) and runtime/paged_kv.py
// `paged_attention` (:101). Same contract: sequence b's token t lives at
// page tables[b, t / page], offset t % page, of the flat pool
// [P, page, H*D]; q is pre-scaled (in its own type, by the wrapper); the
// kernel attends over tokens 0..lengths[b]-1 with fp32 scores and an fp32
// online softmax, sums the unrounded probabilities into l and rounds them
// to the pool type for the PV product (:124-133), and writes
// acc / (l > 0 ? l : 1), so a sequence of length 0 gives 0. Table entries
// past ceil(L / page) are never read.
//
// The TPU kernel processes all H heads of a sequence in one grid step by
// lifting the head-coupled contraction into one MXU product with a
// block-diagonal query (H times the flops, free there under the DMA bound);
// that is a matrix-unit trick and is not carried over. Here one block per
// (sequence, head) walks the table; the B * H blocks run in parallel.
//
// What bounds it on the H100: bytes. It reads 2 * L * D pool elements per
// (sequence, head) and does ~4 flops per element, far below the ~295
// flop/byte ridge. With ragged lengths the longest sequence's blocks set
// the time (one block per SM walks all of its L tokens); splitting a
// sequence over several blocks with a merge pass is a later PR's work.

#include "decode_common.cuh"

extern "C" {

// q [B, H, D] pre-scaled; pools [P, page, H*D] of q's type (read only);
// tables [B, max_pages] int32; lengths [B] int32; out [B, H, D].
// dtype: 0 = float32, 1 = bfloat16.
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* lengths, void* out, int B, int H,
                    int D, int page, int max_pages, int num_pages, int dtype,
                    void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (max_pages <= 0 || page <= 0) return (int)cudaErrorInvalidValue;
    DecodeArgs a{q, const_cast<void*>(k_pool), const_cast<void*>(v_pool),
                 static_cast<const int*>(tables), static_cast<const int*>(lengths),
                 nullptr, nullptr, nullptr, out, H, page, 1, max_pages,
                 (long long)num_pages * page};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_decode<float, float, TABLE_RO>(a, B, D, st);
    if (dtype == 1)
        return (int)launch_decode<__nv_bfloat16, __nv_bfloat16, TABLE_RO>(a, B, D, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
