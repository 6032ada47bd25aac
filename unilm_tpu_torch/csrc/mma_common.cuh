// Tensor-core building blocks shared by the bf16 attention kernels
// (encoder_attention_bwd.cu, doc_attention.cu, doc_attention_bwd.cu):
// mma.sync m16n8k16 bf16 products with fp32 accumulators, fragment loads
// from row-major shared-memory tiles (ldmatrix .trans for the transposed
// operand), the accumulator-to-operand repack, and cp.async tile staging.

#pragma once

#include "flash_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// a pair of bf16 values times s, rounded back to bf16
__device__ __forceinline__ uint32_t scale2(uint32_t x, float s) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
    return pack(f.x * s, f.y * s);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zeros when
// !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a b for a 16x16 (row) and a 16x8 (col) bf16 fragment
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* x, int ld, int r0, int k0,
                                       int g, int tq) {
    const bf16* p = x + (r0 + g) * ld + k0 + 2 * tq;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

// B fragments of two n-tiles (columns n0.. and n0+8..) for k = rows
// k0..k0+15 of a row-major tile x[k][n]: ldmatrix .trans reads them as the
// transpose, b[0], b[1] for n-tile n0 and b[2], b[3] for n0 + 8
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* x, int ld, int k0, int n0,
                                        int lane) {
    const int mi = lane >> 3;
    const bf16* p = x + (k0 + (lane & 7) + 8 * (mi & 1)) * ld + n0 + 8 * (mi >> 1);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(smem_addr(p)));
}

// the A fragment of a 16x16 block held as two accumulator tiles (columns
// 8j.. and 8j+8..), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
    a[0] = pack(c0[0], c0[1]);
    a[1] = pack(c0[2], c0[3]);
    a[2] = pack(c1[0], c1[1]);
    a[3] = pack(c1[2], c1[3]);
}

// rows [nrows] x D of a [*, H, D] tensor into a tile of row stride ld, by
// cp.async from NT threads; rows at or past `valid` are zero
template <int D, int NT>
__device__ __forceinline__ void stage_async(bf16* x, int ld, const bf16* src, size_t row_stride,
                                            int nrows, int valid, int tid) {
    constexpr int D8 = D / 8;
    for (int i = tid; i < nrows * D8; i += NT) {
        const int r = i / D8, d = (i % D8) * 8;
        cp16(x + r * ld + d, r < valid ? src + (size_t)r * row_stride + d : src, r < valid);
    }
}

}  // namespace
