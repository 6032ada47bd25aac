// Hopper (sm_90a) building blocks for kernels written by hand: mbarriers,
// TMA tile loads from a CUtensorMap, wgmma shared-memory descriptors and
// the bf16 wgmma products with fp32 accumulators, the 64-row products and
// the cp.async staging of bf16 planes that the backward kernels share,
// setmaxnreg, named barriers and the cluster barrier with loads from
// another block's shared memory, written in PTX as the PTX ISA defines it;
// no CUTLASS.
// Shared-memory addresses come from mma_common.cuh's smem_addr. Users:
// csrc/flash_fwd.cu (#1), csrc/flash_tri.cu (#2), csrc/encoder_attention.cu
// (#3), csrc/encoder_attention_bwd.cu (#4), csrc/onepass_attention.cu (#5),
// csrc/flash_bwd.cu (#6, #7), csrc/flash_bwd_fused.cu (#8: products with
// both operands transposed, the bulk reduce-add of fp32 tiles),
// csrc/doc_attention.cu (#9), csrc/doc_attention_bwd.cu (#10),
// csrc/decode_attention.cu (#13: 3-D maps, clusters), csrc/paged_attention.cu
// (#11, both through csrc/decode_split.cuh) and csrc/int8_matmul.cu (#14).
//
// The host side takes cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so the libraries need no -lcuda, and encodes
// the 4-D maps of [B, rows, H, D] bf16 tensors the kernels load from.

#pragma once

#include <cuda.h>

#include "mma_common.cuh"

namespace {
namespace sm90 {

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

// makes the mbarrier.init of this thread visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also raises the phase's expected transaction bytes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    return done != 0;
}

// an arrival on `bar` once every earlier cp.async of this thread has
// landed, counted as one of the phase's expected arrivals
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
                 : "memory");
}

// 4 or 16 bytes global -> shared without passing through registers (both
// addresses aligned to the size); `bytes` below the size reads that many
// and zero-fills the rest (0: nothing is read)
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp16n(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait that
// outlasts 10 s traps, so a fault in the pipeline fails the launch instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    if (mbar_try_wait(addr, parity)) return;
    const unsigned long long t0 = globaltimer_ns();
    while (!mbar_try_wait(addr, parity))
        if (globaltimer_ns() - t0 > 10000000000ull) __trap();
}

// 2^x as one MUFU instruction: exp2f wraps it in a fix-up for subnormal
// results, several more instructions per value; results below 2^-126
// flush to 0, and 2^-inf is 0.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// ---- TMA ------------------------------------------------------------------

// Box of a 4-D tensor map at coordinates (c0 innermost .. c3) into shared
// memory; completion adds the box's bytes to `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// Box of a 3-D tensor map at coordinates (c0 innermost .. c2), as
// tma_load_4d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Element-wise add of a box of a 4-D fp32 tensor map at coordinates (c0
// innermost .. c3) from shared memory into global memory, performed in L2;
// elements past the tensor's end are left out. Completion is tracked by
// this thread's bulk async-groups (bulk_commit / bulk_wait).
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, const void* src,
                                                  int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
        "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// every bulk async-group of this thread complete: its writes performed
__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's global accesses against its async-proxy ones
__device__ __forceinline__ void fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
                 : "memory");
}

// ---- warp specialisation --------------------------------------------------

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands written by the threads)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- thread block clusters ------------------------------------------------

// every thread of every block of the cluster: writes to shared memory
// before it are visible to the cluster's blocks after it
__device__ __forceinline__ void cluster_sync() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// this block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return (int)r;
}

// the fp32 at `p` (this block's shared memory) in the shared memory of
// block `rank` of the cluster
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
    uint32_t a;
    float v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
    return v;
}

// ---- wgmma ----------------------------------------------------------------

// Swizzle modes of a descriptor (bits 62-63); a tensor map's
// CU_TENSOR_MAP_SWIZZLE_128B / _64B tiles match SW128 / SW64.
constexpr uint64_t SW128 = 1, SW64 = 2;

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units), swizzle mode; base offset 0, so a
// swizzle atom (8 rows of the swizzle span) must start at an address
// aligned to 8 spans.
//  K-major operand (rows of K contiguous elements): SBO = the distance of
//    two 8-row groups, LBO unused (1); the k-th 16-element step starts 32k
//    bytes into the row.
//  MN-major operand (rows of N contiguous elements, transposed): SBO = the
//    distance of two 8-row groups along K, LBO = the distance of two
//    swizzle-span column blocks along N.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// A [rows, D] bf16 tile in shared memory as NC boxes of CW columns, box c
// holding [rows, CB bytes] at c * rows * CB, with the swizzle whose span is
// CB: 128-byte swizzle at D = 64 and 128; D = 96 takes three 32-column
// boxes with the 64-byte swizzle (192-byte rows fit no 128-byte atom), and
// D = 32 one such box (a 64-byte row, two k-steps of 16).
template <int D> struct Cols {
    static_assert(D == 32 || D == 64 || D == 96 || D == 128, "head dim");
    static constexpr int CW = D % 64 == 0 ? 64 : 32;
    static constexpr int CB = CW * 2;
    static constexpr int NC = D / CW;
    static constexpr uint64_t SWZ = CB == 128 ? SW128 : SW64;
};

// The descriptor of k-step kk (16 columns) of box c of such a tile of R
// rows, read K-major from its first row at `base`.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int c, int kk) {
    using C = Cols<D>;
    return make_desc(base + c * R * C::CB + kk * 32, 16, 8 * C::CB, C::SWZ);
}

// The descriptor of k-step kk (rows 16 kk ..) of such a tile of R rows,
// read MN-major (the transpose bit): rows are K, the D columns N.
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
    using C = Cols<D>;
    return make_desc(base + kk * 16 * C::CB, R * C::CB, 8 * C::CB, C::SWZ);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A warpgroup's 64 x N fp32 accumulator: thread t (warp w = t / 32, lane
// l) holds d[4n + 2h + e] = D[16w + l/4 + 8h][8n + 2(l%4) + e]. The
// register A operand of the RS form has the m16n8k16 layout: for the
// k-step of columns 16k .. 16k+15, a[0] = (row l/4, cols 2(l%4) + {0,1}),
// a[1] = row + 8, a[2] = cols + 8, a[3] = both; so the accumulator of one
// product repacks into the A operand of the next without a shuffle.

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_k(float* d, const uint32_t* a, uint64_t db,
                                               int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 96] += A[64 x 16] B[16 x 96], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers (bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x N] += A[64 x 16] B[16 x N] for N = a head dim, A in registers
// (bf16 pairs), B MN-major in shared memory
template <int N> __device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
    static_assert(N == 32 || N == 64 || N == 96 || N == 128, "head dim");
    if constexpr (N == 32)
        wgmma_rs_n32(d, a, db);
    else if constexpr (N == 64)
        wgmma_rs_n64(d, a, db);
    else if constexpr (N == 96)
        wgmma_rs_n96(d, a, db);
    else
        wgmma_rs_n128(d, a, db);
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B both MN-major in shared
// memory (the transpose bits): A stored as 16 rows of its 64 M values, B as
// 16 rows of its N values
__device__ __forceinline__ void wgmma_ss_tt_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tt_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tt_n96(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_tt_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// the same for N = a head dim
template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float* d, uint64_t da, uint64_t db, int accumulate) {
    static_assert(N == 32 || N == 64 || N == 96 || N == 128, "head dim");
    if constexpr (N == 32)
        wgmma_ss_tt_n32(d, da, db, accumulate);
    else if constexpr (N == 64)
        wgmma_ss_tt_n64(d, da, db, accumulate);
    else if constexpr (N == 96)
        wgmma_ss_tt_n96(d, da, db, accumulate);
    else
        wgmma_ss_tt_n128(d, da, db, accumulate);
}

// ---- products of 64-row tiles, and bf16 planes by 16-byte cp.async --------
// (the backward kernels #10, csrc/doc_attention_bwd.cu, and #4,
// csrc/encoder_attention_bwd.cu)

// acc[N / 2] = A B^T for a [64, D] tile A and an [N, D] tile B (N = 64 or
// 128), both read K-major; RA and RB are the rows of the boxes they lie in
template <int D, int RA, int RB, int N = 64>
__device__ __forceinline__ void ss_product(float* acc, uint32_t a, uint32_t b) {
    using C = Cols<D>;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
        for (int kk = 0; kk < C::CW / 16; ++kk) {
            const uint64_t da = kmajor_desc<D, RA>(a, c, kk), db = kmajor_desc<D, RB>(b, c, kk);
            if constexpr (N == 128)
                wgmma_ss_n128(acc, da, db, c | kk);
            else
                wgmma_ss_n64(acc, da, db, c | kk);
        }
}

// acc[D / 2] += A B for A [64, 64] given as its bf16 fragments a[16] and B
// a [64, D] tile (of a box of 64 rows) read MN-major (the transpose bit)
template <int D>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* a, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, a + 4 * kk, mnmajor_desc<D, 64>(b, kk));
}

// The A-fragment register of the accumulator pair (row 16 w + r8 + 8 hh,
// columns 8 nn + 2 quad + {0, 1}): k-step nn / 2, m16n8k16 order (above),
// so a product's accumulator repacks with no shuffle.
__device__ __forceinline__ constexpr int afrag(int nn, int hh) {
    return 4 * (nn >> 1) + 2 * (nn & 1) + hh;
}

// A bias or ds row holds S bf16: 1418 bytes at S = 709, 394 at S = 197, no
// multiple of 16, so no TMA map takes such planes, and a row starts at any
// 2-byte offset. The producer warpgroup copies a tile of R rows x C keys
// with 16-byte cp.async: row r as the aligned 16-byte chunks that cover its
// keys [c0, c0 + C), so that key c sits at element c - c0 + off, off = the
// first key's element mod 8 (0..7); rows past the plane read as zeros,
// chunks past the plane's end are cut there, and keys past S in the last
// chunk hold the next row's values (the consumers mask them). Row stride
// LDW words: the chunks plus none (C / 8 + 1 chunks: 36 words at C = 64,
// 68 at 128), so that the consumers' fragment reads (8 rows of 4 words, or
// 4 rows two apart of 5) fall on distinct banks.
template <int C> struct Plane {
    static constexpr int NCH = C / 8 + 1;  // 16-byte chunks a row
    static constexpr int LDW = NCH * 4;
    static constexpr int BYTES_PER_ROW = LDW * 4;
    static_assert(LDW % 32 == 4, "rows four banks apart");
};

// rows [r0, r0 + R) of the plane whose element (0, 0) is element `base`
// of `plane`, keys [c0, c0 + C), `rmax` rows in the plane; the 128
// threads of a warpgroup, `tid` its thread
template <int R, int C>
__device__ __forceinline__ void stage_plane(uint32_t* dst, const bf16* plane, size_t base, int S,
                                            int rmax, int r0, int c0, int tid) {
    constexpr int NCH = Plane<C>::NCH, LDW = Plane<C>::LDW;
    const size_t end = base + (size_t)rmax * S;  // one past the plane
    for (int i = tid; i < R * NCH; i += 128) {
        const int r = i / NCH, c = i % NCH, row = r0 + r;
        const size_t e = ((base + (size_t)row * S + c0) & ~(size_t)7) + 8 * c;
        const int bytes = row < rmax ? (int)min((size_t)16, e < end ? 2 * (end - e) : 0) : 0;
        cp16n(dst + r * LDW + 4 * c, bytes ? plane + e : plane, bytes);
    }
}

// where key c0 of row `row` starts in its staged row (the parity and the
// chunk offset of its element)
__device__ __forceinline__ int stage_off(size_t base, int row, int S, int c0) {
    return (int)((base + (size_t)row * S + c0) & 7);
}

// the bf16 bits at element k (key - c0 + off) of row r of a staged tile
template <int C>
__device__ __forceinline__ uint32_t tile_bits(const uint32_t* tile, int r, int k) {
    return reinterpret_cast<const unsigned short*>(tile + r * Plane<C>::LDW)[k];
}

__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }

// ---- host: tensor maps ----------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult res;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res) ==
                cudaSuccess &&
            res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// [B, R, H, D] bf16 as the 4-D map (D, H, R, B) with box (CW, 1, rows, 1)
// and Cols<D>'s swizzle: a box never crosses a head or a batch, and rows
// past R read as zeros.
template <int D>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int B, int R, int H,
              int rows) {
    using C = Cols<D>;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)R, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                   (cuuint64_t)R * H * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::CW, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               C::CB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [B, R, H, D] fp32 as the 4-D map (D, H, R, B) with box (32, 1, rows, 1)
// and the 128-byte swizzle: D / 32 boxes take a [rows, D] tile, box c
// holding columns 32 c .. 32 c + 31 as [rows, 128 bytes]
inline bool make_map_f32(EncodeTiled enc, CUtensorMap* map, const void* base, int B, int R,
                         int H, int D, int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)R, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                   (cuuint64_t)R * H * D * 4};
    const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace
