// Int8 weight-only matmul, Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/quant.py `_int8_matmul_kernel` (:59), reached
// through `_int8_matmul_2d` (:103) / `int8_matmul` (:149). Same contract:
// out[M, N] = (x[M, K] @ float(W)) * scale[N], fp32 accumulation, the
// per-output-channel scale applied once at the end, then one cast to x's
// type. int8 -> bf16 is exact (|w| <= 127) and so is bf16 -> fp32, so the
// only difference from the plain version is the order of the fp32 sums.
// The weight is stored [N, K] (the torch Linear layout; the JAX kernel
// takes [K, N]), so a row of W is one output channel, contiguous in K.
//
// What bounds it on the H100: the weight stream. At decode (M = 1..8) and
// in a 64-token prefill chunk there are 2 M flops per weight byte, far
// below the ~295 flop/byte ridge, so HBM (3.35 TB/s) sets the floor: 0.7
// us for a 1536x1536 projection, 2.8 us for 1536x6144. What holds a kernel
// back from it is bytes in flight: the 9.4 MB of a 1536x6144 weight have
// to be requested across all 132 SMs at once, and the N / 64 = 24 .. 96
// channel tiles are too few blocks to do that alone.
//
// bf16 x (`hop::int8_mm_sm90`): swap-AB on the tensor cores. The output
// channels are wgmma's 64-row side, the rows of x its N side (MT = 8 for
// M <= 8, else 16, 32 or 64; larger M takes MT = 64 tiles over grid.z,
// each re-reading its W tile from L2). A block takes one 64-channel tile
// and one of `ksplit` ranges of whole 128-K chunks; the splits of a
// channel tile are one thread block cluster. Four producer warps take the
// chunks in turn and fill a ring of stages: the chunk's W box [64][128]
// int8 by a 2-D TMA map, issued first, then the chunk's x rows [MT][128]
// bf16 through registers (16-byte loads) into the 128-byte swizzle wgmma
// reads B in; the stage's mbarrier counts the TMA bytes and the warp's
// arrivals. The consumer warpgroup reads each thread's 32 W bytes of its
// two rows with 16-byte shared loads, turns them into the bf16 A
// fragments in registers (each int8 into the mantissa of 2^23 by a byte
// permute, less 2^23 + 128 in fp32, exact, then the upper halves of two
// fp32 packed as a bf16 pair) and issues eight RS wgmma m64nMTk16 a
// chunk; for MT >= 16 it makes chunk i + 1's fragments while chunk i's
// products run. The order of K inside a chunk is free, so K is permuted the same
// way in both operands: thread t of a quad takes the W bytes 32 t ..
// 32 t + 31 of its rows, byte 32 t + 4 s + u standing for column
// 2 t + (u & 1) + 8 (u >> 1) of k-step s, and the producers store x's pair
// 16 t + 2 s + v at logical pair 8 s + t + 4 v (`ops/quant.int8_k_order`
// is the same map; the CPU tests emulate with it). The plan
// (`ops/quant.int8_matmul_plan`, passed in by the wrapper) sizes the
// splits so that the blocks number about two an SM, with every chunk of a
// split in flight at once where the ring holds them. After the walk each
// block writes its fp32 partial tile to shared memory; after a cluster
// barrier every block sums a slice of the tile over the cluster's blocks
// in split order from their shared memory (deterministic: no atomics),
// applies the scale, casts and stores bf16 quads; a second barrier keeps
// the partials until they are read. Measured on an H100 (PERF.md §6):
// 128-K chunks stream the weight faster than 64-K ones, and x through
// registers beats 4-byte cp.async at M = 64; at M = 8 the launch with its
// two cluster barriers and the conversions, which the weight stream does
// not hide, stand between the kernel and its bound.
//
// fp32 x, and bf16 x with K % 16 != 0 (a row of W is then no TMA stride),
// keep the CUDA-core kernel (`cc::int8_matmul_kernel`): a block of 128
// threads owns 4 output channels and 8 rows of x, each thread walks K in
// steps of 8 int8 weights with fp32 sums.

#include "hopper.cuh"

namespace {

// ---- fp32 x: the CUDA-core kernel ------------------------------------------

namespace cc {

constexpr int THREADS = 128;
constexpr int ROWS = 4;  // output channels per block
constexpr int MT = 8;    // rows of x per block

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)c[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out, int M,
                   int N, int K) {
    const int n0 = blockIdx.x * ROWS;
    const int m0 = blockIdx.y * MT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int mrows = min(MT, M - m0);

    float acc[ROWS][MT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

    for (int k = tid * 8; k < K; k += THREADS * 8) {
        float wf[ROWS][8];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            if (n0 + r < N) {
                load8(w + (size_t)(n0 + r) * K + k, wf[r]);
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) wf[r][i] = 0.f;
            }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            if (m < mrows) {
                float xf[8];
                ::load8(x + (size_t)(m0 + m) * K + k, xf);
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    float s = 0.f;
#pragma unroll
                    for (int i = 0; i < 8; ++i) s += xf[i] * wf[r][i];
                    acc[r][m] += s;
                }
            }
        }
    }

    __shared__ float red[THREADS / 32][ROWS * MT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            float v = acc[r][m];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
            if (lane == 0) red[warp][r * MT + m] = v;
        }
    __syncthreads();
    if (tid < ROWS * MT) {
        const int r = tid / MT, m = tid % MT;
        const int n = n0 + r, mm = m0 + m;
        if (n < N && mm < M) {
            float s = 0.f;
#pragma unroll
            for (int w2 = 0; w2 < THREADS / 32; ++w2) s += red[w2][tid];
            out[(size_t)mm * N + n] = from_f<T>(s * scale[n]);
        }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M,
                   int N, int K, cudaStream_t stream) {
    if ((M + MT - 1) / MT > 65535) return cudaErrorInvalidValue;
    dim3 grid((N + ROWS - 1) / ROWS, (M + MT - 1) / MT);
    int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), M, N, K);
    return cudaGetLastError();
}

}  // namespace cc

// ---- bf16 x: swap-AB on wgmma, split-K merged in a cluster -----------------

namespace hop {

constexpr int CH = 64;                // output channels a block: wgmma's M
constexpr int KC = 128;               // K a chunk: a 128-byte row of W
constexpr int KS = KC / 16;           // k-steps a chunk
constexpr int W_BYTES = CH * KC;      // a chunk's W box [64][128] int8
constexpr int CONS = 128;             // the consumer warpgroup
constexpr int NPW = 4;                // producer warps
constexpr int THREADS = CONS + 32 * NPW;
constexpr int RED_LD = CH + 4;        // fp32 stride of a row of the partial tile
constexpr int MAX_SPLIT = 8;          // a portable cluster

// The plan (ops/quant.int8_matmul_plan computes it): MT rows of x a tile,
// ksplit K ranges a channel tile (the cluster), a ring of nst stages.
struct Plan {
    int mt, ksplit, nst;
};

struct Args {
    const bf16* x;
    const float* scale;
    bf16* out;
    int M, N, K;
};

// Shared memory: full[nst], empty[nst] barriers in the first 1024 bytes,
// then the ring, stage s = {x rows [MT][128 K] as two column boxes of
// [MT][128 bytes], W box [64][128 bytes]}, each in the 128-byte swizzle
// (so 1024-aligned); after the walk the block's fp32 partial tile
// [MT][RED_LD] over the ring's start.
template <int MT> struct Geo {
    static constexpr int X_BYTES = MT * 2 * KC;
    static constexpr int STAGE = X_BYTES + W_BYTES;
    static_assert(X_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms aligned");
    static __host__ __device__ int smem(int nst) {
        const int ring = nst * STAGE, red = MT * RED_LD * 4;
        return 1024 + (ring > red ? ring : red) + 1024;  // + alignment slack
    }
};

// Box of a 2-D tensor map at coordinates (c0 innermost, c1) into shared
// memory, completion counted in `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr));
    return v;
}

// the four fp32 at `p` (this block's shared memory) in block `rank`'s
__device__ __forceinline__ float4 ld_cluster4(const float* p, int rank) {
    uint32_t a;
    float4 v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(a));
    return v;
}

// Four int8 (a word of W) as the bf16 pairs (bytes 0, 1) and (bytes 2, 3):
// each biased byte b = w + 128 goes into the mantissa of 2^23 (one byte
// permute), one fp32 subtraction of 2^23 + 128 gives w exactly, and the
// upper half of an fp32 integer below 2^8 in magnitude is that integer in
// bf16.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
    const uint32_t x = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
        f[u] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + u)) - 8388736.f;
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// D[64 x MT] += A[64 x 16] B[16 x MT]: A in registers (bf16 pairs), B
// K-major in shared memory
template <int MT>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <> __device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
    sm90::wgmma_rs_n64_k(d, a, db, 1);
}

template <int MT>
__global__ void __launch_bounds__(THREADS)
int8_mm_sm90(const __grid_constant__ CUtensorMap tw, const Args p, const Plan pl) {
    using G = Geo<MT>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    const int nst = pl.nst, ks = pl.ksplit;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + nst;
    uint8_t* ring = smem + 1024;
    float* red = reinterpret_cast<float*>(ring);  // [MT][RED_LD], after the walk

    const int n0 = blockIdx.x * CH, m0 = blockIdx.z * MT;
    const int nchunk = (p.K + KC - 1) / KC, cps = (nchunk + ks - 1) / ks;
    const int c0 = blockIdx.y * cps, nc = max(0, min(nchunk, c0 + cps) - c0);
    const int tid = threadIdx.x, lane = tid & 31;

    if (tid == 0) {
        for (int s = 0; s < nst; ++s) {
            sm90::mbar_init(&full[s], 1 + 32);  // the TMA's arrival and a producer warp's
            sm90::mbar_init(&empty[s], CONS / 32);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // the role, warp-uniform through __shfl_sync
    const int warp = __shfl_sync(FULL, tid / 32, 0);
    float acc[MT / 2];
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;

    if (warp >= CONS / 32) {
        // producer warp pw: chunks pw, pw + NPW, .. (the ring's stages are a
        // multiple of NPW, so a stage is always filled by the same warp),
        // chunk i into stage i % nst once the consumers have read chunk
        // i - nst: first the W box by TMA, then x's rows [MT][128] through
        // registers, 16-byte loads of four pairs (pp = 4 q .. 4 q + 3 of a
        // row), pair pp (thread t's bytes 32 t .., k-step s, half v) to its
        // logical pair 8 s + t + 4 v, in column box pl / 32 at byte
        // 4 (pl % 32) of the swizzled row. Rows past M and columns past K
        // read as zeros, as does the W box past N and K.
        const int pw = warp - CONS / 32;
        if (pw == 0 && lane == 0) sm90::prefetch_tensormap(&tw);
        constexpr int NQ = MT * KC / 8;  // 16-byte pieces of x a chunk
        constexpr int PT = NQ / 32;      // a lane's
        constexpr int BT = PT < 8 ? PT : 8;  // in flight at once
        for (int i = pw; i < nc; i += NPW) {
            const int s = i % nst;
            if (i >= nst) sm90::mbar_wait(&empty[s], (i / nst - 1) & 1);
            uint8_t* st = ring + (size_t)s * G::STAGE;
            if (lane == 0) {
                sm90::mbar_arrive_expect_tx(&full[s], W_BYTES);
                tma_load_2d(st + G::X_BYTES, &tw, &full[s], (c0 + i) * KC, n0);
            }
#pragma unroll
            for (int j0 = 0; j0 < PT; j0 += BT) {
                uint4 u[BT];
#pragma unroll
                for (int j = 0; j < BT; ++j) {
                    const int idx = lane + 32 * (j0 + j), m = idx / (KC / 8);
                    const int k = (c0 + i) * KC + 8 * (idx % (KC / 8));
                    u[j] = m0 + m < p.M && k < p.K
                               ? *reinterpret_cast<const uint4*>(p.x + (size_t)(m0 + m) * p.K + k)
                               : make_uint4(0, 0, 0, 0);
                }
#pragma unroll
                for (int j = 0; j < BT; ++j) {
                    const int idx = lane + 32 * (j0 + j), m = idx / (KC / 8);
                    const uint32_t w4[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int pp = 4 * (idx % (KC / 8)) + e;
                        const int t = pp / (2 * KS), s8 = (pp >> 1) % KS, v = pp & 1;
                        const int pl = 8 * s8 + t + 4 * v, o = 4 * (pl & 31);
                        *reinterpret_cast<uint32_t*>(st + (pl >> 5) * MT * 128 + m * 128 +
                                                     ((((o >> 4) ^ (m & 7)) << 4) | (o & 15))) =
                            w4[e];
                    }
                }
            }
            // the rows, generic-proxy writes, before wgmma reads them
            // through the async proxy
            sm90::fence_proxy_async();
            sm90::mbar_arrive(&full[s]);
        }
    } else {
        // the consumer warpgroup: thread (warp w, lane 4 g + t) holds rows
        // r = 16 w + g and r + 8 of the A fragments
        const int w = warp, g = lane >> 2, t = lane & 3;
        // chunk i's A fragments: the thread's W bytes 32 t .. 32 t + 31 of
        // rows r and r + 8, the 16-byte chunks 2 t and 2 t + 1 of a
        // 128-byte row, which the 128-byte swizzle puts at (2 t) ^ (r % 8)
        // and its neighbour (conflict-free)
        auto fragments = [&](int i, uint32_t (&a)[KS][4]) {
            const int s = i % nst;
            sm90::mbar_wait(&full[s], (i / nst) & 1);
            const uint32_t wb =
                smem_addr(ring + (size_t)s * G::STAGE) + G::X_BYTES + (16 * w + g) * KC;
            uint32_t r0[KS], r1[KS];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int pos = (2 * t + c) ^ g;
                const uint4 w0 = lds128(wb + 16 * pos), w1 = lds128(wb + 8 * KC + 16 * pos);
                r0[4 * c] = w0.x;
                r0[4 * c + 1] = w0.y;
                r0[4 * c + 2] = w0.z;
                r0[4 * c + 3] = w0.w;
                r1[4 * c] = w1.x;
                r1[4 * c + 1] = w1.y;
                r1[4 * c + 2] = w1.z;
                r1[4 * c + 3] = w1.w;
            }
#pragma unroll
            for (int k = 0; k < KS; ++k) {
                i8x4_to_bf16x2(r0[k], a[k][0], a[k][2]);
                i8x4_to_bf16x2(r1[k], a[k][1], a[k][3]);
            }
        };
        // chunk i's eight products, one commit group
        auto products = [&](int i, const uint32_t (&a)[KS][4]) {
            const uint32_t xs = smem_addr(ring + (size_t)(i % nst) * G::STAGE);
            sm90::wgmma_fence();
#pragma unroll
            for (int k = 0; k < KS; ++k)
                wgmma_rs<MT>(acc, a[k], sm90::make_desc(xs + (k / 4) * MT * 128 + 32 * (k % 4),
                                                        16, 1024, sm90::SW128));
            sm90::wgmma_commit();
        };
        auto release = [&](int i) {
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(&empty[i % nst]);
        };
        if constexpr (MT == 8) {
            // short products: each chunk's waited for before the next
            for (int i = 0; i < nc; ++i) {
                uint32_t a[KS][4];
                fragments(i, a);
                products(i, a);
                sm90::wgmma_wait<0>();
                release(i);
            }
        } else {
            // chunk i + 1's fragments made while chunk i's products run
            // (faster on an H100 at M = 64, no gain at MT = 8)
            uint32_t a0[KS][4], a1[KS][4];
            for (int i = 0; i < nc; i += 2) {
                fragments(i, a0);
                products(i, a0);
                if (i > 0) {
                    sm90::wgmma_wait<1>();
                    release(i - 1);
                }
                if (i + 1 < nc) {
                    fragments(i + 1, a1);
                    products(i + 1, a1);
                    sm90::wgmma_wait<1>();
                    release(i);
                }
            }
            sm90::wgmma_wait<0>();
            if (nc > 0) release(nc - 1);
        }
        // the partial tile [m][channel] over the ring, once every consumer
        // has read its last stage: acc[4 j + 2 h + e] is channel 16 w + g +
        // 8 h, row 8 j + 2 t + e
        sm90::named_sync(1, CONS);
#pragma unroll
        for (int j = 0; j < MT / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    red[(8 * j + 2 * t + e) * RED_LD + 16 * w + g + 8 * h] = acc[4 * j + 2 * h + e];
    }

    // the cluster's splits, each block summing its slice of the tile over
    // the blocks in split order (every split's quad loaded first); the
    // second barrier keeps them until read
    sm90::cluster_sync();
    const int rank = sm90::cluster_rank();
    constexpr int NQT = MT * CH / 4;  // quads of the tile
    const int per = (NQT + ks - 1) / ks;
    const int q1 = min(NQT, (rank + 1) * per);
    for (int q = rank * per + tid; q < q1; q += THREADS) {
        const int m = q / (CH / 4), c = 4 * (q % (CH / 4));
        const float* src = red + m * RED_LD + c;
        float4 v[MAX_SPLIT];
#pragma unroll
        for (int r = 0; r < MAX_SPLIT; ++r)
            if (r < ks) v[r] = ld_cluster4(src, r);
        float4 sum = v[0];
#pragma unroll
        for (int r = 1; r < MAX_SPLIT; ++r)
            if (r < ks) {
                sum.x += v[r].x;
                sum.y += v[r].y;
                sum.z += v[r].z;
                sum.w += v[r].w;
            }
        const int mm = m0 + m, n = n0 + c;
        if (mm >= p.M) continue;
        const float y[4] = {sum.x, sum.y, sum.z, sum.w};
        bf16* dst = p.out + (size_t)mm * p.N + n;
        if (n + 3 < p.N && p.N % 4 == 0) {
            const float4 sc = *reinterpret_cast<const float4*>(p.scale + n);
            uint2 o;
            o.x = pack(y[0] * sc.x, y[1] * sc.y);
            o.y = pack(y[2] * sc.z, y[3] * sc.w);
            *reinterpret_cast<uint2*>(dst) = o;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (n + e < p.N) dst[e] = __float2bfloat16(y[e] * p.scale[n + e]);
        }
    }
    sm90::cluster_sync();
}

// W [N, K] int8 as the 2-D map (K, N) with box (128, 64) and the 128-byte
// swizzle; past the tensor's end the box reads zeros
inline bool w_map(sm90::EncodeTiled enc, CUtensorMap* map, const void* w, int N, int K) {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)CH};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT>
cudaError_t launch_mt(const CUtensorMap& tw, const Args& p, const Plan& pl, cudaStream_t stream) {
    const int smem = Geo<MT>::smem(pl.nst);
    auto kern = int8_mm_sm90<MT>;
    // the attribute once per device and size
    static int set_for[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || set_for[dev] < smem) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
        if (dev < 64) set_for[dev] = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((p.N + CH - 1) / CH, pl.ksplit, (p.M + MT - 1) / MT);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = pl.ksplit;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, tw, p, pl);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

cudaError_t launch(const Args& p, const void* w, const Plan& pl, cudaStream_t stream) {
    const int nchunk = (p.K + KC - 1) / KC;
    if (pl.ksplit < 1 || pl.ksplit > MAX_SPLIT || pl.ksplit > nchunk || pl.nst < 1 ||
        pl.nst % NPW || 2 * pl.nst * 8 > 1024 || (p.M + pl.mt - 1) / pl.mt > 65535)
        return cudaErrorInvalidValue;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    CUtensorMap tw;
    if (!w_map(enc, &tw, w, p.N, p.K)) return cudaErrorInvalidValue;
    switch (pl.mt) {
        case 8: return launch_mt<8>(tw, p, pl, stream);
        case 16: return launch_mt<16>(tw, p, pl, stream);
        case 32: return launch_mt<32>(tw, p, pl, stream);
        case 64: return launch_mt<64>(tw, p, pl, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace hop

}  // namespace

extern "C" {

// x [M, K] of type dtype; w [N, K] int8; scale [N] f32; out [M, N] of type
// dtype. K must be a multiple of 8. dtype: 0 = float32, 1 = bfloat16.
// bf16 with K % 16 == 0 takes the wgmma kernel with the plan (mt, ksplit,
// nst) of ops/quant.int8_matmul_plan; the rest the CUDA-core kernel, which
// ignores it.
int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M, int N,
                int K, int dtype, int mt, int ksplit, int nst, void* stream) {
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    if (K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1 && K % 16 == 0) {
        const hop::Args p{static_cast<const bf16*>(x), static_cast<const float*>(scale),
                          static_cast<bf16*>(out), M, N, K};
        return (int)hop::launch(p, w, hop::Plan{mt, ksplit, nst}, st);
    }
    if (dtype == 0) return (int)cc::launch<float>(x, w, scale, out, M, N, K, st);
    if (dtype == 1) return (int)cc::launch<__nv_bfloat16>(x, w, scale, out, M, N, K, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
