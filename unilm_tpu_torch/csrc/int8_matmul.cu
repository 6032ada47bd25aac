// Int8 weight-only matmul, Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/quant.py `_int8_matmul_kernel` (:59), reached
// through `_int8_matmul_2d` (:103) / `int8_matmul` (:149). Same contract:
// out[M, N] = (x[M, K] @ float(W)) * scale[N], fp32 accumulation, the
// per-output-channel scale applied once at the end, then one cast to x's
// type. int8 -> fp32 is exact and so is bf16 -> fp32, so the only
// difference from the plain version is the order of the fp32 sums.
// The weight is stored [N, K] (the torch Linear layout; the JAX kernel
// takes [K, N]), so a row of W is one output channel, contiguous in K.
//
// What bounds it on the H100: at decode (M = 1..8) the weight stream. An
// fp32 FMA per weight byte is ~1 flop/byte, far below the ~295 flop/byte
// ridge, so HBM (3.35 TB/s) sets the floor: 2.4 us for a 1536x1536
// projection, 9.4 us for 1536x6144. At M = 64 (a prefill chunk) or
// M = B * (k + 1) (speculative verify) the same weights serve 8x more rows
// and the fp32 CUDA cores and the x reads start to count.
// What the design does about it: one streaming kernel for every M. A block
// of 128 threads owns ROWS = 4 output channels and MT = 8 rows of x
// (grid.y tiles M); each thread walks K in steps of 8 int8 weights (one
// 8-byte load per channel, a warp reads 256 contiguous bytes of each
// channel) and keeps all ROWS x MT sums in fp32 registers; x rows come
// through L1/L2 (x is tiny and every block reads it). The block reduces its
// split-K partial sums with warp shuffles and shared memory, then applies
// the scale once. With grid.y > 1 each y-tile re-reads W from L2 (a 1536x6144
// int8 weight is 9.4 MB, the L2 holds 50 MB). No tensor cores yet: an
// int8/bf16 mma tile is a later PR's work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;  // output channels per block
constexpr int MT = 8;    // rows of x per block
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float2 x = __bfloat1622float2(h2[i]);
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
    }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
    float4 a = *reinterpret_cast<const float4*>(p);
    float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
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
                load8(x + (size_t)(m0 + m) * K + k, xf);
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
    dim3 grid((N + ROWS - 1) / ROWS, (M + MT - 1) / MT);
    int8_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), M, N, K);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] of type dtype; w [N, K] int8; scale [N] f32; out [M, N] of type
// dtype. K must be a multiple of 8. dtype: 0 = float32, 1 = bfloat16.
int int8_matmul(const void* x, const void* w, const void* scale, void* out, int M, int N,
                int K, int dtype, void* stream) {
    if (M <= 0 || N <= 0) return (int)cudaSuccess;
    if (K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
    if ((M + MT - 1) / MT > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch<float>(x, w, scale, out, M, N, K, st);
    if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, scale, out, M, N, K, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
