// Fused elementwise passes, Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/fused.py
//  - `_swiglu_kernel` (:30), reached through `swiglu` (:35):
//    out = silu(g) * u, with g and u upcast to fp32 and the result in g's
//    type, over the flattened arrays (any last dim, any row count);
//  - `_rotary_kernel` (:64), reached through `rotary_apply` (:80): the
//    interleaved (Tri Dao) rotation of x [B, T, H, D] by sin/cos [T, D/2],
//      out[2i]   = x[2i]   * cos_i - x[2i+1] * sin_i
//      out[2i+1] = x[2i+1] * cos_i + x[2i]   * sin_i,
//    fp32 math, the result in x's type. The TPU version tiles sin/cos over
//    B (a [B*T, D] copy of each); here each row b*T + t indexes sin/cos by
//    t, so they are read from [T, D/2] directly.
//
// What bounds them on the H100: bytes. Both read each input element once
// and write each output element once, with a few flops per element. The
// design: every thread moves 8 consecutive elements with 16-byte accesses
// (two for fp32), a grid-stride loop over the vectors, and fp32 math. A
// tensor whose pointers are not 16-byte aligned (or, for rotary, whose D
// is not a multiple of 8) takes the same kernels with scalar accesses.
// The rotary products and sums are rounded one by one (__fmul_rn,
// __fadd_rn, no fused multiply-add), as the plain version computes them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;  // elements per thread on the vector path
constexpr long long MAX_BLOCKS = 132LL * 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// 8 consecutive elements <-> fp32; p is 16-byte aligned
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
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// W elements from p into f: 16-byte accesses when W == V, scalar otherwise
template <int W, typename T> __device__ __forceinline__ void load_w(const T* p, float* f) {
    if constexpr (W == V) {
        load8(p, f);
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) f[i] = to_f(p[i]);
    }
}
template <int W, typename T> __device__ __forceinline__ void store_w(T* p, const float* f) {
    if constexpr (W == V) {
        store8(p, f);
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) p[i] = from_f<T>(f[i]);
    }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
    return g * (1.f / (1.f + expf(-g))) * u;
}

// out[i] = silu(g[i]) * u[i] for i < n; VEC: the first n / V * V elements
// in 16-byte vectors, the rest one by one
template <typename TG, typename TU, bool VEC>
__global__ void __launch_bounds__(THREADS)
swiglu_kernel(const TG* __restrict__ g, const TU* __restrict__ u, TG* __restrict__ out,
              long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    if constexpr (VEC) {
        const long long nv = n / V;
        for (long long i = i0; i < nv; i += stride) {
            float fg[V], fu[V], fo[V];
            load8(g + i * V, fg);
            load8(u + i * V, fu);
#pragma unroll
            for (int j = 0; j < V; ++j) fo[j] = silu_mul(fg[j], fu[j]);
            store8(out + i * V, fo);
        }
        done = nv * V;
    }
    for (long long e = done + i0; e < n; e += stride)
        out[e] = from_f<TG>(silu_mul(to_f(g[e]), to_f(u[e])));
}

// x, out [rows, H*D] with rows = B*T; sin/cos [T, D/2] fp32. Thread work
// item i covers W elements of one head: row = i / vpr, column
// (i % vpr) * W; W is even and divides D.
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
rotary_kernel(const T* __restrict__ x, const float* __restrict__ sin,
              const float* __restrict__ cos, T* __restrict__ out, int nitems, int vpr,
              int Tn, int D) {
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nitems; i += stride) {
        const int row = i / vpr;
        const int col = (i - row * vpr) * W;
        const int t = row % Tn;
        const int d0 = col % D;
        const size_t off = (size_t)i * W;
        const float* s = sin + (size_t)t * (D / 2) + d0 / 2;
        const float* c = cos + (size_t)t * (D / 2) + d0 / 2;
        float f[W], o[W];
        load_w<W>(x + off, f);
#pragma unroll
        for (int j = 0; j < W / 2; ++j) {
            const float sj = s[j], cj = c[j];
            const float x0 = f[2 * j], x1 = f[2 * j + 1];
            o[2 * j] = __fadd_rn(__fmul_rn(x0, cj), __fmul_rn(-x1, sj));
            o[2 * j + 1] = __fadd_rn(__fmul_rn(x1, cj), __fmul_rn(x0, sj));
        }
        store_w<W>(out + off, o);
    }
}

int blocks_for(long long work) {
    long long b = (work + THREADS - 1) / THREADS;
    if (b < 1) b = 1;
    return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TG, typename TU>
cudaError_t launch_swiglu(const void* g, const void* u, void* out, long long n,
                          cudaStream_t st) {
    const TG* gp = static_cast<const TG*>(g);
    const TU* up = static_cast<const TU*>(u);
    TG* op = static_cast<TG*>(out);
    if (aligned16(g) && aligned16(u) && aligned16(out))
        swiglu_kernel<TG, TU, true><<<blocks_for(n / V > 0 ? n / V : n), THREADS, 0, st>>>(
            gp, up, op, n);
    else
        swiglu_kernel<TG, TU, false><<<blocks_for(n), THREADS, 0, st>>>(gp, up, op, n);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rotary(const void* x, const float* sin, const float* cos, void* out,
                          int rows, int Tn, int H, int D, cudaStream_t st) {
    const T* xp = static_cast<const T*>(x);
    T* op = static_cast<T*>(out);
    const long long HD = (long long)H * D;
    if (D % V == 0 && aligned16(x) && aligned16(out)) {
        const int vpr = (int)(HD / V), nitems = (int)(rows * HD / V);
        rotary_kernel<T, V><<<blocks_for(nitems), THREADS, 0, st>>>(
            xp, sin, cos, op, nitems, vpr, Tn, D);
    } else {
        const int vpr = (int)(HD / 2), nitems = (int)(rows * HD / 2);
        rotary_kernel<T, 2><<<blocks_for(nitems), THREADS, 0, st>>>(
            xp, sin, cos, op, nitems, vpr, Tn, D);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, out: n elements of g_dtype; u: n elements of u_dtype.
// dtypes: 0 = float32, 1 = bfloat16.
int swiglu(const void* g, const void* u, void* out, long long n, int g_dtype, int u_dtype,
           void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (g_dtype == 0 && u_dtype == 0) return (int)launch_swiglu<float, float>(g, u, out, n, st);
    if (g_dtype == 0 && u_dtype == 1)
        return (int)launch_swiglu<float, __nv_bfloat16>(g, u, out, n, st);
    if (g_dtype == 1 && u_dtype == 0)
        return (int)launch_swiglu<__nv_bfloat16, float>(g, u, out, n, st);
    if (g_dtype == 1 && u_dtype == 1)
        return (int)launch_swiglu<__nv_bfloat16, __nv_bfloat16>(g, u, out, n, st);
    return (int)cudaErrorInvalidValue;
}

// x, out [rows, H, D] of dtype (rows = B*T, row r holds token r % T);
// sin, cos [T, D/2] float32. D even; rows * H * D < 2^31.
int rotary(const void* x, const void* sin, const void* cos, void* out, int rows, int T,
           int H, int D, int dtype, void* stream) {
    if (rows <= 0 || H <= 0) return (int)cudaSuccess;
    if (T <= 0 || D <= 0 || D % 2 || (long long)rows * H * D >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* s = static_cast<const float*>(sin);
    const float* c = static_cast<const float*>(cos);
    if (dtype == 0) return (int)launch_rotary<float>(x, s, c, out, rows, T, H, D, st);
    if (dtype == 1) return (int)launch_rotary<__nv_bfloat16>(x, s, c, out, rows, T, H, D, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
