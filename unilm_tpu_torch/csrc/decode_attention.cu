// One-token decode attention over contiguous KV page runs, Hopper (sm_90a),
// plain C interface.
//
// Replaces: unilm_tpu/ops/paged_attention.py `_run_decode_kernel` (:497),
// reached through `run_decode_append_attention` (:647), in its
// non-quantized variant (bf16 or fp32 pools). Same contract: sequence b's
// tokens live in the flat pool [P, page, H*D] from page `bases[b]` on, one
// contiguous run; the wrapper has already written this step's K/V row at
// token L = lengths[b]; the kernel attends q over the L + 1 tokens with an
// fp32 online softmax. It reads only the L + 1 rows that hold tokens,
// i.e. only the ceil((L + 1) / (chunk * page)) slabs of the TPU kernel and
// never the rest of the run's page budget. The TPU kernel merges the new
// token analytically from k_new/v_new; here it is read back from the pool
// (bit-identical, since the row was written first) and, as there, its
// probability enters the PV sum unrounded while the pool tokens' are
// rounded to the pool's storage type.
//
// What bounds it on the H100: bytes. Each step reads 2 * (L + 1) * D
// elements per (sequence, head) and does 4 flops per element, far below
// the ~295 flop/byte ridge, so HBM bandwidth (3.35 TB/s) is the limit —
// if enough loads are in flight. With one block per (sequence, head) the
// grid has B * H blocks: at B = 1, H = 16 that is 16 blocks on 132 SMs,
// so this version cannot reach the bandwidth bound at batch 1; splitting
// each sequence's tokens over several blocks (split-K with a second merge
// pass) is a later PR's work.
// What the design does about it: 32 warps per block walk 32-token tiles
// in parallel (at L = 2052 each warp walks 2-3 tiles, so a block pays a
// few load latencies in sequence, not one per tile); each lane loads a whole K row with 16-byte vector loads and
// computes its token's score alone (no per-token shuffle reduction); V is
// read with lane-contiguous (coalesced) loads, 8 tokens' rows in flight at
// once (one load latency per token was 84 us/layer at L = 2052); the
// warps' partial (max, sum, acc) states are merged once through shared
// memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 32;
constexpr int UB = 8;  // tokens whose V rows are loaded together
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ bases,
              const int* __restrict__ lengths, T* __restrict__ out, int H,
              int page, int max_tokens, long long pool_rows) {
    constexpr int DPL = D / 32;
    __shared__ __align__(16) float qs[D];
    __shared__ float wm[NWARPS], wl[NWARPS];
    __shared__ float wacc[NWARPS][D];

    const int b = blockIdx.x, h = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t HD = (size_t)H * D;
    const int L = lengths[b];
    const long long row0 = (long long)bases[b] * page;
    // tokens 0..L (the new one included), clamped to the run's budget
    long long n = min((long long)L + 1, (long long)max_tokens);
    n = min(n, pool_rows - row0);

    for (int d = tid; d < D; d += NWARPS * 32)
        qs[d] = to_f(q[((size_t)b * H + h) * D + d]);
    __syncthreads();

    float m = NEG_INF, lpart = 0.f, acc[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;

    const T* kbase = kp + (size_t)row0 * HD + (size_t)h * D;
    const T* vbase = vp + (size_t)row0 * HD + (size_t)h * D;
    for (long long t0 = (long long)warp * 32; t0 < n; t0 += NWARPS * 32) {
        const long long t = t0 + lane;
        const bool valid = t < n;
        float s = NEG_INF;
        if (valid) {
            const T* kr = kbase + (size_t)t * HD;
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D; d += 8) {
                float f[8];
                load8(kr + d, f);
                const float4 qa = *reinterpret_cast<const float4*>(qs + d);
                const float4 qb = *reinterpret_cast<const float4*>(qs + d + 4);
                dot += qa.x * f[0] + qa.y * f[1] + qa.z * f[2] + qa.w * f[3] +
                       qb.x * f[4] + qb.y * f[5] + qb.z * f[6] + qb.w * f[7];
            }
            s = dot;
        }
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_new = fmaxf(m, mx);
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m - m_new);
        lpart = lpart * alpha + p;
        m = m_new;
        // pool tokens' probabilities are rounded to the storage type; the
        // new token's (t == L) enters unrounded, as in the TPU kernel merge
        const float pr = (t == L) ? p : to_f(from_f<T>(p));
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[c] *= alpha;
        // PV over the tile, UB tokens at a time: their V loads are all
        // issued before the FMAs, so the tile pays a few load latencies
        // instead of one per token
        const int cnt = (int)min((long long)32, n - t0);
        for (int u0 = 0; u0 < cnt; u0 += UB) {
            float pu[UB], vv[UB][DPL];
#pragma unroll
            for (int u = 0; u < UB; ++u) {
                pu[u] = __shfl_sync(FULL, pr, u0 + u);  // 0 past the end
                const T* vr = vbase + (size_t)(t0 + u0 + u) * HD;
#pragma unroll
                for (int c = 0; c < DPL; ++c)
                    vv[u][c] = u0 + u < cnt ? to_f(vr[lane + 32 * c]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < UB; ++u)
#pragma unroll
                for (int c = 0; c < DPL; ++c) acc[c] += pu[u] * vv[u][c];
        }
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lpart += __shfl_xor_sync(FULL, lpart, o);
    if (lane == 0) {
        wm[warp] = m;
        wl[warp] = lpart;
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) wacc[warp][lane + 32 * c] = acc[c];
    __syncthreads();

    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, wm[w]);
    float l = 0.f, sc[NWARPS];
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
        sc[w] = expf(wm[w] - M);
        l += wl[w] * sc[w];
    }
    const float denom = l > 0.f ? l : 1.f;
    for (int d = tid; d < D; d += NWARPS * 32) {
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) o += wacc[w][d] * sc[w];
        out[((size_t)b * H + h) * D + d] = from_f<T>(o / denom);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* bases,
                   const int* lengths, void* out, int B, int H, int page,
                   int max_tokens, long long pool_rows, cudaStream_t stream) {
    dim3 grid(B, H);
    decode_kernel<T, D><<<grid, NWARPS * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        bases, lengths, static_cast<T*>(out), H, page, max_tokens, pool_rows);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* bases, const int* lengths, void* out, int B, int H,
                       int page, int max_tokens, long long pool_rows,
                       cudaStream_t stream) {
    switch (D) {
        case 64:
            return launch<T, 64>(q, kp, vp, bases, lengths, out, B, H, page, max_tokens,
                                 pool_rows, stream);
        case 96:
            return launch<T, 96>(q, kp, vp, bases, lengths, out, B, H, page, max_tokens,
                                 pool_rows, stream);
        case 128:
            return launch<T, 128>(q, kp, vp, bases, lengths, out, B, H, page, max_tokens,
                                  pool_rows, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q [B, H, D] pre-scaled; pools [P, page, H*D]; bases/lengths [B] int32;
// out [B, H, D]. dtype: 0 = float32, 1 = bfloat16.
int decode_attention(const void* q, const void* k_pool, const void* v_pool,
                     const void* bases, const void* lengths, void* out, int B, int H,
                     int D, int page, int max_pages, int num_pages, int dtype,
                     void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    const int* bs = static_cast<const int*>(bases);
    const int* ls = static_cast<const int*>(lengths);
    const int max_tokens = max_pages * page;
    const long long pool_rows = (long long)num_pages * page;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0)
        err = dispatch_d<float>(D, q, k_pool, v_pool, bs, ls, out, B, H, page, max_tokens,
                                pool_rows, st);
    else if (dtype == 1)
        err = dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, bs, ls, out, B, H, page,
                                        max_tokens, pool_rows, st);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
