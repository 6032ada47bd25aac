// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: unilm_tpu/ops/flash_attention.py `_flash_kernel` (:99), reached
// through `_flash_forward` (:268) from `flash_attention` (:1979). Same
// contract: q pre-scaled, fp32 scores and online softmax, causal with a
// query offset, sliding window, valid-kv prefix (`limit`), per-key padding
// mask, additive bias broadcast over [B|1, H|1, T, S]; tiles that lie wholly
// above the causal diagonal, below the window or beyond `limit` are skipped;
// fully masked rows give out = 0 and lse = 0 (NEG_INF = -1e30 plus the
// keep-guard, as the TPU kernel does). The probabilities are rounded to the
// storage type of V before the PV product, as the TPU kernel's
// `p.astype(v.dtype)` does.
//
// Layouts are the caller's: q/out [B, T, H, D], k/v [B, S, H, D]
// (row stride H*D), bias [Bb, Hb, T, S] with element strides `bias_sb`,
// `bias_sh` (0 = broadcast), mask [B, S] int32, lse [B, H, T] float32.
//
// What bounds it on the H100: this first version computes both products
// on the fp32 CUDA cores, not the tensor cores, so it is bound by issue of
// fp32 FMAs and shared-memory loads (at most ~67 TFLOP/s fp32 against 989
// TFLOP/s bf16 wgmma). The prefill it serves (T = S = 2052, D = 96, 16
// heads) is compute-bound on any unit, so tensor cores (mma.sync/wgmma)
// and TMA-fed K/V tiles are the later PRs' work.
// What the design does about it: see csrc/flash_fwd.cuh, which holds the
// body (one 64-row q tile) that kernel #2's fp32 path shares.
// Grid: one block per (64-row q tile, head, batch), 4 warps.

#include "flash_fwd.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(fwd::NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ bias,
                 const int* __restrict__ mask, T* __restrict__ out,
                 float* __restrict__ lse, int T_, int S, int H, int bias_sb,
                 int bias_sh, int q_offset, int limit, int causal, int window) {
    fwd::tile<T, D>(q, k, v, bias, mask, out, lse, blockIdx.z, blockIdx.y,
                    blockIdx.x * fwd::BQ, T_, S, H, bias_sb, bias_sh, q_offset, limit,
                    causal, window);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const int* mask, void* out, float* lse, int B, int T_, int S,
                   int H, int bias_sb, int bias_sh, int q_offset, int limit,
                   int causal, int window, cudaStream_t stream) {
    const size_t smem = fwd::smem_bytes<D>();
    auto kern = flash_fwd_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + fwd::BQ - 1) / fwd::BQ, H, B);
    kern<<<grid, fwd::NWARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(bias), mask, static_cast<T*>(out), lse, T_, S, H, bias_sb,
        bias_sh, q_offset, limit, causal, window);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* bias, const int* mask, void* out, float* lse, int B,
                       int T_, int S, int H, int bias_sb, int bias_sh, int q_offset,
                       int limit, int causal, int window, cudaStream_t stream) {
    switch (D) {
        case 64:
            return launch<T, 64>(q, k, v, bias, mask, out, lse, B, T_, S, H, bias_sb,
                                 bias_sh, q_offset, limit, causal, window, stream);
        case 96:
            return launch<T, 96>(q, k, v, bias, mask, out, lse, B, T_, S, H, bias_sb,
                                 bias_sh, q_offset, limit, causal, window, stream);
        case 128:
            return launch<T, 128>(q, k, v, bias, mask, out, lse, B, T_, S, H, bias_sb,
                                  bias_sh, q_offset, limit, causal, window, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
              const void* mask, void* out, void* lse, int B, int T_, int S, int H,
              int D, int bias_sb, int bias_sh, int q_offset, int limit, int causal,
              int window, int dtype, void* stream) {
    if (B <= 0 || T_ <= 0 || H <= 0) return (int)cudaSuccess;
    const int* m = static_cast<const int*>(mask);
    float* l = static_cast<float*>(lse);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dtype == 0)
        err = dispatch_d<float>(D, q, k, v, bias, m, out, l, B, T_, S, H, bias_sb, bias_sh,
                                q_offset, limit, causal, window, st);
    else if (dtype == 1)
        err = dispatch_d<__nv_bfloat16>(D, q, k, v, bias, m, out, l, B, T_, S, H, bias_sb,
                                        bias_sh, q_offset, limit, causal, window, st);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
