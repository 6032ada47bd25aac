// The split walk's device code shared by #13's launch over contiguous runs
// (csrc/decode_attention.cu `decode_run_split_sm90`) and #11's over block
// tables (csrc/paged_attention.cu `paged_split_sm90`), Hopper (sm_90a).
//
// A block of one producer warp and NCW consumer warps walks 32-token tiles
// (TT) of one head of one sequence. The producer TMA-loads each tile's K
// and V rows into a ring of stages (full / empty mbarriers); consumer warp
// w, token group w, takes every ngrp-th tile (`group_walk`): on the CUDA
// cores, the scores with a lane per 4-byte word of the head's row (q in
// registers, K from shared memory, conflict-free), a 31-shuffle butterfly
// that leaves token t's score in lane t, the tile's online softmax there,
// then P V with the lanes on the words again. `merge_groups` merges the
// groups' (m, l, acc) in group order. The modes are decode_common.cuh's;
// the rounding of p for the P V sum follows each mode's contract.

#pragma once

#include "decode_common.cuh"
#include "hopper.cuh"

namespace {
namespace split {

constexpr int NCW = 15;                  // consumer warps (512 threads: 128 registers each)
constexpr int THREADS = 32 * (NCW + 1);  // and one producer warp
constexpr int TT = 32;                   // tokens per tile: one per lane

// Shared memory: full[nst], empty[nst] barriers, the ring of nst stages
// {K [TT][D], V [TT][D]} of PT, the warps' (m, l) and acc [NCW][D], the
// block's partial m, l and acc [D] (merged by the launch's own means), and
// a float of the launch's own.
template <typename PT, int D> struct Geo {
    static constexpr int ROW = D * (int)sizeof(PT);  // bytes of a staged row
    static constexpr int STAGE = 2 * TT * ROW;
    static __host__ __device__ int off_ring(int nst) { return (2 * nst * 8 + 127) / 128 * 128; }
    static __host__ __device__ int off_w(int nst) { return off_ring(nst) + nst * STAGE; }
    static __host__ __device__ int smem(int nst) {
        return off_w(nst) + (2 * NCW + NCW * D + 3 + D) * 4;
    }
};

// A lane reads 4-byte words of a row: E elements each (2 bf16, 4 int8),
// word w = lane + 32 ch of the head's D / E, for ch < NCH.
template <typename PT, int D> struct Lanes {
    static constexpr int E = 4 / sizeof(PT);
    static constexpr int DW = D / E;
    static constexpr int NCH = (DW + 31) / 32;
};

__device__ __forceinline__ void unpack(uint32_t u, const __nv_bfloat16*, float* f) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    f[0] = x.x;
    f[1] = x.y;
}
// four int8 as floats without the quarter-rate conversion: each biased
// byte x + 128 goes into the mantissa of 2^23 (one byte permute), and one
// subtraction gives x exactly
__device__ __forceinline__ void unpack(uint32_t u, const int8_t*, float* f) {
    const uint32_t x = u ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
        f[e] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + e)) - 8388736.f;
}

// The butterfly over a tile's partial sums: at width O a lane keeps the
// half of the tokens that bit O of its index selects and adds its
// partner's partials of them; after O = 1, lane t holds token t's sum in
// part[0]. 31 shuffles over the TT tokens (the first width is taken as the
// partials are formed), every index known at compile time.
template <int O> __device__ __forceinline__ void fold(float* part, int lane) {
    const bool up = lane & O;
#pragma unroll
    for (int j = 0; j < O; ++j) {
        const float send = up ? part[j] : part[j + O];
        const float keep = up ? part[j + O] : part[j];
        part[j] = keep + __shfl_xor_sync(FULL, send, O);
    }
    if constexpr (O > 1) fold<O / 2>(part, lane);
}

// Token group w's walk on the CUDA cores over tiles w, w + ngrp, .. of the
// range [t0, t1) (tile i is tokens t0 + TT i ..), reading stage i % nst of
// `ring` once full[s] completes and releasing it on empty[s]; qh is the
// head's pre-scaled q row. Ends with the group's (m, l, acc) in wm[w],
// wl[w], wacc[w * D ..]. RUN: token L's p enters P V unrounded (the
// wrapper's new row), the others' rounded to PT; RUN_I8 (fp32 q): scores
// times the token's K scale and p times its V scale rounded to T, the
// scales from the slab sidecar at pool row row0 + token; TABLE_RO: every
// p rounded to PT.
template <typename T, typename PT, int D, int MODE>
__device__ __forceinline__ void group_walk(const DecodeArgs& a, const T* qh, const uint8_t* ring,
                                           uint64_t* full, uint64_t* empty, int nst, int ngrp,
                                           int w, int lane, int t0, int t1, int L, long long row0,
                                           float* wm, float* wl, float* wacc) {
    using G = Geo<PT, D>;
    using LN = Lanes<PT, D>;
    constexpr int E = LN::E, NCH = LN::NCH;
    const int ntile = (t1 - t0 + TT - 1) / TT;
    const int page = a.page;
    // this lane's elements of q: word w = lane + 32 ch, E each
    float qv[NCH * E], acc[NCH * E];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int d = (lane + 32 * ch) * E + e;
            qv[ch * E + e] = d < D ? to_f(qh[d]) : 0.f;
            acc[ch * E + e] = 0.f;
        }
    float m = NEG_INF, lpart = 0.f;
    const int S = a.chunk * page;   // RUN_I8: slab length in tokens
    const int rw = G::ROW / 4;      // words per staged row
    const PT* tag = nullptr;        // picks unpack's overload
    for (int i = w; i < ntile; i += ngrp) {
        const int s = i % nst;
        sm90::mbar_wait(&full[s], (i / nst) & 1);
        const uint32_t* Ks = reinterpret_cast<const uint32_t*>(ring + (size_t)s * G::STAGE) + lane;
        const uint32_t* Vs = Ks + TT * rw;
        const int tok0 = t0 + i * TT, rows = min(TT, t1 - tok0);
        const int tok = tok0 + lane;
        const bool valid = lane < rows;
        float ksc = 1.f, vsc = 1.f;
        if constexpr (MODE == RUN_I8) {
            // lane t's token scales, loaded before the scores are formed
            if (valid) {  // 32-bit: a pool's rows stay below 2^31
                const int row = (int)row0 + tok, pid = row / page;
                const int slab = pid / a.chunk;
                const size_t si = (size_t)slab * 8 * S + (pid - slab * a.chunk) * page +
                                  (row - pid * page);
                ksc = a.scales[si];
                vsc = a.scales[si + S];
            }
        }

        // this lane's words of token t's score, for tokens t and
        // t + 16 at once, folded at width 16 as they are formed (half
        // the partials live), then the other four widths
        auto partial = [&](int t) {
            float x = 0.f;
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
                if (lane + 32 * ch < LN::DW) {
                    float f[E];
                    unpack(Ks[t * rw + 32 * ch], tag, f);
#pragma unroll
                    for (int e = 0; e < E; ++e) x += qv[ch * E + e] * f[e];
                }
            }
            return x;
        };
        float part[TT / 2];
        const bool up16 = lane & 16;
#pragma unroll
        for (int j = 0; j < TT / 2; ++j) {
            const float lo = partial(j), hi = partial(j + TT / 2);
            part[j] = (up16 ? hi : lo) + __shfl_xor_sync(FULL, up16 ? lo : hi, 16);
        }
        fold<TT / 4>(part, lane);
        float sc = part[0];
        if constexpr (MODE == RUN_I8) sc *= ksc;
        sc = valid ? sc : NEG_INF;
        float mx = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float m_new = fmaxf(m, mx);
        const float p = valid ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m - m_new);
        lpart = lpart * alpha + p;
        m = m_new;
        float pr;
        if constexpr (MODE == RUN)
            pr = tok == L ? p : round_to<PT>(p);
        else if constexpr (MODE == RUN_I8)
            pr = round_to<T>(p * vsc);
        else
            pr = round_to<PT>(p);
        // P V: two partial sums (even and odd tokens) for the FMA
        // chains; a whole tile fully unrolled, so that its loads go out
        // ahead of the sums
        float acc2[NCH * E];
#pragma unroll
        for (int c = 0; c < NCH * E; ++c) {
            acc[c] *= alpha;
            acc2[c] = 0.f;
        }
        auto pv = [&](int u, float* dst) {
            const float pu = __shfl_sync(FULL, pr, u);
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
                if (lane + 32 * ch < LN::DW) {
                    float f[E];
                    unpack(Vs[u * rw + 32 * ch], tag, f);
#pragma unroll
                    for (int e = 0; e < E; ++e) dst[ch * E + e] += pu * f[e];
                }
            }
        };
        if (rows == TT) {
#pragma unroll
            for (int u = 0; u < TT; u += 2) {
                pv(u, acc);
                pv(u + 1, acc2);
            }
        } else {
            for (int u = 0; u < rows; ++u) pv(u, acc);
        }
#pragma unroll
        for (int c = 0; c < NCH * E; ++c) acc[c] += acc2[c];
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lpart += __shfl_xor_sync(FULL, lpart, o);
    if (lane == 0) {
        wm[w] = m;
        wl[w] = lpart;
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int d = (lane + 32 * ch) * E + e;
            if (d < D) wacc[w * D + d] = acc[ch * E + e];
        }
}

// The block's partial (pm, pl, pacc [D]): its ngrp token groups merged in
// group order, by `nthreads` threads from `tid`, after a barrier that
// follows every group's walk
template <int D>
__device__ __forceinline__ void merge_groups(const float* wm, const float* wl, const float* wacc,
                                             int ngrp, int tid, int nthreads, float* pm,
                                             float* pl, float* pacc) {
    for (int d = tid; d < D; d += nthreads) {
        float M = NEG_INF;
        for (int w = 0; w < ngrp; ++w) M = fmaxf(M, wm[w]);
        float l = 0.f, o = 0.f;
        for (int w = 0; w < ngrp; ++w) {
            const float e = expf(wm[w] - M);
            l += wl[w] * e;
            o += wacc[w * D + d] * e;
        }
        pacc[d] = o;
        if (d == 0) {
            *pm = M;
            *pl = l;
        }
    }
}

// [rows, H, D] of PT as the 3-D map (D, H, rows) with box (D, 1, box_rows),
// no swizzle: a box is box_rows rows of one head, [box_rows][D] in shared
// memory; rows past the pool read as zeros
template <typename PT>
bool pool_map(sm90::EncodeTiled enc, CUtensorMap* map, const void* base, long long rows, int H,
              int D, int box_rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows};
    const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(PT), (cuuint64_t)H * D * sizeof(PT)};
    const cuuint32_t box[3] = {(cuuint32_t)D, 1, (cuuint32_t)box_rows};
    const cuuint32_t elem[3] = {1, 1, 1};
    return enc(map,
               sizeof(PT) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               3, const_cast<void*>(base), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace split
}  // namespace
