// Paged decode attention over block tables, read only, Hopper (sm_90a),
// plain C interface.
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
// that is a matrix-unit trick and is not carried over.
//
// What bounds it on the H100: bytes. It reads 2 * L * D pool elements per
// (sequence, head) and does ~4 flops per element, far below the ~295
// flop/byte ridge: 46 MB in 13.7 us at the ragged lengths 2047..0 of
// 8 x 16 heads of 96. What held the first design back (one block of 32
// warps per (sequence, head), a lane per token's whole K row) is the
// ragged lengths: the 2047-token sequence's blocks walk all of its tokens
// while the short ones' SMs idle.
//
// bf16 pools (`paged::paged_split_sm90`): #13's split walk (csrc/
// decode_split.cuh) over the block table, with splits by tokens. Every
// block reads the lengths and takes one span for the launch, so that no
// block walks more than `span` tokens and the blocks number about two an
// SM: span = max(floor, ceil(H * sum L / target) rounded up to whole
// 32-token tiles), target = 2 * SMs. Sequence b gets ceil(L_b / span)
// splits; the blocks with work are numbered sequence by sequence, split by
// split, head by head, and blocks 0, 1, .. also write the zeros of the
// empty sequences' heads; the grid is min(xs * B * H, target + B * H)
// (xs = the splits of the longest possible sequence at the floor's span),
// and the blocks past the work exit. In a block, the producer warp takes
// the table entries of its range once, at its start (32 lanes, a lane an
// entry, shuffled out as the walk needs them), and TMA-loads each
// 32-token tile's K and V rows as boxes of a 3-D map of the pool at row
// tables[b, t / page] * page + t % page: one box of 32 rows where pages
// hold a multiple of 32 tokens, two of 16 otherwise (bf16 pages are a
// multiple of 16 tokens), the second left out past the range's last token.
// The consumer warps are the split walk's token groups, every p rounded to
// bf16 for P V (mode TABLE_RO). A sequence with one split writes its
// output; with more, each split writes (m, l, acc[D]) in fp32 to a
// scratch, takes a ticket of its (sequence, head), and the last to arrive
// merges the splits in split order (the bits do not depend on the order of
// arrival) and resets the ticket to 0. Measured on an H100 (PERF.md): the
// walk without its arithmetic takes about as long as with it, so the
// stream of 192-byte rows (one head's part of each 3 KB token row) sets
// the time; boxes of two or four heads and other L2 promotions were no
// faster.
//
// fp32 pools keep decode_common.cuh's CUDA-core body, mode TABLE_RO (one
// block of 32 warps per (sequence, head)).

#include "decode_split.cuh"

namespace {
namespace paged {

using split::NCW;
using split::THREADS;
using split::TT;

// The plan (ops/paged_attention.paged_split_plan computes it): ngrp token
// groups and nst ring stages as the split walk's; xs splits a sequence at
// most (grid.x = xs * B * H); the span's floor; the target block count.
struct Plan {
    int ngrp, nst, xs, floor, target;
};

struct Work {
    float* part;   // [B * H * xs, D + 2] fp32: a split's acc, m, l
    int* tickets;  // [B * H], zero between launches
    int B;
};

__device__ __forceinline__ int clamp_len(int L, int max_tok) { return min(max(L, 0), max_tok); }

// Warp 0: this block's work from the lengths, blockIdx.x in the numbering
// above, into who[]: b, h, split, splits of b, t0, t1, n (b = -1: none),
// then zb, zh: the head whose zeros it writes besides (zb = -1: none).
__device__ __forceinline__ void find_work(const DecodeArgs& a, const Plan& pl, int B, int lane,
                                          int* who) {
    const int H = a.H, max_tok = a.max_pages * a.page, j = blockIdx.x;
    long long tot = 0;
    for (int i = lane; i < B; i += 32) tot += clamp_len(a.lengths[i], max_tok);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(FULL, tot, o);
    const long long want = ((long long)H * tot + pl.target - 1) / pl.target;
    const int span = max(pl.floor, (int)((want + TT - 1) / TT * TT));
    // the blocks with work: H for each split of each sequence (pass 0);
    // the empty sequences' heads, a block each from block 0 on (pass 1)
    int b = -1, r = 0, ns = 0, n = 0, zb = -1, zh = 0;
    for (int pass = 0; pass < 2; ++pass) {
        long long base = 0;
        for (int c0 = 0; c0 < B; c0 += 32) {
            const int i = c0 + lane;
            const int ni = i < B ? clamp_len(a.lengths[i], max_tok) : 0;
            const int nsi = (ni + span - 1) / span;
            const long long cnt = pass == 0 ? (long long)nsi * H : (i < B && ni == 0 ? H : 0);
            long long pre = cnt;  // inclusive scan over the lanes
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const long long v = __shfl_up_sync(FULL, pre, o);
                if (lane >= o) pre += v;
            }
            const long long lo = base + pre - cnt;
            const unsigned hit = __ballot_sync(FULL, j >= lo && j < lo + cnt);
            if (hit) {
                const int src = __ffs(hit) - 1;
                const int rr = (int)(j - __shfl_sync(FULL, lo, src));
                if (pass == 0) {
                    b = c0 + src;
                    r = rr;
                    ns = __shfl_sync(FULL, nsi, src);
                    n = __shfl_sync(FULL, ni, src);
                } else {
                    zb = c0 + src;
                    zh = rr;
                }
                break;
            }
            base += __shfl_sync(FULL, pre, 31);
        }
    }
    if (lane == 0) {
        who[0] = b;
        who[1] = r % H;
        who[2] = r / H;
        who[3] = ns;
        who[4] = min(n, (r / H) * span);
        who[5] = min(n, (r / H) * span + span);
        who[6] = n;
        who[7] = zb;
        who[8] = zh;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
paged_split_sm90(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const DecodeArgs a, const Plan pl, const Work wk) {
    using G = split::Geo<bf16, D>;
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ int who[9];
    const int nst = pl.nst, ngrp = pl.ngrp;
    const int tid = threadIdx.x, lane = tid & 31;
    // the role, warp-uniform through __shfl_sync
    const int warp = __shfl_sync(FULL, tid / 32, 0);
    const int H = a.H, page = a.page;
    if (warp == 0) find_work(a, pl, wk.B, lane, who);
    __syncthreads();
    const int b = who[0], h = who[1], sp = who[2], ns = who[3];
    const int t0 = who[4], t1 = who[5], n = who[6], zb = who[7];
    if (zb >= 0) {  // a head of an empty sequence: its zeros
        bf16* z = static_cast<bf16*>(a.out) + ((size_t)zb * H + who[8]) * D;
        for (int d = tid; d < D; d += THREADS) z[d] = __float2bfloat16(0.f);
    }
    if (b < 0) return;
    bf16* out = static_cast<bf16*>(a.out) + ((size_t)b * H + h) * D;

    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + nst;
    uint8_t* ring = smem + G::off_ring(nst);
    float* wm = reinterpret_cast<float*>(smem + G::off_w(nst));  // [NCW]
    float* wl = wm + NCW;                                          // [NCW]
    float* wacc = wl + NCW;                                        // [NCW][D]
    float* pm = wacc + NCW * D;  // the block's partial max
    float* pl_ = pm + 1;         // its sum
    int* last = reinterpret_cast<int*>(pl_ + 1);  // this block merges
    float* pacc = pl_ + 2;       // [D]: its PV sums
    const int ntile = (t1 - t0 + TT - 1) / TT;

    if (tid == 0) {
        for (int s = 0; s < nst; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 1);  // the warp of the stage's group
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    if (warp == 0) {
        // producer: tile i into stage i % nst once the stage's group has
        // read tile i - nst; the range's last tile may reach past its last
        // token inside the page (masked), a 16-row box wholly past it is
        // left out, and no table entry past ceil(n / page) is read
        constexpr int ROW = G::ROW;
        const int box = page % TT == 0 ? TT : TT / 2;
        const int* table = a.idx + (size_t)b * a.max_pages;
        const int e0 = t0 / page, ne = (n + page - 1) / page;
        int chunk = 0;  // the 32 entries e0 + 32 chunk + lane, one a lane
        int ent = e0 + lane < ne ? table[e0 + lane] : 0;
        if (lane == 0) {
            sm90::prefetch_tensormap(&tk);
            sm90::prefetch_tensormap(&tv);
        }
        for (int i = 0; i < ntile; ++i) {
            const int s = i % nst, tok = t0 + i * TT;
            const int nbox = box == TT ? 1 : (tok + box < t1 ? 2 : 1);
            if (i >= nst) sm90::mbar_wait(&empty[s], (i / nst - 1) & 1);
            if (lane == 0) sm90::mbar_arrive_expect_tx(&full[s], 2 * nbox * box * ROW);
            uint8_t* st = ring + (size_t)s * G::STAGE;
            for (int x = 0; x < nbox; ++x) {
                const int tb = tok + x * box, e = tb / page - e0;
                if ((e >> 5) != chunk) {  // the next 32 entries
                    chunk = e >> 5;
                    const int ei = e0 + 32 * chunk + lane;
                    ent = ei < ne ? table[ei] : 0;
                }
                const int pid = __shfl_sync(FULL, ent, e & 31);
                if (lane == 0) {
                    const int row = pid * page + tb % page;
                    sm90::tma_load_3d(st + x * box * ROW, &tk, &full[s], 0, h, row);
                    sm90::tma_load_3d(st + (TT + x * box) * ROW, &tv, &full[s], 0, h, row);
                }
            }
        }
    } else if (warp - 1 < ngrp) {
        const bf16* q = static_cast<const bf16*>(a.q) + ((size_t)b * H + h) * D;
        split::group_walk<bf16, bf16, D, TABLE_RO>(a, q, ring, full, empty, nst, ngrp, warp - 1,
                                                    lane, t0, t1, n, 0, wm, wl, wacc);
    }
    __syncthreads();
    split::merge_groups<D>(wm, wl, wacc, ngrp, tid, THREADS, pm, pl_, pacc);
    __syncthreads();

    if (ns == 1) {
        const float l = *pl_;
        for (int d = tid; d < D; d += THREADS)
            out[d] = __float2bfloat16(pacc[d] / (l > 0.f ? l : 1.f));
        return;
    }
    // more splits: this one's partial to the scratch, then a ticket; the
    // last split to arrive merges them all in split order
    const size_t head = (size_t)b * H + h;
    float* mine = wk.part + (head * pl.xs + sp) * (D + 2);
    for (int d = tid; d < D; d += THREADS) mine[d] = pacc[d];
    if (tid == 0) {
        mine[D] = *pm;
        mine[D + 1] = *pl_;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(wk.tickets + head, 1) == ns - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    const float* all = wk.part + head * pl.xs * (D + 2);
    for (int d = tid; d < D; d += THREADS) {
        float M = NEG_INF;
#pragma unroll 8
        for (int r = 0; r < ns; ++r) M = fmaxf(M, __ldcg(all + r * (D + 2) + D));
        float l = 0.f, o = 0.f;
#pragma unroll 8
        for (int r = 0; r < ns; ++r) {
            const float* pr = all + r * (D + 2);
            const float e = expf(__ldcg(pr + D) - M);
            l += __ldcg(pr + D + 1) * e;
            o += __ldcg(pr + d) * e;
        }
        out[d] = __float2bfloat16(o / (l > 0.f ? l : 1.f));
    }
    if (tid == 0) wk.tickets[head] = 0;
}

template <int D>
cudaError_t launch_d(const DecodeArgs& a, const Plan& pl, const Work& wk, cudaStream_t stream) {
    using G = split::Geo<bf16, D>;
    sm90::EncodeTiled enc = sm90::encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    const int box = a.page % TT == 0 ? TT : TT / 2;
    CUtensorMap tk, tv;
    if (!split::pool_map<bf16>(enc, &tk, a.kp, a.pool_rows, a.H, D, box) ||
        !split::pool_map<bf16>(enc, &tv, a.vp, a.pool_rows, a.H, D, box))
        return cudaErrorInvalidValue;
    const int smem = G::smem(pl.nst);
    auto kern = paged_split_sm90<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // blocks: at most target + B * H have work (each sequence's last split
    // and each empty sequence's zeros add at most one a head), and never
    // more than xs splits a sequence
    const long long grid = min((long long)pl.xs * wk.B * a.H, (long long)pl.target + wk.B * a.H);
    kern<<<dim3((unsigned)grid), THREADS, smem, stream>>>(tk, tv, a, pl, wk);
    return cudaGetLastError();
}

cudaError_t launch(const DecodeArgs& a, const Plan& pl, const Work& wk, int D,
                   cudaStream_t stream) {
    if (a.page % (TT / 2) || pl.ngrp <= 0 || pl.ngrp > NCW || pl.nst <= 0 || pl.nst % pl.ngrp ||
        pl.xs <= 0 || pl.floor < TT || pl.floor % TT || pl.target <= 0 ||
        (long long)pl.xs * wk.B * a.H > 0x7fffffffLL ||
        (long long)pl.xs * pl.floor < (long long)a.max_pages * a.page)
        return cudaErrorInvalidValue;
    switch (D) {
        case 32: return launch_d<32>(a, pl, wk, stream);
        case 64: return launch_d<64>(a, pl, wk, stream);
        case 96: return launch_d<96>(a, pl, wk, stream);
        case 128: return launch_d<128>(a, pl, wk, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace paged
}  // namespace

extern "C" {

// q [B, H, D] pre-scaled; pools [P, page, H*D] of q's type (read only);
// tables [B, max_pages] int32; lengths [B] int32; out [B, H, D].
// dtype: 0 = float32, 1 = bfloat16. bf16 takes the split walk with the
// plan (ngrp, nst, xs, floor, target) of
// ops/paged_attention.paged_split_plan, the scratch `part` [B * H * xs,
// D + 2] fp32 and the tickets [B * H] int32 (zero, and left zero); page a
// multiple of 16. fp32 ignores them.
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* lengths, void* out, void* part,
                    void* tickets, int B, int H, int D, int page, int max_pages,
                    int num_pages, int dtype, int ngrp, int nst, int xs, int floor,
                    int target, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (max_pages <= 0 || page <= 0) return (int)cudaErrorInvalidValue;
    DecodeArgs a{q, const_cast<void*>(k_pool), const_cast<void*>(v_pool),
                 static_cast<const int*>(tables), static_cast<const int*>(lengths),
                 nullptr, nullptr, nullptr, out, H, page, 1, max_pages,
                 (long long)num_pages * page};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_decode<float, float, TABLE_RO>(a, B, D, st);
    if (dtype == 1)
        return (int)paged::launch(a, paged::Plan{ngrp, nst, xs, floor, target},
                                  paged::Work{static_cast<float*>(part),
                                              static_cast<int*>(tickets), B},
                                  D, st);
    return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
