"""Decode attention over the flat KV page pool (port of
unilm_tpu/ops/paged_attention.py: `paged_decode_attention` :149 /
`_paged_kernel` :44, `paged_decode_append_attention` :387 /
`_paged_append_batched_kernel` :213, `quantize_kv_rows` :634,
`run_decode_append_attention` :647 / `_run_decode_kernel` :497).

Pools are FLAT [P, page, H*D], the JAX layout, and are updated IN PLACE
(the JAX functions return new pools; here the returned pools are the
tensors that were passed in).

- `run_decode_append_attention`: contiguous runs; `bases[b]` is the
  chunk-aligned first page of sequence b's run and `lengths[b]` the tokens
  already in it; the step's K/V row is appended at token `lengths[b]` and
  attention runs over the `lengths[b] + 1` tokens. With `scale_pool` the
  pools hold int8 rows quantized per token (`quantize_kv_rows`) and the
  sidecar [P/chunk, 8, chunk*page] f32 holds K scales in row 0 and V
  scales in row 1 of each slab. The row (and its scales) is written with
  index_put before the kernel in csrc/decode_attention.cu reads the pool.
- `paged_decode_append_attention`: block tables; the kernel in
  csrc/paged_append_attention.cu writes the row itself and attends.
- `paged_decode_attention`: block tables, read only (csrc/paged_attention.cu):
  attention over the lengths[b] tokens already in the pages, as
  runtime/paged_kv.paged_attention calls it. Pools may be flat or
  [P, page, H, D].

CPU tensors take the `*_plain` versions; a CUDA tensor launches the kernel
or raises.

The bf16 and int8 runs launch the split walk of csrc/decode_attention.cu,
whose head groups and token splits `decode_split_plan` gives
(tests/test_torch_decode_split.py pins the plan and emulates the walk).
bf16 block tables take the same walk with splits by tokens
(csrc/paged_attention.cu; `paged_split_plan`, pinned and emulated by
tests/test_torch_paged_split_plan.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.ops._native import (
    I, P, CudaKernel, check_tensor, ptr, sm_count, stream)

SUPPORTED_D = (32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel("decode_attention.cu", {
    # q, k_pool, v_pool, bases, lengths, out, nsplit, ngrp, nst, B, H, D,
    # page, max_pages, num_pages, dtype, stream
    "decode_attention": [P] * 6 + [I] * 10 + [P],
})
# the int8-pool launcher of the same library, with its own launch count
KERNEL_INT8 = CudaKernel("decode_attention.cu", {
    # q, k_pool, v_pool, bases, lengths, scales, k_new, v_new, out, nsplit,
    # ngrp, nst, B, H, D, page, chunk, max_pages, num_pages, dtype, stream
    "decode_attention_int8": [P] * 9 + [I] * 11 + [P],
})
PAGED_KERNEL = CudaKernel("paged_attention.cu", {
    # q, k_pool, v_pool, tables, lengths, out, part, tickets, B, H, D, page,
    # max_pages, num_pages, dtype, ngrp, nst, xs, floor, target, stream
    "paged_attention": [P] * 8 + [I] * 12 + [P],
})
APPEND_KERNEL = CudaKernel("paged_append_attention.cu", {
    # q, k_pool, v_pool, tables, lengths, k_new, v_new, out, B, H, D, page,
    # max_pages, num_pages, dtype, stream
    "paged_append_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                               P],
})


# The split walk (csrc/decode_attention.cu `decode_run_split_sm90`): a block
# takes one head of one sequence and one of `nsplit` token ranges (whole
# SPLIT_TILE-token tiles); the nsplit blocks of a (sequence, head) are one
# thread block cluster, merged through shared memory. Blocks of one head:
# head groups of two and four, with wider copies, measured no faster on an
# H100 at the slice's and the serving step's shapes.
SPLIT_TILE = 32
SPLIT_WARPS = 15  # consumer warps a block (with the producer, 512 threads)
SPLIT_RING = 96 * 1024  # ring bytes


def _walk_geometry(D: int, itemsize: int) -> tuple:
    """(ngrp, nst) of the split walk: token groups of one consumer warp
    and ring stages (a multiple of ngrp) in SPLIT_RING bytes, stages of
    2 * SPLIT_TILE * D * itemsize bytes."""
    stage = 2 * SPLIT_TILE * D * itemsize
    ngrp = min(SPLIT_WARPS, max(1, SPLIT_RING // stage))
    return ngrp, ngrp * max(1, SPLIT_RING // (stage * ngrp))


def decode_split_plan(B: int, H: int, L: int, n_sm: int, D: int = 96,
                      itemsize: int = 2) -> dict:
    """The split walk's plan for B sequences of H heads of D elements of
    `itemsize` bytes (bf16 2, int8 1) and L tokens each (the kernel
    computes the ranges from the lengths on the card; L here stands for
    all of them):
    - `nsplit` blocks a (sequence, head), one thread block cluster: about
      two blocks an SM for bf16 pools, one for int8 (whose tensor-core
      consumers take up to 96 registers a thread), floor(blocks an SM *
      n_sm / (B * H)), at least 1 and at most 8, or 6 at one block an SM
      (clusters of eight one-block SMs did not all fit at once on an
      H100);
    - `ngrp` token groups of one consumer warp and `nst` ring stages (a
      multiple of ngrp) in SPLIT_RING bytes, stages of
      2 * SPLIT_TILE * D * itemsize bytes;
    - `ranges`: [t0, t1) of each split: ceil(L / nsplit) tokens rounded up
      to whole tiles, the last range short, empty (t0 == t1) past L;
    - `tiles`: for each split, its tiles as (token group, t0, t1), tile i
      to group i % ngrp."""
    per_sm, cap = (1, 6) if itemsize == 1 else (2, 8)
    nsplit = min(cap, max(1, per_sm * n_sm // (B * H)))
    ngrp, nst = _walk_geometry(D, itemsize)
    n = max(L, 0)
    span = -(-(-(-n // nsplit)) // SPLIT_TILE) * SPLIT_TILE
    ranges = [(min(n, s * span), min(n, s * span + span)) for s in range(nsplit)]
    tiles = [[(i % ngrp, t0 + i * SPLIT_TILE, min(t1, t0 + (i + 1) * SPLIT_TILE))
              for i in range(-(-(t1 - t0) // SPLIT_TILE))]
             for t0, t1 in ranges]
    return {"nsplit": nsplit, "ngrp": ngrp, "nst": nst, "ranges": ranges,
            "tiles": tiles}


# #11's walk over block tables (csrc/paged_attention.cu `paged_split_sm90`):
# the split walk's blocks, but splits by tokens. The grid holds
# ceil(max_pages * page / PAGED_SPAN_FLOOR) splits a sequence; the span
# never falls below the floor, one ring's worth of tiles at D = 96.
PAGED_SPAN_FLOOR = 256


def paged_split_plan(lengths, H: int, D: int, page: int, max_pages: int,
                     n_sm: int) -> dict:
    """The bf16 walk's plan for sequences of `lengths` tokens (the kernel
    computes it on the card from the lengths there; this is its mirror):
    - `span`: tokens a block walks at most, one for the launch:
      max(PAGED_SPAN_FLOOR, ceil(H * sum n / (2 n_sm)) rounded up to whole
      SPLIT_TILE tiles), n = the length clamped to [0, max_pages * page],
      so that the blocks number about two an SM;
    - `xs`: splits a sequence at most, ceil(max_pages * page / floor);
      `target` = 2 n_sm; `grid` = min(xs * B * H, target + B * H) blocks
      (a sequence's last split and an empty sequence's zeros add at most
      one block a head to the target);
    - `ngrp`, `nst`: the split walk's token groups and ring stages;
    - `box`: rows a TMA box, SPLIT_TILE where pages hold a multiple of it,
      else 16 (a tile is then two boxes, each inside one page);
    - `splits[b]`: [t0, t1) of each of ceil(n_b / span) splits, none for
      n_b = 0;
    - `tiles[b][s]`: split s's tiles as (token group, a, b, boxes), tile i
      to group i % ngrp, boxes = the (table entry, offset in the page) the
      producer loads; a 16-row box wholly past the split is left out;
    - `blocks`: the kernel's numbering of the blocks with work: (b, h,
      split) for every split of every sequence, sequence by sequence,
      split by split, head by head; the remaining blocks of the grid have
      none;
    - `zeros`: the heads (b, h) of the empty sequences, in order, whose
      zeros blocks 0, 1, .. write besides their work."""
    max_tok = max_pages * page
    ns_ = [min(max(int(L), 0), max_tok) for L in lengths]
    B = len(ns_)
    xs = -(-max_tok // PAGED_SPAN_FLOOR)
    target = 2 * n_sm
    want = -(-(H * sum(ns_)) // target)
    span = max(PAGED_SPAN_FLOOR, -(-want // SPLIT_TILE) * SPLIT_TILE)
    ngrp, nst = _walk_geometry(D, 2)
    box = SPLIT_TILE if page % SPLIT_TILE == 0 else SPLIT_TILE // 2
    splits, tiles, blocks = [], [], []
    for b, n in enumerate(ns_):
        sp = [(t0, min(n, t0 + span)) for t0 in range(0, n, span)]
        splits.append(sp)
        tb = []
        for t0, t1 in sp:
            tl = []
            for i, a in enumerate(range(t0, t1, SPLIT_TILE)):
                boxes = [(x // page, x % page)
                         for x in range(a, a + SPLIT_TILE, box) if x < t1]
                tl.append((i % ngrp, a, min(t1, a + SPLIT_TILE), boxes))
            tb.append(tl)
        tiles.append(tb)
        blocks += [(b, h, s) for s in range(len(sp)) for h in range(H)]
    zeros = [(b, h) for b, n in enumerate(ns_) if n == 0 for h in range(H)]
    return {"span": span, "xs": xs, "grid": min(xs * B * H, target + B * H),
            "target": target, "floor": PAGED_SPAN_FLOOR, "ngrp": ngrp,
            "nst": nst, "box": box, "splits": splits, "tiles": tiles,
            "blocks": blocks, "zeros": zeros}


_PLANS = {}
_WORKSPACE = {}


def _paged_workspace(dev, heads: int, floats: int) -> tuple:
    """(part, tickets) for #11's bf16 walk on `dev`: at least `floats`
    fp32 for the splits' partials (m, l, acc[D]) and `heads` int32
    tickets. The tickets start at zero and every launch leaves them at
    zero, so one buffer serves the launches on the device's stream in
    turn, and no launch pays for a memset."""
    part, tickets = _WORKSPACE.get(dev, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < heads:
        tickets = torch.zeros(heads, dtype=torch.int32, device=dev)
    _WORKSPACE[dev] = (part, tickets)
    return part, tickets


def _split_plan(B: int, H: int, D: int, itemsize: int, dev) -> tuple:
    """(nsplit, ngrp, nst) of the split walk on device `dev`."""
    key = (B, H, D, itemsize, dev)
    if key not in _PLANS:
        plan = decode_split_plan(B, H, 0, sm_count(dev), D, itemsize)
        _PLANS[key] = tuple(plan[k] for k in ("nsplit", "ngrp", "nst"))
    return _PLANS[key]


def quantize_kv_rows(k_rows: torch.Tensor, v_rows: torch.Tensor):
    """Per-token symmetric int8 quantization of [N, H*D] K/V rows. Returns
    (k_i8, v_i8, kscale [N], vscale [N]) with row = round(x / scale),
    scale = max(amax, 1e-6) / 127: bit-equal to the JAX function."""
    def one(x):
        xf = x.float()
        sc = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
        xi = torch.clamp(torch.round(xf / sc), -127, 127)
        return xi.to(torch.int8), sc[:, 0]
    ki, ks = one(k_rows)
    vi, vs = one(v_rows)
    return ki, vi, ks, vs


def _append_rows(k_new, v_new, k_pool, v_pool, bases, lengths,
                 scale_pool=None, chunk: int = 8):
    """Write this step's K/V row of every sequence at token lengths[b] (and,
    for an int8 pool, its quantized values and both scales)."""
    B, HD = k_new.shape[0], k_pool.shape[2]
    page = k_pool.shape[1]
    pids = (bases + torch.div(lengths, page, rounding_mode="floor")).long()
    offs = torch.remainder(lengths, page).long()
    if scale_pool is None:
        k_pool[pids, offs] = k_new.reshape(B, HD).to(k_pool.dtype)
        v_pool[pids, offs] = v_new.reshape(B, HD).to(v_pool.dtype)
        return
    ki, vi, ks, vs = quantize_kv_rows(k_new.reshape(B, HD),
                                      v_new.reshape(B, HD))
    k_pool[pids, offs] = ki
    v_pool[pids, offs] = vi
    slab = torch.div(pids, chunk, rounding_mode="floor")
    pos = torch.remainder(pids, chunk) * page + offs
    scale_pool[slab, 0, pos] = ks
    scale_pool[slab, 1, pos] = vs


def run_decode_append_attention_plain(q, k_new, v_new, k_pool, v_pool, bases,
                                      lengths, max_pages: Optional[int] = None,
                                      scale: Optional[float] = None,
                                      chunk: int = 8, scale_pool=None):
    """Plain torch version of the kernel path; same arguments and results.
    Float32 scores. bf16/fp32 pools: pool tokens' probabilities are rounded
    to the pool dtype before the PV sum, the new token's are not (the TPU
    kernel's analytic merge). int8 pools: scores times the K scales,
    probabilities times the V scales rounded to q's dtype; the new token is
    merged from the unquantized k_new / v_new."""
    B, _, H, D = q.shape
    Pn, page, HD = k_pool.shape
    if scale is None:
        scale = D ** -0.5
    if max_pages is None:
        max_pages = Pn - 1
    quantized = scale_pool is not None
    _append_rows(k_new, v_new, k_pool, v_pool, bases, lengths, scale_pool,
                 chunk)
    qs = (q[:, 0] * scale).float()  # [B, H, D], scaled in q's dtype first
    kf = k_pool.reshape(Pn * page, H, D)
    vf = v_pool.reshape(Pn * page, H, D)
    if quantized:
        nslab = scale_pool.shape[0]
        ksc = scale_pool[:, 0].reshape(nslab * chunk * page)
        vsc = scale_pool[:, 1].reshape(nslab * chunk * page)
    p_dtype = q.dtype if quantized else k_pool.dtype
    outs = []
    for b, (base, L) in enumerate(zip(bases.tolist(), lengths.tolist())):
        n = min(L, max_pages * page)
        r0 = base * page
        ks, vs = kf[r0:r0 + n].float(), vf[r0:r0 + n].float()  # [n, H, D]
        if quantized:
            kn, vn = k_new[b, 0].float(), v_new[b, 0].float()  # [H, D]
        else:
            kn = k_new[b, 0].to(k_pool.dtype).float()
            vn = v_new[b, 0].to(v_pool.dtype).float()
        s = torch.einsum("hd,thd->ht", qs[b], ks)
        if quantized:
            s = s * ksc[r0:r0 + n]
        s_new = (qs[b] * kn).sum(-1, keepdim=True)  # [H, 1]
        m = torch.maximum(s.amax(-1, keepdim=True) if n else s_new, s_new)
        e = torch.exp(s - m)
        p_new = torch.exp(s_new - m)
        l = e.sum(-1, keepdim=True) + p_new
        if quantized:
            e = e * vsc[r0:r0 + n]
        p = e.to(p_dtype).float()
        acc = torch.einsum("ht,thd->hd", p, vs) + p_new * vn
        outs.append(acc / l)
    out = torch.stack(outs).to(q.dtype)[:, None]
    if quantized:
        return out, k_pool, v_pool, scale_pool
    return out, k_pool, v_pool


def _check_decode_args(qs, k_pool, v_pool, pool_dtype):
    B, H, D = qs.shape
    Pn, page, HD = k_pool.shape
    if HD != H * D:
        raise ValueError(f"q {tuple(qs.shape)} does not match pool "
                         f"{tuple(k_pool.shape)}")
    if qs.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"decode kernels take float32/bfloat16 q with "
                         f"head_dim in {SUPPORTED_D}, got {qs.dtype}, D={D}")
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"decode kernels: CUDA tensors only, got {dev}")
    check_tensor("q", qs, dtype=qs.dtype, shape=(B, H, D), device=dev)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_tensor(name, pool, dtype=pool_dtype, shape=(Pn, page, HD),
                     device=dev)
    return B, H, D, Pn, page, dev


def decode_attention(qs: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, bases: torch.Tensor,
                     lengths: torch.Tensor, max_pages: int) -> torch.Tensor:
    """Launch the bf16/fp32 run kernel alone: attention of pre-scaled qs
    [B, H, D] over tokens 0..lengths[b] of each run, whose last row the
    caller has already written. Returns out [B, H, D]."""
    B, H, D, Pn, page, dev = _check_decode_args(qs, k_pool, v_pool, qs.dtype)
    check_tensor("bases", bases, dtype=torch.int32, shape=(B,), device=dev)
    check_tensor("lengths", lengths, dtype=torch.int32, shape=(B,),
                 device=dev)
    out = torch.empty((B, H, D), dtype=qs.dtype, device=dev)
    plan = (_split_plan(B, H, D, 2, dev) if qs.dtype == torch.bfloat16
            else (0, 0, 0))  # fp32: the CUDA-core body
    KERNEL.launch("decode_attention", ptr(qs), ptr(k_pool), ptr(v_pool),
                  ptr(bases), ptr(lengths), ptr(out), *plan, B, H, D, page,
                  int(max_pages), Pn, _DTYPE_CODE[qs.dtype], stream(),
                  head_dim=D)
    return out


def decode_attention_int8(qs: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, bases: torch.Tensor,
                          lengths: torch.Tensor, scale_pool: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          max_pages: int, chunk: int) -> torch.Tensor:
    """Launch the int8 run kernel alone: pre-scaled qs [B, H, D] over the
    int8 tokens 0..lengths[b]-1 of each run, plus the unquantized new token
    k_new / v_new [B, H, D] merged analytically. Returns out [B, H, D]."""
    B, H, D, Pn, page, dev = _check_decode_args(qs, k_pool, v_pool,
                                                torch.int8)
    if Pn % chunk:
        raise ValueError(f"int8 pool of {Pn} pages is not a multiple of "
                         f"chunk {chunk}")
    check_tensor("bases", bases, dtype=torch.int32, shape=(B,), device=dev)
    check_tensor("lengths", lengths, dtype=torch.int32, shape=(B,),
                 device=dev)
    check_tensor("scale_pool", scale_pool, dtype=torch.float32,
                 shape=(Pn // chunk, 8, chunk * page), device=dev)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        check_tensor(name, t, dtype=qs.dtype, shape=(B, H, D), device=dev)
    out = torch.empty((B, H, D), dtype=qs.dtype, device=dev)
    KERNEL_INT8.launch("decode_attention_int8", ptr(qs), ptr(k_pool),
                       ptr(v_pool), ptr(bases), ptr(lengths), ptr(scale_pool),
                       ptr(k_new), ptr(v_new), ptr(out),
                       *_split_plan(B, H, D, 1, dev), B, H, D, page,
                       int(chunk), int(max_pages), Pn, _DTYPE_CODE[qs.dtype],
                       stream(), head_dim=D)
    return out


def run_decode_append_attention(
    q: torch.Tensor,  # [B, 1, H, D] (unscaled)
    k_new: torch.Tensor,  # [B, 1, H, D]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,  # [P, page, H*D], updated in place
    v_pool: torch.Tensor,
    bases: torch.Tensor,  # [B] int32, chunk-aligned first page of each run
    lengths: torch.Tensor,  # [B] int32 tokens already in the run
    max_pages: Optional[int] = None,  # per-sequence page budget
    scale: Optional[float] = None,
    chunk: int = 8,
    scale_pool: Optional[torch.Tensor] = None,  # int8 KV: [P/chunk, 8, S]
):
    """Append the step's K/V rows and attend over lengths + 1 tokens.
    Returns (out [B, 1, H, D], k_pool, v_pool), plus scale_pool when
    quantized; the pools are the input tensors, updated in place. Callers
    keep bases chunk-aligned and lengths + 1 <= max_pages * page; the
    kernel clamps its reads to that budget and to the pool."""
    if q.device.type == "cpu":
        return run_decode_append_attention_plain(
            q, k_new, v_new, k_pool, v_pool, bases, lengths, max_pages, scale,
            chunk, scale_pool)
    if q.device.type != "cuda":
        raise ValueError(f"run_decode_append_attention: device {q.device}")
    B, _, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if max_pages is None:
        max_pages = k_pool.shape[0] - 1
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != tuple(q.shape) or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does "
                             f"not match q {tuple(q.shape)} on {q.device}")
    _append_rows(k_new, v_new, k_pool, v_pool, bases, lengths, scale_pool,
                 chunk)
    qs = (q[:, 0] * scale).contiguous()  # [B, H, D], scaled in q's dtype
    if scale_pool is None:
        out = decode_attention(qs, k_pool, v_pool, bases, lengths, max_pages)
        return out[:, None], k_pool, v_pool
    out = decode_attention_int8(
        qs, k_pool, v_pool, bases, lengths, scale_pool,
        k_new[:, 0].to(q.dtype).contiguous(),
        v_new[:, 0].to(q.dtype).contiguous(), max_pages, chunk)
    return out[:, None], k_pool, v_pool, scale_pool


def paged_decode_append_attention_plain(q, k_new, v_new, k_pool, v_pool,
                                        block_tables, lengths,
                                        scale: Optional[float] = None):
    """Plain torch version of the block-table kernel path. Writes the row
    (cast to the pool dtype) at token lengths[b] of each table, then
    attends over tokens 0..lengths[b] in float32; every probability, the
    new token's too, is rounded to the pool dtype before the PV sum."""
    B, _, H, D = q.shape
    Pn, page, HD = k_pool.shape
    MP = block_tables.shape[1]
    if scale is None:
        scale = D ** -0.5
    tables = block_tables.long()
    lens = lengths.long()
    last = torch.clamp(torch.div(lens, page, rounding_mode="floor"), max=MP - 1)
    pids = torch.gather(tables, 1, last[:, None])[:, 0]
    offs = torch.remainder(lens, page)
    k_pool[pids, offs] = k_new.reshape(B, HD).to(k_pool.dtype)
    v_pool[pids, offs] = v_new.reshape(B, HD).to(v_pool.dtype)
    qs = (q[:, 0] * scale).float()  # [B, H, D]
    kk = k_pool[tables].reshape(B, MP * page, H, D).float()
    vv = v_pool[tables].reshape(B, MP * page, H, D).float()
    s = torch.einsum("bhd,bshd->bhs", qs, kk)
    valid = torch.arange(MP * page, device=q.device)[None] <= lens[:, None]
    s = s.masked_fill(~valid[:, None], -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    p = e.to(k_pool.dtype).float()
    out = torch.einsum("bhs,bshd->bhd", p, vv) / l
    return out.to(q.dtype)[:, None], k_pool, v_pool


def paged_decode_append_attention(
    q: torch.Tensor,  # [B, 1, H, D] (unscaled)
    k_new: torch.Tensor,  # [B, 1, H, D]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,  # [P, page, H*D] FLAT, updated in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] tokens present (new row appended at L)
    scale: Optional[float] = None,
):
    """Fused serving decode step over block tables: append this token's K/V
    into its page and attend over lengths + 1 tokens. Returns (out
    [B, 1, H, D], k_pool, v_pool), the pools updated in place."""
    if q.device.type == "cpu":
        return paged_decode_append_attention_plain(
            q, k_new, v_new, k_pool, v_pool, block_tables, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_append_attention: device {q.device}")
    B, _, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    qs = (q[:, 0] * scale).contiguous()
    B, H, D, Pn, page, dev = _check_decode_args(qs, k_pool, v_pool, qs.dtype)
    MP = block_tables.shape[1]
    check_tensor("block_tables", block_tables, dtype=torch.int32,
                 shape=(B, MP), device=dev)
    check_tensor("lengths", lengths, dtype=torch.int32, shape=(B,),
                 device=dev)
    kn = k_new[:, 0].to(qs.dtype).contiguous()
    vn = v_new[:, 0].to(qs.dtype).contiguous()
    for name, t in (("k_new", kn), ("v_new", vn)):
        check_tensor(name, t, dtype=qs.dtype, shape=(B, H, D), device=dev)
    out = torch.empty((B, H, D), dtype=qs.dtype, device=dev)
    APPEND_KERNEL.launch("paged_append_attention", ptr(qs), ptr(k_pool),
                         ptr(v_pool), ptr(block_tables), ptr(lengths),
                         ptr(kn), ptr(vn), ptr(out), B, H, D, page, MP, Pn,
                         _DTYPE_CODE[qs.dtype], stream(), head_dim=D)
    return out[:, None], k_pool, v_pool


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                 scale: Optional[float] = None):
    """Plain torch version of the read-only block-table kernel; same
    arguments and result. q is scaled in its own dtype; float32 scores
    over tokens t < lengths[b]; the sum l takes the unrounded
    probabilities, the PV product takes them rounded to the pool dtype;
    out = acc / (l if l > 0 else 1), so a length-0 sequence gives 0.
    Table entries past ceil(L / page) are not read (taken as page 0)."""
    B, _, H, D = q.shape
    Pn, page = k_pool.shape[0], k_pool.shape[1]
    k_pool = k_pool.reshape(Pn, page, H * D)
    v_pool = v_pool.reshape(Pn, page, H * D)
    MP = block_tables.shape[1]
    if scale is None:
        scale = D ** -0.5
    lens = lengths.to(q.device).long()
    npages = torch.div(lens + page - 1, page, rounding_mode="floor")
    tables = block_tables.to(q.device).long()
    tables = torch.where(torch.arange(MP, device=q.device)[None]
                         < npages[:, None], tables, 0)
    qs = (q[:, 0] * scale).float()  # [B, H, D], scaled in q's dtype first
    kk = k_pool[tables].reshape(B, MP * page, H, D).float()
    vv = v_pool[tables].reshape(B, MP * page, H, D).float()
    valid = (torch.arange(MP * page, device=q.device)[None]
             < lens[:, None])[:, None]  # [B, 1, S]
    s = torch.einsum("bhd,bshd->bhs", qs, kk).masked_fill(~valid, -1e30)
    e = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = e.sum(-1, keepdim=True)
    p = e.to(k_pool.dtype).float()
    out = torch.einsum("bhs,bshd->bhd", p, vv) / torch.where(l > 0, l, 1.0)
    return out.to(q.dtype)[:, None]


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D] (unscaled)
    k_pool: torch.Tensor,  # [P, page, H*D] flat or [P, page, H, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    lengths: torch.Tensor,  # [B] int tokens present
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode attention over the lengths[b] tokens of each
    sequence's block table; reads the pools, writes nothing. Returns
    [B, 1, H, D] in q's dtype. On CUDA, q and the pools share one dtype
    (float32 or bfloat16), D is in SUPPORTED_D and bf16 pages hold a
    multiple of 16 tokens; tables and lengths are cast to int32 on q's
    device, and every entry a sequence's length reaches names a page of
    the pool."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: device {q.device}")
    B, _, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    Pn, page = k_pool.shape[0], k_pool.shape[1]
    if tuple(k_pool.shape[2:]) not in ((H * D,), (H, D)):
        raise ValueError(f"paged_decode_attention: pool {tuple(k_pool.shape)} "
                         f"does not match q {tuple(q.shape)}")
    kp = k_pool.reshape(Pn, page, H * D)
    vp = v_pool.reshape(Pn, page, H * D)
    qs = (q[:, 0] * scale).contiguous()
    B, H, D, Pn, page, dev = _check_decode_args(qs, kp, vp, qs.dtype)
    if qs.dtype == torch.bfloat16 and page % 16:
        raise ValueError(f"paged_decode_attention: bf16 pools take pages of a "
                         f"multiple of 16 tokens (the JAX kernel's "
                         f"kernel_supported), got {page}")
    MP = block_tables.shape[1]
    tables = block_tables.to(dev, torch.int32).contiguous()
    lens = lengths.to(dev, torch.int32).contiguous()
    check_tensor("block_tables", tables, dtype=torch.int32, shape=(B, MP),
                 device=dev)
    check_tensor("lengths", lens, dtype=torch.int32, shape=(B,), device=dev)
    out = torch.empty((B, H, D), dtype=qs.dtype, device=dev)
    part = tickets = None
    plan = (0, 0, 0, 0, 0)  # fp32: the CUDA-core body takes none
    if qs.dtype == torch.bfloat16:
        xs = -(-MP * page // PAGED_SPAN_FLOOR)
        part, tickets = _paged_workspace(dev, B * H, B * H * xs * (D + 2))
        plan = (*_walk_geometry(D, 2), xs, PAGED_SPAN_FLOOR, 2 * sm_count(dev))
    PAGED_KERNEL.launch("paged_attention", ptr(qs), ptr(kp), ptr(vp),
                        ptr(tables), ptr(lens), ptr(out), ptr(part),
                        ptr(tickets), B, H, D, page, MP, Pn,
                        _DTYPE_CODE[qs.dtype], *plan, stream(), head_dim=D)
    return out[:, None]
