"""Serving decode attention over the flat KV page pool (port of
unilm_tpu/ops/paged_attention.py: `paged_decode_append_attention` :387 /
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

CPU tensors take the `*_plain` versions; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.ops._native import (
    I, P, CudaKernel, check_tensor, ptr, stream)

SUPPORTED_D = (64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel("decode_attention.cu", {
    # q, k_pool, v_pool, bases, lengths, out, B, H, D, page, max_pages,
    # num_pages, dtype, stream
    "decode_attention": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
})
# the int8-pool launcher of the same library, with its own launch count
KERNEL_INT8 = CudaKernel("decode_attention.cu", {
    # q, k_pool, v_pool, bases, lengths, scales, k_new, v_new, out, B, H, D,
    # page, chunk, max_pages, num_pages, dtype, stream
    "decode_attention_int8": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                              I, P],
})
APPEND_KERNEL = CudaKernel("paged_append_attention.cu", {
    # q, k_pool, v_pool, tables, lengths, k_new, v_new, out, B, H, D, page,
    # max_pages, num_pages, dtype, stream
    "paged_append_attention": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                               P],
})


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
    KERNEL.launch("decode_attention", ptr(qs), ptr(k_pool), ptr(v_pool),
                  ptr(bases), ptr(lengths), ptr(out), B, H, D, page,
                  int(max_pages), Pn, _DTYPE_CODE[qs.dtype], stream())
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
                       ptr(k_new), ptr(v_new), ptr(out), B, H, D, page,
                       int(chunk), int(max_pages), Pn,
                       _DTYPE_CODE[qs.dtype], stream())
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
                         _DTYPE_CODE[qs.dtype], stream())
    return out[:, None], k_pool, v_pool
