"""Decode attention over contiguous KV page runs (port of
unilm_tpu/ops/paged_attention.py `run_decode_append_attention` :647 /
`_run_decode_kernel` :497, non-quantized variant).

Pools are FLAT [P, page, H*D], the JAX layout. `bases[b]` is the
chunk-aligned first page of sequence b's run and `lengths[b]` the tokens
already in it; the step's K/V row is appended at token `lengths[b]` and
attention runs over the `lengths[b] + 1` tokens.

The pools are updated IN PLACE (the JAX function returns new pools; here
the returned pools are the same tensors that were passed in). On a CUDA
tensor the row is written with an index_put on the current stream and
the hand-written kernel in csrc/decode_attention.cu reads it back; on a
CPU tensor `run_decode_append_attention_plain` computes the same thing in
plain torch. The int8-KV variant (scale sidecar) is not ported yet
(ROADMAP Queue 2 #3).
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


def _append_rows(k_new, v_new, k_pool, v_pool, bases, lengths):
    """Write this step's K/V row of every sequence at token lengths[b]."""
    B, HD = k_new.shape[0], k_pool.shape[2]
    page = k_pool.shape[1]
    pids = (bases + torch.div(lengths, page, rounding_mode="floor")).long()
    offs = torch.remainder(lengths, page).long()
    k_pool[pids, offs] = k_new.reshape(B, HD).to(k_pool.dtype)
    v_pool[pids, offs] = v_new.reshape(B, HD).to(v_pool.dtype)


def run_decode_append_attention_plain(q, k_new, v_new, k_pool, v_pool, bases,
                                      lengths, max_pages: Optional[int] = None,
                                      scale: Optional[float] = None,
                                      chunk: int = 8):
    """Plain torch twin of the kernel path; same arguments and results.
    Float32 scores; pool tokens' probabilities are rounded to the pool
    dtype before the PV sum, the new token's are not (the TPU kernel's
    analytic merge)."""
    B, _, H, D = q.shape
    Pn, page, HD = k_pool.shape
    if scale is None:
        scale = D ** -0.5
    if max_pages is None:
        max_pages = Pn - 1
    _append_rows(k_new, v_new, k_pool, v_pool, bases, lengths)
    qs = (q[:, 0] * scale).float()  # [B, H, D], scaled in q's dtype first
    kf = k_pool.reshape(Pn * page, H, D)
    vf = v_pool.reshape(Pn * page, H, D)
    outs = []
    for b, (base, L) in enumerate(zip(bases.tolist(), lengths.tolist())):
        n = min(L, max_pages * page)
        r0 = base * page
        ks, vs = kf[r0:r0 + n].float(), vf[r0:r0 + n].float()  # [n, H, D]
        kn = k_new[b, 0].to(k_pool.dtype).float()  # [H, D]
        vn = v_new[b, 0].to(v_pool.dtype).float()
        s = torch.einsum("hd,thd->ht", qs[b], ks)
        s_new = (qs[b] * kn).sum(-1, keepdim=True)  # [H, 1]
        m = torch.maximum(s.amax(-1, keepdim=True) if n else s_new, s_new)
        e = torch.exp(s - m)
        p_new = torch.exp(s_new - m)
        l = e.sum(-1, keepdim=True) + p_new
        p = e.to(k_pool.dtype).float()
        acc = torch.einsum("ht,thd->hd", p, vs) + p_new * vn
        outs.append(acc / l)
    out = torch.stack(outs).to(q.dtype)[:, None]
    return out, k_pool, v_pool


def decode_attention(qs: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, bases: torch.Tensor,
                     lengths: torch.Tensor, max_pages: int) -> torch.Tensor:
    """Launch the CUDA kernel alone: attention of pre-scaled qs [B, H, D]
    over tokens 0..lengths[b] of each run, whose last row the caller has
    already written. Returns out [B, H, D]."""
    B, H, D = qs.shape
    Pn, page, HD = k_pool.shape
    if HD != H * D:
        raise ValueError(f"q {tuple(qs.shape)} does not match pool "
                         f"{tuple(k_pool.shape)}")
    if qs.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"decode kernel takes float32/bfloat16 with head_dim "
                         f"in {SUPPORTED_D}, got {qs.dtype}, D={D}")
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: CUDA tensors only, got {dev}")
    check_tensor("q", qs, dtype=qs.dtype, shape=(B, H, D), device=dev)
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_tensor(name, pool, dtype=qs.dtype, shape=(Pn, page, HD),
                     device=dev)
    check_tensor("bases", bases, dtype=torch.int32, shape=(B,), device=dev)
    check_tensor("lengths", lengths, dtype=torch.int32, shape=(B,),
                 device=dev)
    out = torch.empty((B, H, D), dtype=qs.dtype, device=dev)
    KERNEL.launch("decode_attention", ptr(qs), ptr(k_pool), ptr(v_pool),
                  ptr(bases), ptr(lengths), ptr(out), B, H, D, page,
                  int(max_pages), Pn, _DTYPE_CODE[qs.dtype], stream())
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
):
    """Append the step's K/V rows and attend over lengths + 1 tokens.
    Returns (out [B, 1, H, D], k_pool, v_pool); the pools are the input
    tensors, updated in place. Callers keep bases chunk-aligned and
    lengths + 1 <= max_pages * page; the kernel clamps its reads to that
    budget and to the pool."""
    if q.device.type == "cpu":
        return run_decode_append_attention_plain(
            q, k_new, v_new, k_pool, v_pool, bases, lengths, max_pages, scale,
            chunk)
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
    _append_rows(k_new, v_new, k_pool, v_pool, bases, lengths)
    qs = (q[:, 0] * scale).contiguous()  # [B, H, D], scaled in q's dtype
    out = decode_attention(qs, k_pool, v_pool, bases, lengths, max_pages)
    return out[:, None], k_pool, v_pool
