"""Attention: plain torch reference + dispatch (port of
unilm_tpu/ops/attention.py:38-251).

The JAX dispatcher chose between Pallas kernels by measured v5e
crossovers and TPU availability gates; neither carries over. Here the
tensor's device decides:

- CPU tensors, or `use_flash=False` on any device: the plain
  `dot_product_attention` with the mask materialised, as the JAX XLA
  fallback does.
- CUDA tensors with `use_flash=True`: the hand-written flash kernels
  (ops/flash_attention.py: csrc/flash_fwd.cu forward, csrc/flash_bwd.cu
  backward when the inputs require grad). The branches whose JAX kernels
  are not ported yet raise NotImplementedError naming their ROADMAP entry:
  non-causal encoder attention (the `_vit_kernel` / `_doc_fwd_kernel`
  cases) and dropout.
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def make_causal_mask(q_positions: torch.Tensor, k_positions: torch.Tensor):
    """Bool [T, S]; True = may attend (k_pos <= q_pos)."""
    return k_positions[None, :] <= q_positions[:, None]


def make_window_mask(q_positions: torch.Tensor, k_positions: torch.Tensor,
                     window: int):
    """Sliding-window band: 0 <= q - k < window."""
    diff = q_positions[:, None] - k_positions[None, :]
    return (diff < window) & (diff >= 0)


def dot_product_attention(q, k, v, *, bias=None, mask=None, scale=None):
    """Plain attention with a float32 softmax. q [B,T,H,D], k/v [B,S,H,D],
    bias additive [B|1,H|1,T,S], mask bool broadcastable to [B,H,T,S].
    bf16 inputs keep the logits in bf16 and fp32 inputs in fp32, as the
    JAX reference does. Returns [B, T, H, D]."""
    out_dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q * scale, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(out_dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(
        out_dtype)


def attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, H, D]
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,  # additive [B|1, H|1, T, S]
    key_padding_mask: Optional[torch.Tensor] = None,  # bool [B, S], True = valid
    scale: Optional[float] = None,
    causal: bool = False,
    q_offset: Optional[int] = None,  # position of q[0]
    kv_len: Optional[int] = None,  # valid prefix length of k/v
    window: int = 0,
    dropout_rate: float = 0.0,
    use_flash: bool = True,
) -> torch.Tensor:
    """Dispatching attention front-end. Returns [B, T, H, D]."""
    T, S = q.shape[1], k.shape[1]
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (every UniGPT train config "
            "of the repo runs with dropout 0): ROADMAP Queue 1, remainder "
            "of slices 3-4 (dropout)")
    if use_flash and q.is_cuda:
        if (not causal and not window and kv_len is None and q_offset is None
                and S <= 2048):
            raise NotImplementedError(
                "non-causal encoder attention runs on the _vit_kernel / "
                "_doc_fwd_kernel Pallas kernels in the JAX package, not "
                "ported yet: ROADMAP Queue 2 #6 and #8")
        if not fa.supports(q, k, bias, window):
            raise NotImplementedError(
                f"flash forward kernel does not take q {tuple(q.shape)} "
                f"{q.dtype}, bias "
                f"{None if bias is None else tuple(bias.shape)}")
        return fa.flash_attention(
            q, k, v, bias=bias, key_padding_mask=key_padding_mask,
            scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len,
            window=window)

    # ---- plain path: materialise the combined mask -----------------------
    dev = q.device
    q_pos = torch.arange(T, device=dev) + (q_offset or 0)
    k_pos = torch.arange(S, device=dev)
    mask = None

    def _and(a, b):
        return b if a is None else a & b

    if key_padding_mask is not None:
        mask = _and(mask, key_padding_mask[:, None, None, :].bool())
    if causal:
        mask = _and(mask, make_causal_mask(q_pos, k_pos)[None, None])
    if window and window > 0:
        mask = _and(mask, make_window_mask(q_pos, k_pos, window)[None, None])
    if kv_len is not None:
        mask = _and(mask, (k_pos < kv_len)[None, None, None, :])
    return dot_product_attention(q, k, v, bias=bias, mask=mask, scale=scale)
