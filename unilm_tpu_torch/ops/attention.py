"""Attention: plain torch reference + dispatch (port of
unilm_tpu/ops/attention.py:38-251).

The JAX dispatcher chose between Pallas kernels by measured v5e
crossovers and TPU availability gates; neither carries over. Here the
tensor's device decides:

- CPU tensors, or `use_flash=False` on any device: the plain
  `dot_product_attention` with the mask materialised, as the JAX XLA
  fallback does.
- CUDA tensors with `use_flash=True`:
  - non-causal, no window / kv_len / q_offset, S <= 2048, with a
    key-padding mask or a head-major bias (`doc_attention.HeadMajorBias`,
    LayoutLMv3's): the blocked doc attention (the `_doc_fwd_kernel` case:
    csrc/doc_attention.cu forward, csrc/doc_attention_bwd.cu backward
    when the inputs require grad, `DocAttentionFn`);
  - the same geometry with neither: the fused encoder attention (the
    `_vit_kernel` case: csrc/encoder_attention.cu forward,
    csrc/encoder_attention_bwd.cu backward, `EncoderAttentionFn`);
  - everything else (causal, decode geometry, S > 2048): the flash
    forward (`fa.flash_attention`), which picks its kernel as JAX's
    `_flash_impl` does: the one-pass #5 (csrc/onepass_attention.cu)
    where `fa.onepass_applies` (a copy of `_onepass_profitable`) admits
    the shape, else #1 (csrc/flash_fwd.cu); csrc/flash_bwd.cu backward
    when the inputs require grad. A head-major bias is read through its
    [B, H, T, S] view.
  Here the port parts from JAX: JAX sends calls with T <= 8, and short
  causal calls without a window, to XLA (ops/attention.py:139,
  :203-208); the port sends them to flash, so under the selector they
  take #5 (YOCO's decode steps, and its cross layers over a 256-slot
  cache). The function is the same except on a query row with no visible
  key (a causal row whose keys are all padding): the flash kernels give
  it out = 0, as JAX's own flash kernels do, where JAX's XLA path and
  the port's plain path give the mean of v over all S keys
  (tests/test_torch_dead_rows.py pins both). Their gradients are the
  flash backward's (#6 / #7), which takes delta = rowsum(p dp) exactly,
  as the softmax backward of JAX's XLA path does, and not JAX's flash
  kernels' rowsum(dO out) from the bf16 out: where the attention is near
  uniform (the late decoder layers of a random-weight TrOCR-Base) that
  rounding loses the q and k gradients (chip_smoke.py `trocr_train`
  holds the kernels' gradients to the plain path's). The doc kernel's VMEM
  admissibility is a TPU budget and is not carried: some shapes the TPU
  sends to #9 (a mid-size S with no mask) take #3 here, which computes
  the same function there.
- Attention dropout (`dropout_rate > 0` with a `dropout_rng`, a training
  forward) takes the plain path on every device: JAX sends every call
  with a rate to its XLA path (ops/attention.py:122, :139) and no Pallas
  kernel computes it, so on the card this is JAX's own route and the
  launch counters show no attention kernel for such a call. The mask comes
  from ops/dropout.py's `draw_keep` over the float32 probabilities, which
  are scaled by 1 / (1 - rate), as JAX's. Kept on purpose: JAX also takes
  its XLA path at evaluation, where the rate is still passed; the port
  launches the kernels whenever no mask is drawn (no `dropout_rng`). The
  two compute the same function.
- A head-major bias on the plain path is permuted to [B, H, T, S] (a
  view), as the JAX dispatcher does where its kernel does not apply.
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.ops import doc_attention as da
from unilm_tpu_torch.ops import dropout as dropout_ops
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


def dot_product_attention(q, k, v, *, bias=None, mask=None, scale=None,
                          dropout_rate: float = 0.0, dropout_rng=None):
    """Plain attention with a float32 softmax. q [B,T,H,D], k/v [B,S,H,D],
    bias additive [B|1,H|1,T,S], mask bool broadcastable to [B,H,T,S].
    bf16 inputs keep the logits in bf16 and fp32 inputs in fp32, as the
    JAX reference does. With `dropout_rng` the float32 probabilities are
    dropped at `dropout_rate` (keep [B, H, T, S] from `draw_keep`) and
    scaled by 1 / (1 - rate). Returns [B, T, H, D]."""
    out_dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q * scale, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = dropout_ops.draw_keep(probs.shape, dropout_rate, dropout_rng,
                                 probs.device)
        probs = probs * keep / (1.0 - dropout_rate)
    probs = probs.to(out_dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(
        out_dtype)


def attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, H, D]
    v: torch.Tensor,
    *,
    bias=None,  # additive [B|1, H|1, T, S], or a da.HeadMajorBias
    key_padding_mask: Optional[torch.Tensor] = None,  # bool [B, S], True = valid
    scale: Optional[float] = None,
    causal: bool = False,
    q_offset: Optional[int] = None,  # position of q[0]
    kv_len: Optional[int] = None,  # valid prefix length of k/v
    window: int = 0,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Dispatching attention front-end. Returns [B, T, H, D]. A
    `dropout_rng` with `dropout_rate > 0` (a training forward) drops the
    probabilities on the plain path; without one the rate is not
    applied."""
    T, S = q.shape[1], k.shape[1]
    drop = dropout_rate > 0.0 and dropout_rng is not None
    if use_flash and q.is_cuda and not drop:
        if (not causal and not window and kv_len is None and q_offset is None
                and S <= fa.ENCODER_MAX_S):
            if (key_padding_mask is not None
                    or isinstance(bias, da.HeadMajorBias)):
                return da.doc_attention(q, k, v, bias, key_padding_mask,
                                        scale)
            return fa.fused_encoder_attention(q, k, v, bias=bias, scale=scale)
        if isinstance(bias, da.HeadMajorBias):
            bias = bias.bhts()
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
    if isinstance(bias, da.HeadMajorBias):
        bias = bias.bhts()
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
    return dot_product_attention(
        q, k, v, bias=bias, mask=mask, scale=scale,
        dropout_rate=dropout_rate if drop else 0.0, dropout_rng=dropout_rng)
