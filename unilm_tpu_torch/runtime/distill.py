"""MiniLM deep self-attention distillation, v1 and v2 relation losses
(port of unilm_tpu/runtime/distill.py).

- **v1**: KL between the teacher's and the student's last-layer attention
  distributions, plus KL between their value relations softmax(V V^T /
  sqrt(d_v)).
- **v2**: the heads concatenated and re-split into `num_relation_heads`
  relation heads; softmax(X X^T / sqrt(d_r)) matched for X in {Q, K, V},
  so teacher and student may have different head counts.

The q/k/v come from the core attention's capture: run a model inside
core/attention.py `capture_qkv(model)` (in train mode) and pass the
records to `collect_qkv`. On a CUDA tensor the captured forward launches
the same attention kernels as an uncaptured one. The teacher's relations
are detached (JAX's stop_gradient).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

QKV = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # each [B, T, H, D]


def collect_qkv(records: Dict[str, QKV]) -> List[QKV]:
    """The per-layer (q, k, v) of a `capture_qkv` record dict in layer
    order: sorted by the integers in the module paths, as JAX sorts its
    intermediates tree."""

    def layer_key(path: str):
        return [int(t) if t.isdigit() else -1
                for t in path.replace("_", ".").split(".") if t]

    return [tuple(records[p]) for p in sorted(records, key=layer_key)]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, T, H, D = x.shape
    return x.reshape(B, T, H * D)


def relation_log_probs(x: torch.Tensor, num_relation_heads: int,
                       key_padding_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """log softmax(X X^T / sqrt(d_r)) over relation heads: [B, Hr, T, T]
    (float32); masked keys (key_padding_mask [B, T], True = valid) get
    -1e30."""
    B, T = x.shape[:2]
    flat = _merge_heads(x).float()
    E = flat.shape[-1]
    if E % num_relation_heads:
        raise ValueError(f"width {E} does not split into "
                         f"{num_relation_heads} relation heads")
    dr = E // num_relation_heads
    r = flat.reshape(B, T, num_relation_heads, dr).transpose(1, 2)
    logits = torch.einsum("bhtd,bhsd->bhts", r, r) * (dr ** -0.5)
    if key_padding_mask is not None:
        logits = logits.masked_fill(~key_padding_mask[:, None, None, :],
                                    -1e30)
    return torch.log_softmax(logits, dim=-1)


def masked_mean_kl(t_logp: torch.Tensor, s_logp: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean KL(t || s) over the valid (batch, head, query row) entries."""
    kl = torch.sum(torch.exp(t_logp) * (t_logp - s_logp), dim=-1)
    if key_padding_mask is None:
        return torch.mean(kl)
    w = key_padding_mask[:, None, :].expand(kl.shape).to(kl.dtype)
    return torch.sum(kl * w) / torch.clamp(torch.sum(w), min=1.0)


def minilm_v2_loss(teacher_qkv: QKV, student_qkv: QKV,
                   num_relation_heads: int = 48,
                   key_padding_mask: Optional[torch.Tensor] = None,
                   weights: Sequence[float] = (1.0, 1.0, 1.0)
                   ) -> torch.Tensor:
    """Sum of the Q-Q / K-K / V-V relation KLs (teacher || student)."""
    total = 0.0
    for w, t_x, s_x in zip(weights, teacher_qkv, student_qkv):
        t = relation_log_probs(t_x, num_relation_heads, key_padding_mask)
        s = relation_log_probs(s_x, num_relation_heads, key_padding_mask)
        total = total + w * masked_mean_kl(t.detach(), s, key_padding_mask)
    return total


def minilm_v1_loss(teacher_qkv: QKV, student_qkv: QKV,
                   key_padding_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Attention-distribution KL + value-relation KL (teacher and student
    share the head count; per-head widths may differ)."""
    tq, tk, tv = (x.float() for x in teacher_qkv)
    sq, sk, sv = (x.float() for x in student_qkv)
    if tq.shape[2] != sq.shape[2]:
        raise ValueError("MiniLM v1 needs equal head counts (use v2)")

    def logp(a, b):
        logits = torch.einsum("bthd,bshd->bhts", a, b) * (a.shape[-1] ** -0.5)
        if key_padding_mask is not None:
            logits = logits.masked_fill(
                ~key_padding_mask[:, None, None, :], -1e30)
        return torch.log_softmax(logits, dim=-1)

    at = logp(tq, tk).detach()
    vt = logp(tv, tv).detach()
    return (masked_mean_kl(at, logp(sq, sk), key_padding_mask)
            + masked_mean_kl(vt, logp(sv, sv), key_padding_mask))
