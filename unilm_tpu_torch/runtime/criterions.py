"""Criterions: masked LM, masked image modeling, label-smoothed CE,
InfoXLM's XLCo contrastive loss and xTune's consistency losses (port of
unilm_tpu/runtime/criterions.py: `apply_mlm_mask` :23, `masked_lm_loss`
:55, `mim_loss` :65, `label_smoothed_nll_loss` :76, `xlco_loss` :104,
`momentum_update` :124, `queue_enqueue` :131, `_row_kl` :150,
`xtune_r1_loss` :166, `xtune_r2_loss` :187), on torch tensors.

`apply_mlm_mask` draws its uniforms and random tokens from an explicit
`torch.Generator` (JAX splits a key three ways; the key stream cannot be
reproduced), then corrupts exactly as JAX does given those draws
(`mlm_corrupt`). Losses compute in float32; JAX's stop_gradient is
`detach`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

IGNORE = -100


def mlm_corrupt(tokens: torch.Tensor, u_select: torch.Tensor,
                u_kind: torch.Tensor, rand_tokens: torch.Tensor,
                mask_token_id: int, mask_prob: float = 0.15,
                special_ids: Sequence[int] = (0, 1, 2, 3),
                leave_unmasked_prob: float = 0.1,
                random_token_prob: float = 0.1):
    """BERT corruption given its draws: positions with u_select <
    mask_prob (not special) are selected; of those, u_kind < 1 -
    leave_unmasked - random -> [MASK], u_kind >= 1 - random -> the random
    token, else unchanged. Returns (corrupted, labels), labels IGNORE off
    target."""
    special = torch.zeros_like(tokens, dtype=torch.bool)
    for s in special_ids:
        special = special | (tokens == s)
    selected = (u_select < mask_prob) & ~special
    use_mask = selected & (u_kind < 1.0 - leave_unmasked_prob
                           - random_token_prob)
    use_rand = selected & (u_kind >= 1.0 - random_token_prob)
    corrupted = torch.where(use_mask, mask_token_id, tokens)
    corrupted = torch.where(use_rand, rand_tokens.to(tokens.dtype), corrupted)
    labels = torch.where(selected, tokens, IGNORE)
    return corrupted, labels


def apply_mlm_mask(generator: torch.Generator, tokens: torch.Tensor,
                   mask_token_id: int, vocab_size: int,
                   mask_prob: float = 0.15,
                   special_ids: Sequence[int] = (0, 1, 2, 3),
                   leave_unmasked_prob: float = 0.1,
                   random_token_prob: float = 0.1
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT corruption of tokens [B, T]: mask_prob of the non-special
    positions are selected; of those 80% -> [MASK], 10% -> a random token,
    10% unchanged (with the default probabilities). The draws come from
    `generator` (on the tokens' device). Returns (corrupted, labels)."""
    dev = tokens.device
    u1 = torch.rand(tokens.shape, generator=generator, device=dev)
    u2 = torch.rand(tokens.shape, generator=generator, device=dev)
    rand = torch.randint(0, vocab_size, tokens.shape, generator=generator,
                         device=dev)
    return mlm_corrupt(tokens, u1, u2, rand, mask_token_id, mask_prob,
                       special_ids, leave_unmasked_prob, random_token_prob)


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over positions with labels != IGNORE: (loss, count)."""
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    n = valid.sum()
    return (nll * valid).sum() / n.clamp(min=1), n


def mim_loss(logits: torch.Tensor, target_ids: torch.Tensor,
             bool_masked_pos: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BEiT's masked-image-modeling loss: CE at the masked patches only."""
    labels = torch.where(bool_masked_pos.bool(), target_ids, IGNORE)
    return masked_lm_loss(logits, labels)


def label_smoothed_nll_loss(logits: torch.Tensor, targets: torch.Tensor,
                            epsilon: float = 0.1,
                            ignore_index: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fairseq label_smoothed_cross_entropy: (1 - eps) NLL + eps times the
    uniform CE. Returns (summed loss, sample size)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    valid = (torch.ones_like(targets, dtype=torch.bool)
             if ignore_index is None else targets != ignore_index)
    safe = torch.where(valid, targets, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    loss = (1.0 - epsilon) * nll + epsilon * smooth
    return (loss * valid).sum(), valid.sum()


# ---- InfoXLM XLCo: cross-lingual contrastive pretraining ------------------


def xlco_loss(query: torch.Tensor, key: torch.Tensor, queue: torch.Tensor,
              tau: float = 0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE with the translation pair as the positive and the momentum
    queue as the negatives (xlco.py:32-44); `key` and `queue` are
    constants. Returns (summed loss, number correct)."""
    key, queue = key.detach(), queue.detach()
    pos = (query * key).sum(dim=-1, keepdim=True)  # [N, 1]
    neg = query @ queue.t()  # [N, K]
    logits = torch.cat([pos, neg], dim=1) / tau
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp[:, 0].sum(), (logits.argmax(dim=-1) == 0).sum()


@torch.no_grad()
def momentum_update(fast_params, slow_params, momentum: float = 0.9999):
    """MoCo's slow-encoder EMA: slow = m slow + (1 - m) fast, for
    matching sequences (or dicts) of tensors; returns the new slow ones."""
    if isinstance(slow_params, dict):
        return {k: momentum * slow_params[k] + (1.0 - momentum)
                * fast_params[k] for k in slow_params}
    return [momentum * s + (1.0 - momentum) * f
            for s, f in zip(slow_params, fast_params)]


def queue_enqueue(queue: torch.Tensor, ptr: int, keys: torch.Tensor):
    """Ring-buffer enqueue of [N, C] keys into the [K, C] negative queue
    at ptr % K (K a multiple of N, MoCo's convention). Returns (queue,
    ptr)."""
    K, N = queue.shape[0], keys.shape[0]
    start = int(ptr) % K
    queue = queue.clone()
    queue[start:start + N] = keys.detach().to(queue.dtype)
    return queue, (int(ptr) + N) % K


# ---- xTune: consistency regularization for cross-lingual fine-tuning ------


def _row_kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(q) || softmax(p)) per row, float32 (the reference's
    KL(input, target) up to the reduction: rows are averaged here, the
    constant factor goes into the lambdas)."""
    logp = F.log_softmax(p_logits.float(), dim=-1)
    q = F.softmax(q_logits.float(), dim=-1)
    logq = F.log_softmax(q_logits.float(), dim=-1)
    return (q * (logq - logp)).sum(dim=-1)


def xtune_r1_loss(logits: torch.Tensor, noised_logits: torch.Tensor,
                  r1_mask: Optional[torch.Tensor] = None,
                  r1_lambda: float = 5.0) -> torch.Tensor:
    """Example consistency (stage 1): the symmetric KL between the clean
    and the noised view, each direction against the other held fixed
    (r1_loss_f / r1_loss_b, modeling_xlm_roberta.py:379-386)."""
    kl = (_row_kl(noised_logits, logits.detach())
          + _row_kl(logits, noised_logits.detach()))
    if r1_mask is not None:
        w = r1_mask.to(kl.dtype)
        return r1_lambda * (kl * w).sum() / w.sum().clamp(min=1.0)
    return r1_lambda * kl.mean()


def xtune_r2_loss(logits: torch.Tensor, stage1_logits: torch.Tensor,
                  augmented_mask: Optional[torch.Tensor] = None,
                  r2_lambda: float = 1.0,
                  use_hard_labels: bool = False) -> torch.Tensor:
    """Model consistency (stage 2): pull the model toward the frozen
    stage-1 model on augmented examples (modeling_xlm_roberta.py:322-331);
    with hard labels, the CE against stage 1's argmax."""
    stage1_logits = stage1_logits.detach()
    if use_hard_labels:
        hard = stage1_logits.argmax(dim=-1)
        logp = F.log_softmax(logits.float(), dim=-1)
        per_row = -logp.gather(-1, hard[:, None])[:, 0]
    else:
        per_row = _row_kl(logits, stage1_logits)
    if augmented_mask is not None:
        w = augmented_mask.to(per_row.dtype)
        return r2_lambda * (per_row * w).sum() / w.sum().clamp(min=1.0)
    return r2_lambda * per_row.mean()
