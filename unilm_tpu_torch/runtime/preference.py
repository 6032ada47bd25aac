"""PFPO: DPO-family preference losses and pseudo-feedback pair
construction (port of unilm_tpu/runtime/preference.py).

- `sequence_log_probs`: masked sequence log-probs from decoder logits;
- `dpo_loss`: the sigmoid (with label smoothing), hinge and IPO losses,
  reference-free when no reference log-probs are given; the rewards are
  detached (JAX's stop_gradient);
- host-side pair construction from sampled solutions and pseudo labels
  (`SampledSolution`, `majority_answer`, `build_preference_pairs`,
  `aggregate_process_rewards`), copied from JAX's.

The log-probs come from whatever policy the caller runs: on a CUDA
tensor a port decoder's forward and backward go through the flash
kernels.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# Sequence log-probs
# --------------------------------------------------------------------------- #


def sequence_log_probs(logits: torch.Tensor, labels: torch.Tensor,
                       loss_mask: torch.Tensor,
                       average: bool = False) -> torch.Tensor:
    """Sum (or mean) of the per-token log-probs over the response span:
    logits [B, T, V], labels [B, T] (the targets of logits[:, :-1] are
    labels[:, 1:]), loss_mask [B, T - 1] (True = response token) -> [B]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    per_tok = torch.gather(logp, -1, labels[:, 1:].long()[..., None])[..., 0]
    m = loss_mask.float()
    s = torch.sum(per_tok * m, dim=-1)
    if average:
        return s / torch.clamp(torch.sum(m, dim=-1), min=1.0)
    return s


def dpo_loss(policy_chosen_logps: torch.Tensor,
             policy_rejected_logps: torch.Tensor,
             reference_chosen_logps: Optional[torch.Tensor] = None,
             reference_rejected_logps: Optional[torch.Tensor] = None,
             beta: float = 0.1, loss_type: str = "sigmoid",
             label_smoothing: float = 0.0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean loss, chosen rewards, rejected rewards); reference-free when
    the reference log-probs are None."""
    pi = policy_chosen_logps - policy_rejected_logps
    if reference_chosen_logps is None:
        ref = 0.0
        reference_chosen_logps = torch.zeros_like(policy_chosen_logps)
        reference_rejected_logps = torch.zeros_like(policy_rejected_logps)
    else:
        ref = reference_chosen_logps - reference_rejected_logps
    z = pi - ref
    if loss_type == "ipo":
        losses = (z - 1.0 / (2.0 * beta)) ** 2
    elif loss_type == "hinge":
        losses = F.relu(1.0 - beta * z)
    elif loss_type == "sigmoid":
        losses = (-F.logsigmoid(beta * z) * (1.0 - label_smoothing)
                  - F.logsigmoid(-beta * z) * label_smoothing)
    else:
        raise ValueError(f"unsupported loss_type {loss_type!r}")
    chosen_r = beta * (policy_chosen_logps - reference_chosen_logps).detach()
    rejected_r = beta * (policy_rejected_logps
                         - reference_rejected_logps).detach()
    return torch.mean(losses), chosen_r, rejected_r


# --------------------------------------------------------------------------- #
# Pseudo-feedback pair construction (host side; post_processors/dpo.py)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class SampledSolution:
    text: str
    answer: Optional[str] = None  # extracted final answer (self-consistency)
    pass_frac: Optional[float] = None  # fraction of test cases passed


def majority_answer(solutions: Sequence[SampledSolution]) -> Optional[str]:
    """Self-consistency pseudo label: the most common non-empty answer."""
    counts = collections.Counter(
        s.answer for s in solutions if s.answer not in (None, "")
    )
    if not counts:
        return None
    return counts.most_common(1)[0][0]


def build_preference_pairs(
    solutions: Sequence[SampledSolution],
    strategy: str = "self_consistency",  # or "test_cases"
    max_pairs: int = 8,
    min_margin: float = 0.5,
) -> List[Tuple[str, str]]:
    """(chosen, rejected) text pairs for one problem.

    self_consistency: solutions agreeing with the majority answer are chosen,
    disagreeing ones rejected. test_cases: rank by pass_frac; pair high
    against low when the margin exceeds `min_margin`.
    """
    pairs: List[Tuple[str, str]] = []
    if strategy == "self_consistency":
        label = majority_answer(solutions)
        if label is None:
            return []
        pos = [s for s in solutions if s.answer == label]
        neg = [s for s in solutions if s.answer not in (None, "", label)]
        for i in range(min(max_pairs, len(pos) * len(neg))):
            pairs.append((pos[i % len(pos)].text, neg[i // len(pos)].text))
    elif strategy == "test_cases":
        scored = [s for s in solutions if s.pass_frac is not None]
        scored.sort(key=lambda s: s.pass_frac, reverse=True)
        i, j = 0, len(scored) - 1
        while i < j and len(pairs) < max_pairs:
            if scored[i].pass_frac - scored[j].pass_frac >= min_margin:
                pairs.append((scored[i].text, scored[j].text))
                i += 1
                j -= 1
            else:
                break
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return pairs


def aggregate_process_rewards(
    step_probs: Sequence[float], reduction: str = "product"
) -> float:
    """Collapse per-step process-reward probabilities into one scalar
    (ResponseProcessRewardPostProcessor, post_processors/dpo.py:298)."""
    if not step_probs:
        return 0.0
    if reduction == "product":
        out = 1.0
        for p in step_probs:
            out *= p
        return out
    if reduction == "min":
        return min(step_probs)
    if reduction == "mean":
        return sum(step_probs) / len(step_probs)
    raise ValueError(f"unknown reduction {reduction!r}")
