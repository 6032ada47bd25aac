"""SEED-Bench multiple-choice evaluation by answer log-likelihood (port of
unilm_tpu/scoring_seedbench.py, in torch and numpy).

Kosmos-2's seed-bench scripts (cook_image_data.py, eval_ppl.py): each
question expands to one candidate sequence per choice ("Question: {q}
Answer: {choice}"), each candidate is scored by the MEAN next-token
log-probability of its answer segment, and the argmax choice is held
against the answer; accuracy overall and per question type. All
candidates go through one batched forward; the ranking runs in numpy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CHOICE_LETTERS = "ABCDEF"


def answer_span_logprob(logits: torch.Tensor, tokens: torch.Tensor,
                        answer_mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token log-prob over each row's answer segment, [B].
    logits [B, T, V], tokens [B, T], answer_mask [B, T] (1 where
    tokens[t] is an answer token, scored by logits[t - 1]); float32."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    tok_lp = logp.gather(-1, tgt[..., None])[..., 0]
    m = answer_mask[:, 1:].float()
    return (tok_lp * m).sum(-1) / m.sum(-1).clamp(min=1.0)


def rank_choices(scores: np.ndarray) -> np.ndarray:
    """[N, C] scores -> [N] choice indices (ties go to the first)."""
    return np.asarray(scores).argmax(axis=-1)


def seedbench_accuracy(scores: np.ndarray, answers: Sequence[int],
                       question_types: Optional[Sequence[str]] = None
                       ) -> Dict:
    """Overall and per-question-type accuracy of [N, C] choice scores."""
    pred = rank_choices(scores)
    correct = pred == np.asarray(answers)
    out = {
        "accuracy": float(correct.mean()) if len(correct) else 0.0,
        "total": int(len(correct)),
        "correct": int(correct.sum()),
        "predictions": [CHOICE_LETTERS[int(p)] for p in pred],
    }
    if question_types is not None:
        per: Dict[str, List[bool]] = defaultdict(list)
        for t, c in zip(question_types, correct):
            per[str(t)].append(bool(c))
        out["per_type"] = {
            t: {"accuracy": float(np.mean(v)), "total": len(v)}
            for t, v in sorted(per.items())}
    return out


def cook_candidates(question: str, choices: Sequence[str]
                    ) -> List[Tuple[str, str]]:
    """One (prompt, answer) pair per choice: "Question: {q} Answer:" and
    " {choice}", whitespace collapsed."""
    q = " ".join(question.split())
    return [(f"Question: {q} Answer:", " " + " ".join(c.split()))
            for c in choices]
