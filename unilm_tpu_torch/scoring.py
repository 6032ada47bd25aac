"""Evaluation scorers (the port's own copy of what its slices use from
unilm_tpu/scoring.py): ImageNet top-k accuracy, `accuracy_topk` :114."""

from __future__ import annotations

from typing import Dict

import numpy as np


def accuracy_topk(logits: np.ndarray, labels: np.ndarray,
                  topk=(1, 5)) -> Dict[str, float]:
    """Top-k accuracy in percent (beit/utils.py:403), {"acc1": .., ...}."""
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in topk:
        correct = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"acc{k}"] = float(correct.mean()) * 100.0
    return out
