"""Evaluation scorers (the port's own copy of what its slices use from
unilm_tpu/scoring.py): seqeval-style entity P/R/F1, `extract_entities` :86
and `entity_f1` :100; ImageNet top-k accuracy, `accuracy_topk` :114."""

from __future__ import annotations

from typing import Dict, List

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


def extract_entities(labels: List[str]) -> set:
    """IOB2 span extraction, seqeval-compatible: {(type, start, end)}."""
    spans = set()
    start, typ = None, None
    for i, lab in enumerate(labels + ["O"]):
        tag, _, t = lab.partition("-")
        if start is not None and (tag in ("O", "B") or (tag == "I" and t != typ)):
            spans.add((typ, start, i))
            start, typ = None, None
        if tag == "B" or (tag == "I" and start is None):
            start, typ = i, t
    return spans


def entity_f1(true: List[List[str]], pred: List[List[str]]) -> Dict[str, float]:
    """seqeval micro P/R/F1 over entity spans (run_funsd_cord.py:421)."""
    tp = fp = fn = 0
    for t, p in zip(true, pred):
        ts, ps = extract_entities(t), extract_entities(p)
        tp += len(ts & ps)
        fp += len(ps - ts)
        fn += len(ts - ps)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"precision": prec, "recall": rec, "f1": f1}
