"""Evaluation scorers (the port's own copy of what its slices use from
unilm_tpu/scoring.py): seqeval-style entity P/R/F1, `extract_entities` :86
and `entity_f1` :100; ImageNet top-k accuracy, `accuracy_topk` :114;
TrOCR's character and word error rates, `cer` :33 and `wer` :45.

The edit distance is a copy of the pure-numpy fallback of
unilm_tpu/native/__init__.py `edit_distance` :83 (the JAX package builds
a C++ library for it; the port builds none)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    """Levenshtein distance between two int sequences."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i in range(1, len(a) + 1):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[len(b)])


def _word_ids(a: List[str], b: List[str]):
    """The two word lists as ids of one shared table."""
    table: Dict = {}
    return ([table.setdefault(t, len(table)) for t in a],
            [table.setdefault(t, len(table)) for t in b])


def cer(refs: List[str], hyps: List[str]) -> float:
    """Character error rate: the summed edit distances over the summed
    reference lengths (trocr's cer2)."""
    dist = total = 0
    for r, h in zip(refs, hyps):
        dist += edit_distance([ord(c) for c in r], [ord(c) for c in h])
        total += len(r)
    return dist / max(total, 1)


def wer(refs: List[str], hyps: List[str]) -> float:
    """Word error rate over whitespace-split words."""
    dist = total = 0
    for r, h in zip(refs, hyps):
        ra, ha = _word_ids(r.split(), h.split())
        dist += edit_distance(ra, ha)
        total += len(ra)
    return dist / max(total, 1)


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
