"""Evaluation scorers (the port's copy of unilm_tpu/scoring.py):
seqeval-style entity P/R/F1, `extract_entities` :86 and `entity_f1` :100;
ImageNet top-k accuracy, `accuracy_topk` :114; TrOCR's character and word
error rates, `cer` :33 and `wer` :45; corpus BLEU-4, `BleuScorer` :55;
the IoU of two boxes, `box_iou` :124, and phrase grounding's R@k,
`grounding_recall` :133.

The edit distance and the BLEU n-gram counts are native/__init__.py's
numpy ops (the JAX package can build a C++ library for them; the port
builds none)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from unilm_tpu_torch.native import bleu_counts, edit_distance


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


class BleuScorer:
    """Corpus BLEU-4 with brevity penalty (libbleu semantics)."""

    def __init__(self):
        self.counts = np.zeros(8, np.int64)
        self.ref_len = 0
        self.hyp_len = 0

    def add(self, ref: Sequence[int], hyp: Sequence[int]):
        ref = np.asarray(ref, np.int32)
        hyp = np.asarray(hyp, np.int32)
        bleu_counts(ref, hyp, self.counts)
        self.ref_len += len(ref)
        self.hyp_len += len(hyp)

    def add_string(self, ref: str, hyp: str):
        table: Dict = {}
        enc = lambda s: [table.setdefault(w, len(table)) for w in s.split()]
        self.add(enc(ref), enc(hyp))

    def score(self) -> float:
        logs = 0.0
        for n in range(4):
            match, total = self.counts[2 * n], self.counts[2 * n + 1]
            if total == 0 or match == 0:
                return 0.0
            logs += math.log(match / total)
        bp = min(0.0, 1.0 - self.ref_len / max(self.hyp_len, 1))
        return 100.0 * math.exp(logs / 4.0 + bp)


def box_iou(a, b) -> float:
    """IoU of two (x0, y0, x1, y1) boxes."""
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    area = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / area if area > 0 else 0.0


def grounding_recall(
    predictions: List[List[Tuple[float, float, float, float]]],
    references: List[Tuple[float, float, float, float]],
    iou_threshold: float = 0.5,
    topk: int = 1,
) -> float:
    """R@k for phrase grounding (kosmos-2 flickr / refcoco evaluation):
    prediction i's top-k boxes against reference box i."""
    hit = 0
    for preds, ref in zip(predictions, references):
        if any(box_iou(p, ref) >= iou_threshold for p in preds[:topk]):
            hit += 1
    return hit / max(len(references), 1)
