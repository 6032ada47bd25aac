"""Grounding evaluation metrics of the Kosmos-2 eval harnesses (port of
unilm_tpu/scoring_grounding.py, with its own copy of
unilm_tpu/scoring_detection.py's `box_iou_np` :21).

- Flickr30k Entities: phrase-grounding R@1/5/10 over generated grounded
  captions (a predicted phrase's first k boxes against the phrase's
  ground-truth boxes at IoU 0.5).
- RefCOCO: referring-expression accuracy, the generated box for a forced
  `<phrase>expr</phrase>` prefix against the ground-truth box at IoU 0.5.
Markup parsing is data/grounding.py's `parse_grounded_text`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from unilm_tpu_torch.data.grounding import parse_grounded_text


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [N, 4] x [M, 4] xyxy boxes."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    iy = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = ix * iy

    def area(x):
        return (np.maximum(0.0, x[:, 2] - x[:, 0])
                * np.maximum(0.0, x[:, 3] - x[:, 1]))

    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _norm_phrase(p: str) -> str:
    return " ".join(p.lower().strip().split())


def grounded_text_to_predictions(text: str, quantized_size: int = 32
                                 ) -> List[Tuple[str, List[List[float]]]]:
    """Generated markup -> [(normalized phrase, [normalized boxes])]."""
    _, entities = parse_grounded_text(text, quantized_size)
    return [(_norm_phrase(ph), [list(b) for b in boxes])
            for ph, boxes in entities]


def phrase_grounding_recall(
    predictions: Sequence[Sequence[Tuple[str, List[List[float]]]]],
    ground_truth: Sequence[Sequence[Tuple[str, List[List[float]]]]],
    ks: Tuple[int, ...] = (1, 5, 10),
    iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """For every ground-truth phrase with boxes, the predicted entities of
    the same normalized phrase; a hit at k when any of their first k boxes
    reaches IoU >= iou_thresh with any ground-truth box of the phrase.
    Returns {'R@1', 'R@5', 'R@10', 'num_phrases'}."""
    hits = {k: 0 for k in ks}
    total = 0
    for preds, gts in zip(predictions, ground_truth):
        pred_by_phrase: Dict[str, List[List[float]]] = {}
        for ph, boxes in preds:
            pred_by_phrase.setdefault(_norm_phrase(ph), []).extend(boxes)
        for ph, gt_boxes in gts:
            if not gt_boxes:
                continue
            total += 1
            cand = pred_by_phrase.get(_norm_phrase(ph), [])
            if not cand:
                continue
            best_per_rank = box_iou_np(np.asarray(cand, np.float64),
                                       np.asarray(gt_boxes, np.float64)
                                       ).max(axis=1)
            for k in ks:
                if (len(best_per_rank[:k])
                        and best_per_rank[:k].max() >= iou_thresh):
                    hits[k] += 1
    out = {f"R@{k}": (hits[k] / total if total else 0.0) for k in ks}
    out["num_phrases"] = float(total)
    return out


def refexp_accuracy(pred_boxes: Sequence[Sequence[float]],
                    gt_boxes: Sequence[Sequence[float]],
                    iou_thresh: float = 0.5) -> Dict[str, float]:
    """Top-1 predicted box against the ground-truth box, accuracy at
    IoU >= iou_thresh; a None or malformed prediction is a miss."""
    correct, total = 0, 0
    for pb, gb in zip(pred_boxes, gt_boxes):
        total += 1
        if pb is None or len(pb) != 4:
            continue
        iou = box_iou_np(np.asarray([pb], np.float64),
                         np.asarray([gb], np.float64))[0, 0]
        if iou >= iou_thresh:
            correct += 1
    return {"accuracy": correct / total if total else 0.0,
            "num_refs": float(total)}
