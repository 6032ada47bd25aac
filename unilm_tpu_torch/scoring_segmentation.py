"""Semantic-segmentation metrics: mIoU / per-class IoU / pixel accuracy (a
numpy copy of unilm_tpu/scoring_segmentation.py: `confusion_matrix` :16,
`miou_from_confusion` :28, `evaluate_segmentation` :41 and
`reduce_zero_label` :51).

The mmseg evaluation used by
beit/semantic_segmentation (ADE20K 57.0 mIoU table, beit/README.md:18):
confusion-matrix mIoU with ignore_index handling and the ADE20K
reduce_zero_label convention (label 0 = unlabeled -> ignore, classes
shift down by one)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(
    pred: np.ndarray, label: np.ndarray, num_classes: int, ignore_index: int = 255
) -> np.ndarray:
    mask = label != ignore_index
    p = pred[mask].astype(np.int64)
    l = label[mask].astype(np.int64)
    cm = np.bincount(
        l * num_classes + p, minlength=num_classes * num_classes
    ).reshape(num_classes, num_classes)
    return cm


def miou_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, np.nan)
        acc_per_class = np.where(cm.sum(1) > 0, inter / cm.sum(1), np.nan)
    return {
        "mIoU": float(np.nanmean(iou)),
        "aAcc": float(inter.sum() / max(cm.sum(), 1)),
        "mAcc": float(np.nanmean(acc_per_class)),
    }


def evaluate_segmentation(
    preds, labels, num_classes: int, ignore_index: int = 255
) -> Dict[str, float]:
    """preds/labels: iterables of [H, W] int arrays."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    for p, l in zip(preds, labels):
        cm += confusion_matrix(np.asarray(p), np.asarray(l), num_classes, ignore_index)
    return miou_from_confusion(cm)


def reduce_zero_label(label: np.ndarray, ignore_index: int = 255) -> np.ndarray:
    """ADE20K convention: 0 = unlabeled -> ignore; classes 1..150 -> 0..149."""
    out = label.astype(np.int64) - 1
    out[label == 0] = ignore_index
    return out
