"""COCO-style mAP evaluation, the cTDaR table wF1 and FUNSD text
detection (a numpy copy of unilm_tpu/scoring_detection.py: `box_iou_np`
:21, `evaluate_detections` :66, `evaluate_icdar_table_detection` :117 and
`evaluate_text_detection` :168; host-side).

The reference's detectron2 COCOEvaluator used by
dit/object_detection (mytrainer.py build_evaluator -> COCO mAP tables in
dit/README.md:66-99) and dit/text_detection/ditod/funsd_evaluation.py.
Implements the COCO AP protocol: per-class, per-IoU-threshold greedy
matching of score-sorted detections against ground truth, 101-point
interpolated precision, averaged over IoU .50:.05:.95 ('all' area range,
maxDets=100).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRESHS = np.arange(0.5, 1.0, 0.05)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [N,4] x [M,4] xyxy boxes."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.maximum(
        0.0,
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]),
    )
    iy = np.maximum(
        0.0,
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]),
    )
    inter = ix * iy
    area = lambda x: np.maximum(0.0, x[:, 2] - x[:, 0]) * np.maximum(
        0.0, x[:, 3] - x[:, 1]
    )
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _ap_from_matches(scores, matched, num_gt) -> float:
    """101-point interpolated AP given per-detection (score, matched) pairs."""
    if num_gt == 0:
        return np.nan
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # precision envelope (monotone non-increasing from the right)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    # 101-point interpolation
    rec_points = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, rec_points, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(np.mean(prec_at))


def evaluate_detections(
    predictions: Sequence[Dict],  # per image: boxes [N,4], scores [N], labels [N]
    ground_truth: Sequence[Dict],  # per image: boxes [M,4], labels [M]
    num_classes: int,
    max_dets: int = 100,
) -> Dict[str, float]:
    """Returns {'mAP', 'AP50', 'AP75', 'AP_class_<c>'...} (COCO protocol)."""
    assert len(predictions) == len(ground_truth)
    ap = np.full((len(IOU_THRESHS), num_classes), np.nan)

    for c in range(num_classes):
        num_gt = sum(int(np.sum(g["labels"] == c)) for g in ground_truth)
        for ti, thr in enumerate(IOU_THRESHS):
            all_scores, all_matched = [], []
            for pred, gt in zip(predictions, ground_truth):
                sel = pred["labels"] == c
                boxes = np.asarray(pred["boxes"])[sel]
                scores = np.asarray(pred["scores"])[sel]
                order = np.argsort(-scores, kind="stable")[:max_dets]
                boxes, scores = boxes[order], scores[order]
                gsel = np.asarray(gt["labels"]) == c
                gboxes = np.asarray(gt["boxes"])[gsel]
                ious = box_iou_np(boxes, gboxes)
                taken = np.zeros(len(gboxes), bool)
                matched = np.zeros(len(boxes), bool)
                for di in range(len(boxes)):
                    if len(gboxes) == 0:
                        break
                    j = int(np.argmax(np.where(taken, -1.0, ious[di])))
                    if not taken[j] and ious[di, j] >= thr:
                        taken[j] = True
                        matched[di] = True
                all_scores.append(scores)
                all_matched.append(matched)
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            matched = np.concatenate(all_matched) if all_matched else np.zeros(0, bool)
            ap[ti, c] = _ap_from_matches(scores, matched, num_gt)

    with np.errstate(invalid="ignore"):
        per_class = np.nanmean(ap, axis=0)
        result = {
            "mAP": float(np.nanmean(ap)),
            "AP50": float(np.nanmean(ap[0])),
            "AP75": float(np.nanmean(ap[5])),
        }
    for c in range(num_classes):
        if not np.isnan(per_class[c]):
            result[f"AP_class_{c}"] = float(per_class[c])
    return result


def evaluate_icdar_table_detection(
    predictions: Sequence[np.ndarray],  # per image: [N, 4] xyxy (pre-sorted)
    ground_truth: Sequence[np.ndarray],  # per image: [M, 4] xyxy
    iou_thresholds: Sequence[float] = (0.6, 0.7, 0.8, 0.9),
) -> Dict[str, float]:
    """ICDAR-2019 cTDaR TRACK A (table region) weighted-average F1.

    Protocol of dit/object_detection/ditod/table_evaluation/evaluate.py
    (calc_table_score + eval.evaluate_result_reg, the metric behind the
    dit/README.md:79-99 wF1 tables): per image, each GT table greedily
    takes the FIRST remaining prediction (list order) with IoU >= t; true
    positives / GT / result counts are summed over the dataset per IoU
    threshold t in {0.6, 0.7, 0.8, 0.9}; F1(t) combine into
    wF1 = sum(t * F1(t)) / sum(t) (evaluate.py:274-278,352-380).

    Predictions carry no scores in the reference's XML submission format —
    pass each image's boxes in the order your decoder emits them (the
    serialization order is part of the protocol).
    """
    assert len(predictions) == len(ground_truth)
    result: Dict[str, float] = {}
    f1s = []
    for t in iou_thresholds:
        tp, n_gt, n_res = 0, 0, 0
        for pred, gt in zip(predictions, ground_truth):
            pred = np.asarray(pred, np.float64).reshape(-1, 4)
            gt = np.asarray(gt, np.float64).reshape(-1, 4)
            n_gt += len(gt)
            n_res += len(pred)
            if len(gt) == 0 or len(pred) == 0:
                continue
            iou = box_iou_np(gt, pred)
            remaining = list(range(len(pred)))
            for gi in range(len(gt)):
                for ri in remaining:
                    if iou[gi, ri] >= t:
                        remaining.remove(ri)
                        tp += 1
                        break
        p = tp / n_res if n_res else 0.0
        r = tp / n_gt if n_gt else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) else 0.0
        result[f"precision@{t}"] = p
        result[f"recall@{t}"] = r
        result[f"f1@{t}"] = f1
        f1s.append(f1)
    ts = np.asarray(iou_thresholds, np.float64)
    result["wF1"] = float(np.sum(ts * np.asarray(f1s)) / np.sum(ts))
    return result


def evaluate_text_detection(
    predictions: Sequence[Dict],  # per image: boxes [N,4] xyxy, scores [N]
    ground_truth: Sequence[Dict],  # per image: boxes [M,4], ignore [M] bool opt
    iou_thresh: float = 0.5,
    area_precision_thresh: float = 0.5,
    score_thresholds: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
) -> Dict[str, float]:
    """FUNSD text-detection eval (ICDAR-2015 DetEval over word boxes).

    Protocol of dit/text_detection/ditod/funsd_evaluation.py
    (FUNSDEvaluator.evaluate) + concern/icdar2015_eval/detection/iou.py
    (DetectionIoUEvaluator): for each score threshold s in 0.3..0.9,
    detections with score < s are dropped, box corners are rounded
    int(x + 0.5) (funsd_evaluation.py:92-95), then per image GT and
    detections match greedily in index order when IoU > 0.5 (one-to-one,
    iou.py:132-140); detections covering an ignore GT region with
    area-precision > 0.5 are discarded; global P/R/hmean aggregate the
    per-image counts (iou.py combine_results). Degenerate (zero-area)
    boxes are skipped like shapely's is_valid check skips them.

    Returns {'0.3_precision', '0.3_recall', '0.3_hmean', ..., 'best_hmean'}.
    """
    assert len(predictions) == len(ground_truth)
    result: Dict[str, float] = {}
    best = 0.0
    for s in score_thresholds:
        matched_sum, care_gt, care_det = 0, 0, 0
        for pred, gt in zip(predictions, ground_truth):
            gboxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
            gignore = np.asarray(
                gt.get("ignore", np.zeros(len(gboxes), bool)), bool)
            gvalid = (gboxes[:, 2] > gboxes[:, 0]) & (gboxes[:, 3] > gboxes[:, 1])
            gboxes, gignore = gboxes[gvalid], gignore[gvalid]

            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            scores = np.asarray(pred["scores"], np.float64).reshape(-1)
            boxes = boxes[scores >= s]
            boxes = np.floor(boxes + 0.5)  # int(x + 0.5) corner rounding
            x0 = np.minimum(boxes[:, 0], boxes[:, 2])
            x1 = np.maximum(boxes[:, 0], boxes[:, 2])
            y0 = np.minimum(boxes[:, 1], boxes[:, 3])
            y1 = np.maximum(boxes[:, 1], boxes[:, 3])
            boxes = np.stack([x0, y0, x1, y1], -1)
            boxes = boxes[(boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])]

            # detections matching an ignore GT at area-precision > 0.5
            det_ignore = np.zeros(len(boxes), bool)
            ign_boxes = gboxes[gignore]
            if len(ign_boxes) and len(boxes):
                ix = np.maximum(0.0, np.minimum(boxes[:, None, 2], ign_boxes[None, :, 2])
                                - np.maximum(boxes[:, None, 0], ign_boxes[None, :, 0]))
                iy = np.maximum(0.0, np.minimum(boxes[:, None, 3], ign_boxes[None, :, 3])
                                - np.maximum(boxes[:, None, 1], ign_boxes[None, :, 1]))
                inter = ix * iy
                det_area = np.maximum(
                    (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-9)
                det_ignore = np.any(inter / det_area[:, None]
                                    > area_precision_thresh, axis=1)

            iou = box_iou_np(gboxes, boxes)
            g_taken = np.zeros(len(gboxes), bool)
            d_taken = np.zeros(len(boxes), bool)
            m = 0
            for gi in range(len(gboxes)):
                if gignore[gi]:
                    continue
                for di in range(len(boxes)):
                    if (not g_taken[gi] and not d_taken[di]
                            and not det_ignore[di] and iou[gi, di] > iou_thresh):
                        g_taken[gi] = True
                        d_taken[di] = True
                        m += 1
            matched_sum += m
            care_gt += int(np.sum(~gignore))
            care_det += int(np.sum(~det_ignore))
        p = matched_sum / care_det if care_det else 0.0
        r = matched_sum / care_gt if care_gt else 0.0
        h = 2 * p * r / (p + r) if (p + r) else 0.0
        result[f"{s:.1f}_precision"] = p
        result[f"{s:.1f}_recall"] = r
        result[f"{s:.1f}_hmean"] = h
        best = max(best, h)
    result["best_hmean"] = best
    return result
