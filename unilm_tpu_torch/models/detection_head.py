"""The single-stage FCOS detection head, its losses and its decode, DiT /
LayoutLMv3 detection (port of unilm_tpu/models/detection_head.py:
`FCOSConfig` :35, `FCOSHead` :54, `FCOSDetector` :111, `level_locations`
:131, `fcos_targets` :158, `giou` :231, `sigmoid_focal_loss` :249,
`fcos_loss` :265, `_nms_keep` :300, `giou_iou_matrix` :320,
`decode_detections` :337 and the presets :381-408).

Static shapes, as in JAX: a dense [B, locations, max_boxes] assignment,
per-image top-k then class-aware NMS over a fixed K, [max_dets] outputs
with a validity mask. NHWC feature maps; the convolutions are torch
modules (core/layers.py), GroupNorm with flax's epsilon 1e-6.

`_nms_keep` is JAX's sequential loop (from j = 1, keep0 = scores > 0, the
entries pre-sorted) run as sweeps of its update over the whole [K, K]
conflict matrix until nothing changes: the loop's result is the update's
one fixed point, and t sweeps settle the first t entries (models/rcnn.py
`nms_keep` has the argument).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import ConvNHWC, GroupNormNHWC, init_weights_
from unilm_tpu_torch.models.beit import BeitConfig, init_beit
from unilm_tpu_torch.models.detection import (ViTDetBackboneConfig,
                                              ViTFPNBackbone)

INF = 1e9


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    backbone: ViTDetBackboneConfig = ViTDetBackboneConfig()
    num_classes: int = 5  # PubLayNet: text/title/list/table/figure
    levels: Tuple[str, ...] = ("p2", "p3", "p4", "p5")
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    # per-level regression ranges (max side distance in pixels)
    size_ranges: Tuple[Tuple[float, float], ...] = (
        (0.0, 64.0), (64.0, 128.0), (128.0, 256.0), (256.0, INF),
    )
    tower_convs: int = 4
    tower_channels: int = 256
    center_sample_radius: float = 1.5
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    prior_prob: float = 0.01  # cls bias init so initial loss is stable


class FCOSHead(nn.Module):
    """Shared conv towers (3x3 conv, GroupNorm(32), ReLU) + per-level
    outputs: class logits, 4 side distances exp(reg * scales[level]) *
    stride, centerness. NHWC; float32."""

    def __init__(self, cfg: FCOSConfig, in_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.tower_channels
        for i in range(cfg.tower_convs):
            c_in = in_channels if i == 0 else C
            for branch in ("cls", "reg"):
                self.add_module(f"{branch}_tower_{i}",
                                ConvNHWC(c_in, C, 3, device=device))
                self.add_module(f"{branch}_norm_{i}",
                                GroupNormNHWC(32, C, device=device))
        self.cls_pred = ConvNHWC(C, cfg.num_classes, 3, device=device)
        self.box_pred = ConvNHWC(C, 4, 3, device=device)
        self.ctr_pred = ConvNHWC(C, 1, 3, device=device)
        self.scales = nn.Parameter(torch.ones(len(cfg.levels), device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal kernels, zero biases, the
        class bias at the prior (-log((1 - p) / p)), scales ones."""
        init_weights_(self, generator)
        cfg = self.cfg
        self.cls_pred.bias.fill_(-math.log((1.0 - cfg.prior_prob)
                                           / cfg.prior_prob))
        self.scales.fill_(1.0)

    def _tower(self, branch: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.cfg.tower_convs):
            conv = getattr(self, f"{branch}_tower_{i}")
            x = F.relu(getattr(self, f"{branch}_norm_{i}")(conv(x)))
        return x

    def forward(self, feats: Dict[str, torch.Tensor]):
        cfg = self.cfg
        out = {}
        for li, name in enumerate(cfg.levels):
            x = feats[name]
            c = self._tower("cls", x)
            r = self._tower("reg", x)
            B, Hh, Ww, _ = x.shape
            logits = self.cls_pred(c).reshape(B, Hh * Ww, cfg.num_classes)
            reg = self.box_pred(r).reshape(B, Hh * Ww, 4)
            reg = torch.exp(reg * self.scales[li]) * cfg.strides[li]
            ctr = self.ctr_pred(r).reshape(B, Hh * Ww)
            out[name] = (logits, reg, ctr)
        return out


class FCOSDetector(nn.Module):
    """Backbone + head; returns flat per-location predictions ("logits"
    [B, L, C], "reg" [B, L, 4], "ctr" [B, L]) and the "locations"."""

    def __init__(self, cfg: FCOSConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.fpn = ViTFPNBackbone(cfg.backbone, device=device)
        self.head = FCOSHead(cfg, cfg.backbone.out_channels, device=device)

    def init_weights(self, generator: torch.Generator) -> "FCOSDetector":
        """Random weights from `generator`: the trunk as `init_beit`, the
        adapters and the head at flax's scales."""
        init_beit(self.fpn, self.cfg.backbone.beit, generator)
        self.head.init_weights(generator)
        return self

    def forward(self, images: torch.Tensor, generator=None):
        cfg = self.cfg
        per_level = self.head(self.fpn(images, generator))
        locs = level_locations(cfg, images.shape[1], images.device)
        cat = lambda i: torch.cat([per_level[n][i] for n in cfg.levels], 1)
        return {"logits": cat(0), "reg": cat(1), "ctr": cat(2),
                "locations": locs}


def level_locations(cfg: FCOSConfig, img_size: int, device=None):
    """Concatenated (x, y) centers [L, 2] plus level id / range / stride
    arrays [L]."""
    xs, lids, los, his, strides = [], [], [], [], []
    for li, stride in enumerate(cfg.strides):
        g = img_size // stride
        coords = (torch.arange(g, dtype=torch.float32, device=device)
                  + 0.5) * stride
        yy, xx = torch.meshgrid(coords, coords, indexing="ij")
        xs.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        n = g * g
        lo, hi = cfg.size_ranges[li]
        lids.append(torch.full((n,), li, dtype=torch.long, device=device))
        los.append(torch.full((n,), lo, dtype=torch.float32, device=device))
        his.append(torch.full((n,), hi, dtype=torch.float32, device=device))
        strides.append(torch.full((n,), float(stride), dtype=torch.float32,
                                  device=device))
    return {"xy": torch.cat(xs), "level": torch.cat(lids),
            "lo": torch.cat(los), "hi": torch.cat(his),
            "stride": torch.cat(strides)}


def fcos_targets(locations: Dict[str, torch.Tensor],
                 gt_boxes: torch.Tensor,   # [B, M, 4] xyxy pixels
                 gt_labels: torch.Tensor,  # [B, M] int (0..C-1)
                 gt_valid: torch.Tensor,   # [B, M] bool
                 *, center_radius: float = 1.5):
    """Dense assignment. Returns (cls_target [B, L] int, -1 = background;
    box_target [B, L, 4] ltrb distances; ctr_target [B, L])."""
    xy = locations["xy"]
    stride = locations["stride"]
    lo, hi = locations["lo"], locations["hi"]
    x, y = xy[:, 0][None, :, None], xy[:, 1][None, :, None]  # [1, L, 1]
    bx0 = gt_boxes[:, None, :, 0]  # [B, 1, M]
    by0 = gt_boxes[:, None, :, 1]
    bx1 = gt_boxes[:, None, :, 2]
    by1 = gt_boxes[:, None, :, 3]
    l, tp, r, b = x - bx0, y - by0, bx1 - x, by1 - y
    ltrb = torch.stack([l, tp, r, b], -1)  # [B, L, M, 4]
    inside = ltrb.amin(-1) > 0.0
    maxd = ltrb.amax(-1)
    in_range = (maxd >= lo[None, :, None]) & (maxd <= hi[None, :, None])
    # center sampling: within radius * stride of the box center
    cx = (bx0 + bx1) * 0.5
    cy = (by0 + by1) * 0.5
    rad = center_radius * stride[None, :, None]
    near = ((x - cx).abs() <= rad) & ((y - cy).abs() <= rad)
    ok = inside & in_range & near & gt_valid[:, None, :]
    area = ((bx1 - bx0) * (by1 - by0)).expand(ok.shape)
    cand = torch.where(ok, area, INF)
    best_val, best = cand.min(-1)  # [B, L]
    pos = best_val < INF

    def pick(a):
        return torch.gather(a.expand(ok.shape), 2, best[..., None])[..., 0]

    box_target = torch.stack([pick(l), pick(tp), pick(r), pick(b)], -1)
    cls_target = torch.where(pos, torch.gather(gt_labels.long(), 1, best), -1)
    lr = box_target[..., 0::2]
    tb = box_target[..., 1::2]
    ctr = torch.sqrt(torch.clamp(
        (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-6))
        * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-6)), 0.0, 1.0))
    ctr = torch.where(pos, ctr, 0.0)
    return cls_target, box_target, ctr


def _ltrb_to_xyxy(xy, ltrb):
    x, y = xy[..., 0], xy[..., 1]
    return torch.stack([x - ltrb[..., 0], y - ltrb[..., 1],
                        x + ltrb[..., 2], y + ltrb[..., 3]], -1)


def giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of xyxy boxes, elementwise over matching leading
    dims."""
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    bx0, by0, bx1, by1 = b.unbind(-1)
    ia = (torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0),
                      min=0.0)
          * torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0),
                        min=0.0))
    aa = torch.clamp(ax1 - ax0, min=0.0) * torch.clamp(ay1 - ay0, min=0.0)
    ab = torch.clamp(bx1 - bx0, min=0.0) * torch.clamp(by1 - by0, min=0.0)
    union = aa + ab - ia
    iou = ia / torch.clamp(union, min=1e-6)
    cw = torch.maximum(ax1, bx1) - torch.minimum(ax0, bx0)
    ch = torch.maximum(ay1, by1) - torch.minimum(ay0, by0)
    hull = torch.clamp(cw * ch, min=1e-6)
    return iou - (hull - union) / hull


def optax_sigmoid_ce(logits, labels):
    """optax.sigmoid_binary_cross_entropy's stable formula."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets_onehot, alpha, gamma):
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1.0 - p) * (1.0 - targets_onehot)
    a_t = alpha * targets_onehot + (1.0 - alpha) * (1.0 - targets_onehot)
    return a_t * ((1.0 - p_t) ** gamma) * ce


def fcos_loss(outputs: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_valid: torch.Tensor,
              cfg: FCOSConfig):
    """Returns (total_loss, metrics): focal class loss and BCE centerness
    over the positives' count, GIoU box loss weighted by the centerness
    targets."""
    locs = outputs["locations"]
    cls_t, box_t, ctr_t = fcos_targets(
        locs, gt_boxes, gt_labels, gt_valid,
        center_radius=cfg.center_sample_radius)
    logits = outputs["logits"].float()  # [B, L, C]
    reg = outputs["reg"].float()  # [B, L, 4]
    ctr = outputs["ctr"].float()  # [B, L]
    pos = cls_t >= 0
    posf = pos.to(torch.float32)
    npos = torch.clamp(posf.sum(), min=1.0)
    onehot = (F.one_hot(torch.where(pos, cls_t, 0), cfg.num_classes)
              .to(torch.float32) * posf[..., None])
    cls_loss = sigmoid_focal_loss(logits, onehot, cfg.focal_alpha,
                                  cfg.focal_gamma).sum() / npos
    pred_xyxy = _ltrb_to_xyxy(locs["xy"][None], reg)
    tgt_xyxy = _ltrb_to_xyxy(locs["xy"][None], box_t)
    g = giou(pred_xyxy, tgt_xyxy)
    wsum = torch.clamp(ctr_t.sum(), min=1e-6)
    box_loss = ((1.0 - g) * ctr_t * posf).sum() / wsum
    ctr_loss = (optax_sigmoid_ce(ctr, ctr_t) * posf).sum() / npos
    total = cls_loss + box_loss + ctr_loss
    return total, {"cls_loss": cls_loss, "box_loss": box_loss,
                   "ctr_loss": ctr_loss, "num_pos": npos}


def giou_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., K, 4] xyxy boxes."""
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    ix = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    iy = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = ix * iy

    def area(x):
        return (torch.clamp(x[..., 2] - x[..., 0], min=0.0)
                * torch.clamp(x[..., 3] - x[..., 1], min=0.0))

    return inter / torch.clamp(area(a) + area(b) - inter, min=1e-6)


def _nms_keep(boxes: torch.Tensor, scores: torch.Tensor,
              labels: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy class-aware NMS over [..., K] entries pre-sorted by score
    (descending): entry j is dropped when an earlier kept entry of its
    label overlaps it by more than `iou_thresh`; keep0 = scores > 0.
    Returns the keep mask."""
    K = boxes.shape[-2]
    ious = giou_iou_matrix(boxes)
    same = labels[..., :, None] == labels[..., None, :]
    tri = torch.ones(K, K, dtype=torch.bool, device=boxes.device).tril(-1)
    conflict = ((ious > iou_thresh) & same & tri).to(torch.float32)  # [j, i]
    keep0 = scores > 0.0
    keep = keep0
    while True:
        hit = (conflict @ keep.to(torch.float32)[..., None])[..., 0] > 0
        new = keep0 & ~hit
        if torch.equal(new, keep):
            return keep
        keep = new


def decode_detections(outputs: Dict[str, torch.Tensor], *,
                      score_thresh: float = 0.05, pre_nms_topk: int = 256,
                      nms_iou: float = 0.6, max_dets: int = 100,
                      img_size: float = None):
    """Static-shape decode: per image (boxes [max_dets, 4], scores,
    labels, valid), batched [B, ...]. Scores are sqrt(cls * centerness) as
    in FCOS inference; top-k ties keep JAX's order (the lower index)."""
    logits, reg, ctr = outputs["logits"], outputs["reg"], outputs["ctr"]
    xy = outputs["locations"]["xy"]
    B, L, C = logits.shape
    probs = torch.sqrt(torch.sigmoid(logits.float())
                       * torch.sigmoid(ctr.float())[..., None])
    flat = probs.reshape(B, L * C)
    k = min(pre_nms_topk, L * C)
    top_scores, top_idx = torch.sort(flat, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    loc_idx = torch.div(top_idx, C, rounding_mode="floor")
    lab_idx = top_idx % C
    boxes = _ltrb_to_xyxy(xy[None], reg)  # [B, L, 4]
    top_boxes = torch.gather(boxes, 1, loc_idx[..., None].expand(B, k, 4))
    if img_size is not None:
        top_boxes = torch.clamp(top_boxes, 0.0, img_size)
    top_scores = torch.where(top_scores >= score_thresh, top_scores, 0.0)
    keep = _nms_keep(top_boxes, top_scores, lab_idx, nms_iou)
    sc2 = torch.where(keep, top_scores, 0.0)
    sc3, order = torch.sort(sc2, dim=-1, descending=True, stable=True)
    sc3, order = sc3[:, :max_dets], order[:, :max_dets]
    return (torch.gather(top_boxes, 1, order[..., None].expand(B, -1, 4)),
            sc3, torch.gather(lab_idx, 1, order), sc3 > 0.0)


# --------------------------------------------------------------------------- #
# Presets (dit/object_detection configs, layoutlmv3 PubLayNet)
# --------------------------------------------------------------------------- #


def dit_base_detection(img_size: int = 224, num_classes: int = 5,
                       **kw) -> FCOSConfig:
    """DiT-B backbone detection (per-layer rel-pos bias)."""
    beit = BeitConfig(img_size=img_size, use_mean_pooling=False, **kw)
    return FCOSConfig(backbone=ViTDetBackboneConfig(beit=beit),
                      num_classes=num_classes)


def layoutlmv3_base_detection(img_size: int = 224, num_classes: int = 5,
                              **kw) -> FCOSConfig:
    """LayoutLMv3 PubLayNet detection: the visual encoder as a plain ViT
    (absolute positions, no rel-pos bias) into the same FPN; BEiT-B dims."""
    beit = BeitConfig(img_size=img_size, use_mean_pooling=False,
                      use_rel_pos_bias=False, use_abs_pos_emb=True, **kw)
    return FCOSConfig(backbone=ViTDetBackboneConfig(beit=beit),
                      num_classes=num_classes)
