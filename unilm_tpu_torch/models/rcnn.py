"""Cascade/Mask R-CNN over the ViT + FPN backbone, DiT / LayoutLMv3
detection (port of unilm_tpu/models/rcnn.py: the box ops :45-197, the
graph :206-577, the training loss :579-750 and the presets :751-769).

The JAX module's static shapes are kept: fixed pre- and post-NMS proposal
counts padded with dead boxes (score -inf, zero box), plain [R, 4] xyxy
boxes in image coordinates, activations NHWC as in flax. Convolutions are
torch modules over NHWC activations (core/layers.py `ConvNHWC`,
`ConvTransposeNHWC`), so a detectron2 state dict loads with torch's weight
layouts (convert/detection.py) and a flax tree through
convert/from_jax.py.

Where the port parts from the JAX code's mechanics, with the same result:
- `nms_keep`: JAX runs a `fori_loop` over the N score-sorted candidates.
  Greedy NMS over sorted candidates has exactly one fixed point of
  keep_i = keep0_i and not (some j < i: keep_j and sup_ji), and after t
  sweeps of that update over the whole [N, N] suppression matrix the
  first t entries are final; so the port sweeps until nothing changes
  (as many sweeps as the longest suppression chain, at most N + 1), a
  batched matrix product a sweep, and returns the same mask. `NMS_STATS`
  counts the calls and sweeps.
- `multilevel_roi_align`: JAX aligns every RoI on all four levels and
  selects by the level mask; the port aligns each RoI on its own level
  only (the other three terms of JAX's sum are exact zeros) and batches
  the images (flat indices offset by image).
- The per-image parts that JAX vmaps (proposals, matching, the
  post-processing) run batched; the heads see one flat [B*P, ...] batch,
  as in JAX. Ties in `top_k` keep JAX's order (a stable descending sort:
  the lower index first).
- `FrozenBN`'s statistics are buffers (detectron2's FrozenBatchNorm2d);
  JAX keeps them as params, which its optimizer updates in training.
- `rcnn_loss` draws the sampling noise of `_subsample` through
  `draw_noise` from the caller's `torch.Generator`; a test replays JAX's
  draws by replacing that one function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import (ConvNHWC, ConvTransposeNHWC,
                                         head_dense, init_weights_)
from unilm_tpu_torch.models.beit import BeitBackbone, BeitConfig, init_beit

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)
NEG_INF = float("-inf")

# calls and sweeps of `nms_keep` since the last reset (chip_smoke.py reads
# them around a path)
NMS_STATS = {"calls": 0, "sweeps": 0, "max_sweeps": 0}


def reset_nms_stats() -> None:
    NMS_STATS.update(calls=0, sweeps=0, max_sweeps=0)


# --------------------------------------------------------------------------- #
# Box utilities
# --------------------------------------------------------------------------- #


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights) -> torch.Tensor:
    """detectron2 Box2BoxTransform.apply_deltas: (dx, dy, dw, dh) on xyxy."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=_DEFAULT_SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3] / wh, max=_DEFAULT_SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def get_deltas(src: torch.Tensor, target: torch.Tensor,
               weights) -> torch.Tensor:
    """Inverse of apply_deltas (regression targets)."""
    wx, wy, ww, wh = weights
    sw = torch.clamp(src[..., 2] - src[..., 0], min=1e-4)
    sh = torch.clamp(src[..., 3] - src[..., 1], min=1e-4)
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = torch.clamp(target[..., 2] - target[..., 0], min=1e-4)
    th = torch.clamp(target[..., 3] - target[..., 1], min=1e-4)
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    return torch.stack([
        wx * (tcx - scx) / sw, wy * (tcy - scy) / sh,
        ww * torch.log(tw / sw), wh * torch.log(th / sh)], dim=-1)


def clip_boxes(boxes: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h, w = size
    return torch.stack([
        boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(
        area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-6)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the k largest in descending
    order, ties by the lower index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] for x [B, N, ...] and idx [B, K] -> [B, K, ...]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat.reshape(*flat.shape, *(1,) * (x.ndim - 2))
                       .expand(*flat.shape, *x.shape[2:]))
    return out.reshape(*idx.shape, *x.shape[2:])


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
             idx_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask over candidates in any order (boxes [..., N, 4],
    scores [..., N], one optional leading batch axis): a candidate is kept
    unless a kept candidate of higher score (ties: the lower index)
    overlaps it by more than `iou_thresh`; candidates with score -inf are
    dead. `idx_cat` (batched NMS) suppresses only within a category. The
    fixed-point sweeps of the module docstring; returns the JAX mask."""
    single = scores.ndim == 1
    if single:
        boxes, scores = boxes[None], scores[None]
        idx_cat = None if idx_cat is None else idx_cat[None]
    N = scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    b = take(boxes, order)
    iou = box_iou(b, b)
    if idx_cat is not None:
        c = torch.gather(idx_cat, 1, order)
        iou = torch.where(c[:, :, None] == c[:, None, :], iou, 0.0)
    # sup[j, i]: candidate j (earlier in the order) suppresses i
    later = torch.ones(N, N, dtype=torch.bool, device=scores.device).triu(1)
    sup = ((iou > iou_thresh) & later).to(torch.float32)
    keep0 = torch.gather(scores, 1, order) > NEG_INF
    keep, sweeps = keep0, 0
    while True:
        hit = torch.bmm(keep.to(torch.float32)[:, None, :], sup)[:, 0] > 0
        new = keep0 & ~hit
        sweeps += 1
        if torch.equal(new, keep):
            break
        keep = new
    NMS_STATS["calls"] += 1
    NMS_STATS["sweeps"] += sweeps
    NMS_STATS["max_sweeps"] = max(NMS_STATS["max_sweeps"], sweeps)
    out = torch.empty_like(keep).scatter_(1, order, keep)
    return out[0] if single else out


# --------------------------------------------------------------------------- #
# RoIAlign (torchvision semantics: aligned=True, fixed sampling ratio)
# --------------------------------------------------------------------------- #


def _roi_align_flat(flat: torch.Tensor, base: torch.Tensor, H: int, W: int,
                    boxes: torch.Tensor, stride: int, out_size: int,
                    sampling_ratio: int, aligned: bool) -> torch.Tensor:
    """RoIAlign of boxes [R, 4] on the [H, W] maps whose rows start at
    base [R] in flat [N, C] -> [R, out, out, C]: JAX's formula (the four
    corners gathered by flat index, samples with y < -1 or y > H, x < -1
    or x > W zeroed, the rest clamped), averaged over the S x S samples."""
    S = sampling_ratio
    off = 0.5 if aligned else 0.0
    scale = 1.0 / stride
    x1 = boxes[:, 0] * scale - off
    y1 = boxes[:, 1] * scale - off
    w = torch.clamp(boxes[:, 2] * scale - off - x1,
                    min=1e-6 if aligned else 1.0)
    h = torch.clamp(boxes[:, 3] * scale - off - y1,
                    min=1e-6 if aligned else 1.0)
    bin_w = w / out_size
    bin_h = h / out_size
    dev = boxes.device
    ii = torch.arange(out_size, dtype=torch.float32, device=dev)
    ss = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    grid = ii[None, :, None] + ss[None, None, :]
    y = y1[:, None, None] + grid * bin_h[:, None, None]  # [R, out, S]
    x = x1[:, None, None] + grid * bin_w[:, None, None]
    oob_y = (y < -1.0) | (y > H)
    oob_x = (x < -1.0) | (x > W)
    y = y.clamp(0.0, H - 1)
    x = x.clamp(0.0, W - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1i = torch.clamp(y0 + 1, max=H - 1)
    x1i = torch.clamp(x0 + 1, max=W - 1)
    rows = base[:, None, None, None, None]

    def g(yi, xi):  # [R, oy, Sy, ox, Sx, C]
        idx = rows + yi[:, :, :, None, None] * W + xi[:, None, None, :, :]
        return flat[idx]

    lx = (x - x0)[:, None, None, :, :, None]
    ly = (y - y0)[:, :, :, None, None, None]
    v = (g(y0, x0) * (1 - ly) * (1 - lx) + g(y0, x1i) * (1 - ly) * lx
         + g(y1i, x0) * ly * (1 - lx) + g(y1i, x1i) * ly * lx)
    dead = oob_y[:, :, :, None, None, None] | oob_x[:, None, None, :, :, None]
    v = torch.where(dead, 0.0, v)
    return v.mean(dim=(2, 4))


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, stride: int,
              out_size: int, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """feat [H, W, C]; boxes [R, 4] xyxy image coords -> [R, out, out, C]
    (torchvision.ops.roi_align; detectron2 ROIAlign(aligned=True))."""
    H, W, C = feat.shape
    base = torch.zeros(boxes.shape[0], dtype=torch.long, device=boxes.device)
    return _roi_align_flat(feat.reshape(H * W, C), base, H, W, boxes, stride,
                           out_size, sampling_ratio, aligned)


def roi_levels(boxes: torch.Tensor, canonical_size: float = 224.0,
               canonical_level: int = 4) -> torch.Tensor:
    """detectron2 ROIPooler's level: floor(4 + log2(sqrt(area) / 224)),
    clamped to [2, 5]."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    lvl = torch.floor(canonical_level + torch.log2(
        torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(2, 5).long()


def multilevel_roi_align(feats: Dict[str, torch.Tensor], boxes: torch.Tensor,
                         out_size: int, sampling_ratio: int = 2,
                         canonical_size: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """detectron2 ROIPooler over p2-p5: each RoI aligned on its own level.
    feats {p2..p5: [H, W, C]} with boxes [R, 4] -> [R, out, out, C], or
    batched feats [B, H, W, C] with boxes [B, P, 4] -> [B, P, out, out, C]."""
    single = boxes.ndim == 2
    if single:
        feats = {k: v[None] for k, v in feats.items()}
        boxes = boxes[None]
    B, P = boxes.shape[:2]
    flat_boxes = boxes.reshape(B * P, 4)
    lvl = roi_levels(flat_boxes, canonical_size, canonical_level)
    img = torch.arange(B, device=boxes.device).repeat_interleave(P)
    C = feats["p2"].shape[-1]
    out = flat_boxes.new_zeros(B * P, out_size, out_size, C,
                               dtype=feats["p2"].dtype)
    for k in range(2, 6):
        sel = torch.nonzero(lvl == k)[:, 0]
        if sel.numel() == 0:
            continue
        f = feats[f"p{k}"]
        H, W = f.shape[1:3]
        al = _roi_align_flat(f.reshape(B * H * W, C), img[sel] * (H * W),
                             H, W, flat_boxes[sel], 2 ** k, out_size,
                             sampling_ratio, True)
        out = out.index_put((sel,), al)
    out = out.reshape(B, P, out_size, out_size, C)
    return out[0] if single else out


# --------------------------------------------------------------------------- #
# Config
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    beit: BeitConfig = BeitConfig(
        use_abs_pos_emb=True, use_rel_pos_bias=False, use_mean_pooling=False)
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)  # blocks tapped (base)
    fpn_channels: int = 256
    num_classes: int = 5  # PubLayNet
    # RPN (Base-RCNN-FPN.yaml)
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)  # p2..p6
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_topk: int = 1000
    rpn_post_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    # ROI / cascade (cascade_dit_base.yaml: CascadeROIHeads, cls-agnostic)
    pooler_resolution: int = 7
    mask_pooler_resolution: int = 14
    sampling_ratio: int = 2
    cascade_ious: Tuple[float, ...] = (0.5, 0.6, 0.7)
    cascade_weights: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0))
    fc_dim: int = 1024
    # test-time
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_image: int = 100
    mask_on: bool = True
    # train-time
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    roi_batch_per_image: int = 512
    roi_positive_fraction: float = 0.25

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_ratios)

    @property
    def img_size(self) -> int:
        return self.beit.img_size


# --------------------------------------------------------------------------- #
# Backbone: intermediate-block taps + fpn1-4 adapters + top-down FPN
# --------------------------------------------------------------------------- #


class FrozenBN(nn.Module):
    """BatchNorm applied as an affine with its statistics:
    (x - running_mean) * rsqrt(running_var + eps) * weight + bias, eps
    1e-5 (detectron2's FrozenBatchNorm2d; the statistics are buffers, the
    flax tree's `mean` / `var`)."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias

    def init_params_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class DetectionViT(nn.Module):
    """ditod/beit.py BEiT.forward_features: taps the out_indices blocks
    (no final norm), then fpn1 (deconv, FrozenBN, exact GELU, deconv: 4x),
    fpn2 (deconv: 2x), fpn3 (identity), fpn4 (2x2 max pool: 0.5x); full
    embed_dim channels, strides 4/8/16/32, NHWC, float32 (the adapters
    promote a bf16 trunk's taps as flax does)."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.beit.embed_dim
        self.backbone = BeitBackbone(cfg.beit, final_norm=False, device=device)
        self.fpn1_deconv1 = ConvTransposeNHWC(E, E, 2, device=device)
        self.fpn1_bn = FrozenBN(E, device=device)
        self.fpn1_deconv2 = ConvTransposeNHWC(E, E, 2, device=device)
        self.fpn2_deconv = ConvTransposeNHWC(E, E, 2, device=device)

    def taps(self, images: torch.Tensor, generator=None) -> list:
        """The tapped blocks' patch tokens as [B, g, g, E] grids (the
        trunk's dtype)."""
        bcfg = self.cfg.beit
        _, hiddens = self.backbone(images, return_all_hiddens=True,
                                   generator=generator)
        g = bcfg.img_size // bcfg.patch_size
        B = images.shape[0]
        return [hiddens[i][:, 1:].reshape(B, g, g, bcfg.embed_dim)
                for i in self.cfg.out_indices]

    def forward(self, images: torch.Tensor,
                generator=None) -> Dict[str, torch.Tensor]:
        taps = [t.float() for t in self.taps(images, generator)]
        f1 = self.fpn1_deconv1(taps[0])
        f1 = F.gelu(self.fpn1_bn(f1), approximate="none")
        f1 = self.fpn1_deconv2(f1)
        f2 = self.fpn2_deconv(taps[1])
        f4 = F.max_pool2d(taps[3].permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return {"c2": f1, "c3": f2, "c4": taps[2], "c5": f4}


class FPN(nn.Module):
    """detectron2 FPN: 1x1 laterals, top-down nearest-2x sum, 3x3 outputs,
    p6 = stride-2 1x1 max pool of p5 (LastLevelMaxPool)."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        E, C = cfg.beit.embed_dim, cfg.fpn_channels
        for k in range(2, 6):
            self.add_module(f"fpn_lateral{k}", ConvNHWC(E, C, 1, device=device))
            self.add_module(f"fpn_output{k}", ConvNHWC(C, C, 3, device=device))

    def forward(self, c: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        lat = {k: getattr(self, f"fpn_lateral{k[1]}")(v) for k, v in c.items()}
        td = {"c5": lat["c5"]}
        for hi, lo in (("c5", "c4"), ("c4", "c3"), ("c3", "c2")):
            up = td[hi].repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            td[lo] = lat[lo] + up
        out = {f"p{k[1]}": getattr(self, f"fpn_output{k[1]}")(v)
               for k, v in td.items()}
        out["p6"] = out["p5"][:, ::2, ::2]
        return out


# --------------------------------------------------------------------------- #
# RPN
# --------------------------------------------------------------------------- #


def make_anchors(cfg: RCNNConfig, level: int, gh: int, gw: int) -> np.ndarray:
    """detectron2 DefaultAnchorGenerator (offset 0): [gh*gw*A, 4] xyxy."""
    size = cfg.anchor_sizes[level - 2]
    stride = 2 ** level
    base = []
    for r in cfg.anchor_ratios:
        area = size * size
        w = math.sqrt(area / r)
        h = w * r
        base.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    base = np.asarray(base, np.float32)  # [A, 4]
    shx = np.arange(gw, dtype=np.float32) * stride
    shy = np.arange(gh, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shx, shy)  # [gh, gw], x fastest
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def make_all_anchors(cfg: RCNNConfig,
                     feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Anchors for every pyramid level, sized from the actual feature maps
    [B, H, W, C]."""
    return {k: torch.from_numpy(make_anchors(cfg, int(k[1]), v.shape[1],
                                             v.shape[2])).to(v.device)
            for k, v in feats.items()}


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 1x1 anchor deltas (detectron2
    StandardRPNHead)."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        C, A = cfg.fpn_channels, cfg.num_anchors
        self.conv = ConvNHWC(C, C, 3, device=device)
        self.objectness_logits = ConvNHWC(C, A, 1, device=device)
        self.anchor_deltas = ConvNHWC(C, A * 4, 1, device=device)

    def forward(self, feats: Dict[str, torch.Tensor]):
        logits, deltas = {}, {}
        for k, v in feats.items():
            h = F.relu(self.conv(v))
            logits[k] = self.objectness_logits(h)
            deltas[k] = self.anchor_deltas(h)
        return logits, deltas


def rpn_proposals(cfg: RCNNConfig, logits: Dict[str, torch.Tensor],
                  deltas: Dict[str, torch.Tensor],
                  anchors: Dict[str, torch.Tensor],
                  img_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched over images (logits [B, H, W, A], deltas [B, H, W, 4A]). Per
    level: top pre_nms_topk; across levels: batched NMS (level = category)
    then top post_nms_topk (detectron2 find_top_rpn_proposals). Returns
    (boxes [B, P, 4], scores [B, P]); dead slots have score -inf and zero
    boxes."""
    cand_b, cand_s, cand_l = [], [], []
    for li, k in enumerate(sorted(logits.keys())):
        B = logits[k].shape[0]
        lg = logits[k].reshape(B, -1)
        dl = deltas[k].reshape(B, -1, 4)
        topk = min(cfg.rpn_pre_nms_topk, lg.shape[1])
        sc, idx = top_k(lg, topk)
        bx = apply_deltas(take(dl, idx), anchors[k][idx], (1.0, 1.0, 1.0, 1.0))
        bx = clip_boxes(bx, (img_size, img_size))
        # d2 drops degenerate boxes; their score is killed instead
        ok = (bx[..., 2] > bx[..., 0]) & (bx[..., 3] > bx[..., 1])
        sc = torch.where(ok, sc, NEG_INF)
        cand_b.append(bx)
        cand_s.append(sc)
        cand_l.append(torch.full((B, topk), li, dtype=torch.long,
                                 device=lg.device))
    boxes = torch.cat(cand_b, 1)
    scores = torch.cat(cand_s, 1)
    lvls = torch.cat(cand_l, 1)
    keep = nms_keep(boxes, scores.detach(), cfg.rpn_nms_thresh, idx_cat=lvls)
    scores = torch.where(keep, scores, NEG_INF)
    P = min(cfg.rpn_post_nms_topk, scores.shape[1])
    top_s, top_i = top_k(scores, P)
    top_b = take(boxes, top_i)
    top_b = torch.where(torch.isfinite(top_s)[..., None], top_b, 0.0)
    return top_b, top_s


# --------------------------------------------------------------------------- #
# ROI heads
# --------------------------------------------------------------------------- #


class BoxHead(nn.Module):
    """FastRCNNConvFCHead NUM_FC=2: the pooled [R, 7, 7, C] flattened in
    (h, w, c) order, as JAX's (convert/detection.py permutes detectron2's
    (c, h, w) fc1) -> fc1 -> fc2, ReLU after each."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        r = cfg.pooler_resolution
        self.fc1 = head_dense(r * r * cfg.fpn_channels, cfg.fc_dim,
                              device=device)
        self.fc2 = head_dense(cfg.fc_dim, cfg.fc_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return F.relu(self.fc2(h))


class BoxPredictor(nn.Module):
    """FastRCNNOutputLayers: cls (C+1, background last) + class-agnostic
    box deltas (4)."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        self.cls_score = head_dense(cfg.fc_dim, cfg.num_classes + 1,
                                    device=device)
        self.bbox_pred = head_dense(cfg.fc_dim, 4, device=device)

    def forward(self, h: torch.Tensor):
        return self.cls_score(h), self.bbox_pred(h)


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead NUM_CONV=4: 4x (3x3 conv + ReLU), 2x deconv
    + ReLU, 1x1 predictor with a channel per class; NHWC."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        C = cfg.fpn_channels
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", ConvNHWC(C, C, 3, device=device))
        self.deconv = ConvTransposeNHWC(C, C, 2, device=device)
        self.predictor = ConvNHWC(C, cfg.num_classes, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [R, 14, 14, C]
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class CascadeRCNN(nn.Module):
    """The GeneralizedRCNN graph. `forward(images)` is inference on a batch
    (NHWC images [B, H, W, 3]); `features`, `propose`, `pool` and
    `cascade_stage` are the sub-graphs the training loss composes."""

    def __init__(self, cfg: RCNNConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vit = DetectionViT(cfg, device=device)
        self.fpn = FPN(cfg, device=device)
        self.rpn_head = RPNHead(cfg, device=device)
        for i in range(len(cfg.cascade_ious)):
            self.add_module(f"box_head_{i}", BoxHead(cfg, device=device))
            self.add_module(f"box_predictor_{i}",
                            BoxPredictor(cfg, device=device))
        if cfg.mask_on:
            self.mask_head = MaskHead(cfg, device=device)

    def init_weights(self, generator: torch.Generator) -> "CascadeRCNN":
        """Random weights from `generator`: the trunk as `init_beit`, the
        convolutions and heads at flax's lecun-normal scale, zero biases,
        FrozenBN at identity."""
        with torch.no_grad():
            for name, child in self.named_children():
                if name == "vit":
                    init_beit(child, self.cfg.beit, generator)
                else:
                    init_weights_(child, generator)
        return self

    def features(self, images: torch.Tensor,
                 generator=None) -> Dict[str, torch.Tensor]:
        return self.fpn(self.vit(images, generator))

    def propose(self, feats):
        """The RPN head on every level, then the proposal math batched over
        the images: (boxes [B, P, 4], scores [B, P])."""
        logits, deltas = self.rpn_head(feats)
        anchors = make_all_anchors(self.cfg, feats)
        return rpn_proposals(self.cfg, logits, deltas, anchors,
                             self.cfg.img_size)

    def pool(self, feats, boxes: torch.Tensor, resolution: int):
        """Multilevel RoIAlign: feats {level: [B, H, W, C]} x boxes
        [B, P, 4] -> [B, P, res, res, C]."""
        roi_feats = {k: v for k, v in feats.items() if k != "p6"}
        return multilevel_roi_align(roi_feats, boxes, resolution,
                                    self.cfg.sampling_ratio)

    def cascade_stage(self, k: int, feats, boxes: torch.Tensor):
        """One cascade stage on boxes [B, P, 4] (or [P, 4] with unbatched
        feats): pooled -> head on one flat [B*P, ...] batch -> (cls,
        deltas, refined boxes)."""
        cfg = self.cfg
        single = boxes.ndim == 2
        if single:
            feats = {n: v[None] for n, v in feats.items()}
            boxes = boxes[None]
        B, P = boxes.shape[:2]
        pooled = self.pool(feats, boxes, cfg.pooler_resolution)
        h = getattr(self, f"box_head_{k}")(
            pooled.reshape(B * P, *pooled.shape[2:]))
        cls, dlt = getattr(self, f"box_predictor_{k}")(h)
        cls = cls.reshape(B, P, -1)
        dlt = dlt.reshape(B, P, 4)
        refined = apply_deltas(dlt, boxes, cfg.cascade_weights[k])
        refined = clip_boxes(refined, (cfg.img_size, cfg.img_size))
        if single:
            return cls[0], dlt[0], refined[0]
        return cls, dlt, refined

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inference: padded per-image detections (boxes [B, D, 4], scores
        [B, D], classes [B, D], valid [B, D], masks [B, D, 28, 28] with
        mask_on) and the proposals."""
        cfg = self.cfg
        feats = self.features(images)
        prop_boxes, prop_scores = self.propose(feats)
        out = {"proposals": prop_boxes, "proposal_scores": prop_scores}
        alive = torch.isfinite(prop_scores)  # [B, P]
        boxes = prop_boxes
        stage_scores = []
        for k in range(len(cfg.cascade_ious)):
            cls, _, boxes = self.cascade_stage(k, feats, boxes)
            stage_scores.append(torch.softmax(cls, dim=-1))
        # CascadeROIHeads test: the mean of the stages' class probabilities
        scores = sum(stage_scores) / len(stage_scores)  # [B, P, C+1]
        scores = torch.where(alive[..., None], scores[..., :-1], 0.0)
        b, s, c, v = self.postprocess(boxes, scores)
        out.update(boxes=b, scores=s, classes=c, valid=v)
        if cfg.mask_on:
            B, D = c.shape
            pooled = self.pool(feats, b, cfg.mask_pooler_resolution)
            m = self.mask_head(pooled.reshape(B * D, *pooled.shape[2:]))
            m = m.reshape(B, D, *m.shape[1:])  # [B, D, 28, 28, C]
            idx = c[:, :, None, None, None].expand(*m.shape[:-1], 1)
            out["masks"] = torch.sigmoid(torch.gather(m, -1, idx)[..., 0])
        return out

    def postprocess(self, boxes: torch.Tensor, scores: torch.Tensor):
        """Per-class score threshold + batched NMS + top detections
        (fast_rcnn_inference_single_image) over boxes [B, P, 4] (class
        agnostic) and scores [B, P, C]."""
        cfg = self.cfg
        B, P, C = scores.shape
        flat_scores = scores.reshape(B, -1)  # [B, P*C]
        flat_scores = torch.where(flat_scores > cfg.score_thresh,
                                  flat_scores, NEG_INF)
        flat_boxes = boxes.repeat_interleave(C, dim=1)
        flat_cls = torch.arange(C, device=scores.device).repeat(P)
        # cap the NMS candidates (static): top 4 * detections_per_image
        M = min(4 * cfg.detections_per_image, flat_scores.shape[1])
        top_s, top_i = top_k(flat_scores, M)
        top_b = take(flat_boxes, top_i)
        top_c = flat_cls[top_i]
        keep = nms_keep(top_b, top_s, cfg.nms_thresh, idx_cat=top_c)
        top_s = torch.where(keep, top_s, NEG_INF)
        D = min(cfg.detections_per_image, M)
        fin_s, fin_i = top_k(top_s, D)
        valid = torch.isfinite(fin_s)
        return (torch.where(valid[..., None], take(top_b, fin_i), 0.0),
                torch.where(valid, fin_s, 0.0),
                torch.gather(top_c, 1, fin_i), valid)


# --------------------------------------------------------------------------- #
# Training losses (detectron2 RPN losses + cascade per-stage reassignment)
# --------------------------------------------------------------------------- #


def _match(iou: torch.Tensor, thresholds: Tuple[float, float],
           allow_low_quality: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher over iou [..., N, G] (dead gt zeroed): labels 1
    (fg), 0 (bg), -1 (ignore); returns (matched_gt_idx [..., N], labels)."""
    lo, hi = thresholds
    best, idx = iou.max(dim=-1)
    labels = torch.where(best >= hi, 1, torch.where(best < lo, 0, -1))
    if allow_low_quality:
        # anchors that are the argmax for some gt become fg
        per_gt_best = iou.max(dim=-2, keepdim=True).values  # [..., 1, G]
        is_best = ((iou == per_gt_best) & (per_gt_best > 1e-5)).any(dim=-1)
        labels = torch.where(is_best, 1, labels)
    return idx, labels


def draw_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The uniform [0, 1) noise of one `_subsample` site ([B, N], one row an
    image) from `generator`: JAX draws it with jax.random.uniform from a
    split of the step's key. Every draw of `rcnn_loss` goes through here,
    in its order (the RPN's, then each stage's), so a test can replay
    JAX's draws."""
    return torch.rand(shape, generator=generator, device=generator.device
                      ).to(device)


def _subsample(labels: torch.Tensor, num: int, pos_frac: float,
               noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static subsample_labels over labels [B, N]: masks selecting <= num
    anchors with ~pos_frac positives; the random tie-break is `noise`
    [B, N] + top_k."""
    N = labels.shape[-1]
    n_pos = int(num * pos_frac)
    pos_key = torch.where(labels == 1, noise, -1.0)
    _, pos_i = top_k(pos_key, min(n_pos, N))
    pos_sel = (torch.zeros_like(labels, dtype=torch.bool)
               .scatter(1, pos_i, True) & (labels == 1))
    n_pos_actual = pos_sel.sum(dim=1, keepdim=True)
    neg_key = torch.where(labels == 0, noise, -1.0)
    k = min(num, N)
    _, neg_i = top_k(neg_key, k)
    ranks = torch.arange(k, device=labels.device).expand_as(neg_i)
    neg_rank = torch.zeros_like(labels).scatter(1, neg_i, ranks)
    neg_sel = (torch.zeros_like(labels, dtype=torch.bool)
               .scatter(1, neg_i, True) & (labels == 0)
               & (neg_rank < num - n_pos_actual))
    return pos_sel, neg_sel


def optax_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE, optax's formula."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def crop_gt_masks_for(gt_masks: torch.Tensor, gt_idx: torch.Tensor,
                      boxes: torch.Tensor, out: int) -> torch.Tensor:
    """For each roi r: gt_masks[gt_idx[r]] cropped to boxes[r] and resized
    to out x out (mask_rcnn's crop_and_resize on bitmasks: RoIAlign at
    stride 1, one sample a bin, > 0.5). gt_masks [B, G, H, W], gt_idx and
    boxes [B, R(, 4)] -> bool [B, R, out, out]; each roi reads its gt's
    mask in place (flat row offsets), no per-roi copy."""
    B, G, H, W = gt_masks.shape
    R = gt_idx.shape[1]
    flat = gt_masks.reshape(B * G * H * W, 1).to(torch.float32)
    which = (torch.arange(B, device=gt_idx.device)[:, None] * G
             + gt_idx).reshape(-1)
    al = _roi_align_flat(flat, which * (H * W), H, W, boxes.reshape(-1, 4),
                         1, out, 1, True)
    return al[..., 0].reshape(B, R, out, out) > 0.5


def rcnn_loss(model: CascadeRCNN, images: torch.Tensor,
              gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
              gt_valid: torch.Tensor, generator: torch.Generator,
              gt_masks: Optional[torch.Tensor] = None):
    """The training loss of one batch: gt_boxes [B, G, 4] xyxy (padded),
    gt_classes [B, G] int, gt_valid [B, G] bool, gt_masks [B, G, H, W]
    binary (optional); the sampling noise from `generator` (`draw_noise`).
    Returns (loss, metrics).

    detectron2's rpn.losses (objectness BCE + l1 on fg), CascadeROIHeads
    train branch (per-stage reassignment at the stage IoU, CE + class
    agnostic l1) and mask_rcnn_loss (BCE at 28x28 on fg), as JAX composes
    them: the stage-0 boxes are the proposals without a stop-gradient (the
    RPN's deltas get gradient through RoIAlign and the stage targets),
    later stages' boxes the previous stage's refined boxes detached."""
    cfg = model.cfg
    dev = images.device
    feats = model.features(images)
    logits, deltas = model.rpn_head(feats)
    anchors_d = make_all_anchors(cfg, feats)
    levels = sorted(anchors_d.keys())
    anchors = torch.cat([anchors_d[k].reshape(-1, 4) for k in levels])
    B = images.shape[0]
    flat_logits = torch.cat([logits[k].reshape(B, -1) for k in levels], 1)
    flat_deltas = torch.cat([deltas[k].reshape(B, -1, 4) for k in levels], 1)

    metrics = {}
    prop_boxes, _ = model.propose(feats)
    gtb_all = torch.where(gt_valid[..., None], gt_boxes, -1e4)  # [B, G, 4]

    # --- RPN losses ------------------------------------------------------
    iou = torch.where(gt_valid[:, None, :], box_iou(anchors[None], gtb_all),
                      0.0)
    m_idx, m_lab = _match(iou, (0.3, 0.7), allow_low_quality=True)
    noise = draw_noise(m_lab.shape, generator, dev)
    pos, neg = _subsample(m_lab, cfg.rpn_batch_per_image,
                          cfg.rpn_positive_fraction, noise)
    sel = pos | neg
    obj_l = torch.where(sel, optax_bce(flat_logits, pos.to(torch.float32)),
                        0.0).sum(1) / cfg.rpn_batch_per_image
    reg_t = get_deltas(anchors[None], take(gtb_all, m_idx), (1.0,) * 4)
    reg_l = torch.where(pos[..., None], (flat_deltas - reg_t).abs(),
                        0.0).sum((1, 2)) / cfg.rpn_batch_per_image
    total = obj_l.sum() + reg_l.sum()
    metrics["rpn_cls"] = obj_l.mean()
    metrics["rpn_reg"] = reg_l.mean()

    # --- cascade stages: d2 adds the gt boxes to the proposals -----------
    boxes = torch.cat([prop_boxes, gtb_all], 1)  # [B, R, 4]
    for k, iou_th in enumerate(cfg.cascade_ious):
        piou = torch.where(gt_valid[:, None, :], box_iou(boxes, gtb_all), 0.0)
        pidx, plab = _match(piou, (iou_th, iou_th), allow_low_quality=False)
        noise = draw_noise(plab.shape, generator, dev)
        ppos, pneg = _subsample(plab, cfg.roi_batch_per_image,
                                cfg.roi_positive_fraction, noise)
        psel = ppos | pneg
        cls_t = torch.where(ppos, torch.gather(gt_classes.long(), 1, pidx),
                            cfg.num_classes)
        cls, dlt, refined = model.cascade_stage(k, feats, boxes)
        logp = F.log_softmax(cls.float(), dim=-1)
        ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
        n_sel = psel.sum(1).clamp(min=1)
        ce = torch.where(psel, ce, 0.0).sum(1) / n_sel
        bt = get_deltas(boxes, take(gtb_all, pidx), cfg.cascade_weights[k])
        bl = torch.where(ppos[..., None], (dlt - bt).abs(),
                         0.0).sum((1, 2)) / n_sel
        total = total + ce.sum() + bl.sum()
        metrics[f"stage{k}_cls"] = ce.mean()
        metrics[f"stage{k}_reg"] = bl.mean()
        boxes = refined.detach()

    # --- mask loss ---------------------------------------------------------
    if cfg.mask_on and gt_masks is not None:
        R = boxes.shape[1]
        pooled = model.pool(feats, boxes, cfg.mask_pooler_resolution)
        mpred = model.mask_head(pooled.reshape(B * R, *pooled.shape[2:]))
        mpred = mpred.reshape(B, R, *mpred.shape[1:])
        mcls = cls_t.clamp(0, cfg.num_classes - 1)
        idx = mcls[:, :, None, None, None].expand(*mpred.shape[:-1], 1)
        mpred = torch.gather(mpred, -1, idx)[..., 0]
        tgt_m = crop_gt_masks_for(gt_masks, pidx, boxes,
                                  2 * cfg.mask_pooler_resolution)
        per_roi = optax_bce(mpred, tgt_m.to(mpred.dtype)).mean((2, 3))
        ml = (torch.where(ppos, per_roi, 0.0).sum(1)
              / ppos.sum(1).clamp(min=1))
        total = total + ml.sum()
        metrics["mask"] = ml.mean()

    return total / B, metrics


# --------------------------------------------------------------------------- #
# Presets
# --------------------------------------------------------------------------- #


def cascade_dit_base(img_size: int = 224, num_classes: int = 5,
                     **kw) -> RCNNConfig:
    """cascade_dit_base.yaml: dit_base_patch16, abs pos, CascadeROIHeads."""
    beit = BeitConfig(img_size=img_size, use_abs_pos_emb=True,
                      use_rel_pos_bias=False, use_shared_rel_pos_bias=False,
                      use_mean_pooling=False, init_values=0.1,
                      num_classes=0)
    return RCNNConfig(beit=beit, num_classes=num_classes,
                      out_indices=(3, 5, 7, 11), **kw)


def cascade_dit_large(img_size: int = 224, num_classes: int = 5,
                      **kw) -> RCNNConfig:
    beit = BeitConfig(img_size=img_size, embed_dim=1024, num_layers=24,
                      num_heads=16, ffn_dim=4096, use_abs_pos_emb=True,
                      use_rel_pos_bias=False, use_mean_pooling=False,
                      init_values=1e-5, num_classes=0)
    return RCNNConfig(beit=beit, num_classes=num_classes,
                      out_indices=(7, 11, 15, 23), **kw)
