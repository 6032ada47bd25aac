"""Detectron2 Cascade/Mask R-CNN checkpoints -> the port's `CascadeRCNN`
state_dict (port of unilm_tpu/convert/detection.py `convert_rcnn` :73).

The source is a detectron2 GeneralizedRCNN state dict of the published
DiT detection checkpoints (dit/object_detection: build_vit_fpn_backbone +
CascadeROIHeads, cascade_dit_base.yaml), under its "model" key:
  backbone.bottom_up.backbone.*   ditod/beit.py BEiT (blocks.i.attn.qkv +
                                  q_bias/v_bias, gamma_1/2) and its fpn1..
                                  fpn4 adapters
  backbone.fpn_lateral{2-5}, backbone.fpn_output{2-5}   detectron2 FPN
  proposal_generator.rpn_head.*   StandardRPNHead
  roi_heads.box_head.{k}.*        cascade FastRCNNConvFCHead fc1/fc2
  roi_heads.box_predictor.{k}.*   FastRCNNOutputLayers
  roi_heads.mask_head.*           MaskRCNNConvUpsampleHead

The port's convolutions are torch modules (core/layers.py `ConvNHWC`,
`ConvTransposeNHWC`), so their weights load as they are: no flip of the
transposed convolutions, no HWIO transpose. The trunk goes through
convert/beit.py `_from_timm`. The fpn1 BatchNorm's running statistics are
`FrozenBN`'s buffers. One permutation stays: the port's box head flattens
the pooled [R, 7, 7, C] in (h, w, c) order, as JAX's does, where torch
flattened [R, C, 7, 7] in (c, h, w) order, so fc1's input columns are
permuted (JAX :61-69).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from unilm_tpu_torch.convert.beit import _from_timm
from unilm_tpu_torch.convert.common import tensor
from unilm_tpu_torch.models.rcnn import RCNNConfig

VIT = "backbone.bottom_up.backbone."


def _copy(sd: Mapping, src: str, dst: str, out: Dict,
          names=("weight", "bias")) -> None:
    for n in names:
        out[f"{dst}.{n}"] = tensor(sd[f"{src}.{n}"])


def frozen_bn(sd: Mapping, src: str, dst: str, out: Dict) -> None:
    """BatchNorm2d -> FrozenBN: weight, bias and the running statistics."""
    _copy(sd, src, dst, out, ("weight", "bias", "running_mean", "running_var"))


def fc_on_pooled(sd: Mapping, src: str, dst: str, out: Dict, channels: int,
                 res: int) -> None:
    """The first FC after RoI pooling: its input columns from torch's
    (c, h, w) flatten order to the port's (h, w, c)."""
    w = tensor(sd[f"{src}.weight"])  # [out, C*res*res]
    out[f"{dst}.weight"] = (w.reshape(w.shape[0], channels, res, res)
                            .permute(0, 2, 3, 1).reshape(w.shape[0], -1)
                            .contiguous())
    out[f"{dst}.bias"] = tensor(sd[f"{src}.bias"])


def convert_rcnn(sd: Mapping, cfg: RCNNConfig) -> Dict[str, torch.Tensor]:
    """The state_dict of `CascadeRCNN(cfg)` from a detectron2 state dict
    (pass checkpoint["model"]; a whole checkpoint dict is unwrapped)."""
    if "model" in sd and not any("." in k for k in list(sd)[:4]):
        sd = sd["model"]
    sd = dict(sd)

    vit_sd = {k[len(VIT):]: v for k, v in sd.items()
              if k.startswith(VIT) and not k[len(VIT):].startswith("fpn")}
    out = {f"vit.{k}": v for k, v in _from_timm(vit_sd, cfg.beit).items()}
    _copy(sd, f"{VIT}fpn1.0", "vit.fpn1_deconv1", out)
    frozen_bn(sd, f"{VIT}fpn1.1", "vit.fpn1_bn", out)
    _copy(sd, f"{VIT}fpn1.3", "vit.fpn1_deconv2", out)
    _copy(sd, f"{VIT}fpn2.0", "vit.fpn2_deconv", out)

    for lvl in range(2, 6):
        _copy(sd, f"backbone.fpn_lateral{lvl}", f"fpn.fpn_lateral{lvl}", out)
        _copy(sd, f"backbone.fpn_output{lvl}", f"fpn.fpn_output{lvl}", out)
    for name in ("conv", "objectness_logits", "anchor_deltas"):
        _copy(sd, f"proposal_generator.rpn_head.{name}", f"rpn_head.{name}",
              out)

    for k in range(len(cfg.cascade_ious)):
        # StandardROIHeads (non-cascade) has unindexed box_head/box_predictor
        bh = (f"roi_heads.box_head.{k}" if f"roi_heads.box_head.{k}.fc1.weight"
              in sd else "roi_heads.box_head")
        bp = (f"roi_heads.box_predictor.{k}"
              if f"roi_heads.box_predictor.{k}.cls_score.weight" in sd
              else "roi_heads.box_predictor")
        fc_on_pooled(sd, f"{bh}.fc1", f"box_head_{k}.fc1", out,
                     cfg.fpn_channels, cfg.pooler_resolution)
        _copy(sd, f"{bh}.fc2", f"box_head_{k}.fc2", out)
        _copy(sd, f"{bp}.cls_score", f"box_predictor_{k}.cls_score", out)
        _copy(sd, f"{bp}.bbox_pred", f"box_predictor_{k}.bbox_pred", out)

    if cfg.mask_on and "roi_heads.mask_head.mask_fcn1.weight" in sd:
        for name in ("mask_fcn1", "mask_fcn2", "mask_fcn3", "mask_fcn4",
                     "deconv", "predictor"):
            _copy(sd, f"roi_heads.mask_head.{name}", f"mask_head.{name}", out)
    return out
