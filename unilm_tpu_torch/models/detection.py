"""ViT-FPN detection backbone, DiT / LayoutLMv3 detection (port of
unilm_tpu/models/detection.py: `ViTDetBackboneConfig` :22,
`ViTFPNBackbone` :28).

A BEiT/ViT trunk emitting multi-scale NHWC feature maps from its final
tokens (deconv x4 / deconv x2 / identity / max pool) for the FCOS head
(models/detection_head.py). Two details of the JAX module differ from the
rcnn trunk's and are kept: `fpn1`'s activation is `jax.nn.gelu`'s default,
the tanh approximation, and its GroupNorm's epsilon is flax's 1e-6. The
adapters compute in float32 (flax promotes a bf16 trunk's tokens to its
float32 params).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import (ConvNHWC, ConvTransposeNHWC,
                                         GroupNormNHWC)
from unilm_tpu_torch.models.beit import BeitBackbone, BeitConfig


@dataclasses.dataclass(frozen=True)
class ViTDetBackboneConfig:
    beit: BeitConfig = BeitConfig(use_mean_pooling=False)
    out_channels: int = 256


class ViTFPNBackbone(nn.Module):
    """Images [B, H, W, 3] -> {p2 (4x), p3 (2x), p4 (1x), p5 (0.5x)} NHWC
    features of out_channels (ditod/backbone.py FPN ops)."""

    def __init__(self, cfg: ViTDetBackboneConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, C = cfg.beit.embed_dim, cfg.out_channels
        self.backbone = BeitBackbone(cfg.beit, device=device)
        self.fpn1_deconv1 = ConvTransposeNHWC(E, E // 2, 2, device=device)
        self.fpn1_norm = GroupNormNHWC(min(32, E // 2), E // 2, device=device)
        self.fpn1_deconv2 = ConvTransposeNHWC(E // 2, E // 4, 2, device=device)
        self.fpn2_deconv = ConvTransposeNHWC(E, E // 2, 2, device=device)
        for name, ch in (("p2", E // 4), ("p3", E // 2), ("p4", E), ("p5", E)):
            self.add_module(f"{name}_lateral", ConvNHWC(ch, C, 1, device=device))
            self.add_module(f"{name}_output", ConvNHWC(C, C, 3, device=device))

    def forward(self, images: torch.Tensor,
                generator=None) -> Dict[str, torch.Tensor]:
        bcfg = self.cfg.beit
        tokens = self.backbone(images, generator=generator)
        g = bcfg.img_size // bcfg.patch_size
        B = tokens.shape[0]
        x = tokens[:, 1:].reshape(B, g, g, bcfg.embed_dim).float()
        f1 = self.fpn1_deconv1(x)
        f1 = F.gelu(self.fpn1_norm(f1), approximate="tanh")
        f1 = self.fpn1_deconv2(f1)
        f2 = self.fpn2_deconv(x)
        f4 = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        out = {}
        for name, f in (("p2", f1), ("p3", f2), ("p4", x), ("p5", f4)):
            h = getattr(self, f"{name}_lateral")(f)
            out[name] = getattr(self, f"{name}_output")(h)
        return out
