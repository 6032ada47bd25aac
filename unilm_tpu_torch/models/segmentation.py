"""Semantic segmentation: UperNet over a BEiT backbone (port of
unilm_tpu/models/segmentation.py: `_resize` :21, `ConvBNReLU` :26, `PPM`
:37, `UperNetConfig` :57, `FCNAuxHead` :67, `BeitForSemanticSegmentation`
:80 and `segmentation_loss` :130).

The backbone emits four pyramid levels from intermediate blocks (4x
deconv, 2x deconv, identity, 2x max pool on blocks out_indices); UperNet
is a PPM over the top level, FPN fusion and a classifier, with an FCN
auxiliary head on the third level. NHWC activations, float32 after the
trunk (flax promotes a bf16 trunk to its float32 params). `ConvBNReLU` is
a bias-free conv, GroupNorm (32 groups, 1 where the width is no multiple
of 32; epsilon 1e-6) and ReLU, as JAX's. Modules carry the flax tree's
auto-generated names (`ConvBNReLU_{i}`, `Conv_0`, `GroupNorm_0`), so a
flax tree loads through convert/from_jax.py as it is.

`_resize` is jax.image.resize(..., "bilinear"). Every call here
upsamples (or keeps the size), where JAX's triangle kernel with its
weights renormalised at the border is bilinear interpolation with
half-pixel centres and the border sample clamped: F.interpolate's
`bilinear` with align_corners=False (tests/test_torch_segmentation.py
holds the two against each other at this model's factors).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import (ConvNHWC, ConvTransposeNHWC,
                                         GroupNormNHWC)
from unilm_tpu_torch.models.beit import BeitBackbone, BeitConfig, init_beit


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of NHWC x to hw (an upsampling or the same size)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 device=None):
        super().__init__()
        self.Conv_0 = ConvNHWC(in_ch, features, kernel, bias=False,
                               device=device)
        self.GroupNorm_0 = GroupNormNHWC(
            32 if features % 32 == 0 else 1, features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class PPM(nn.Module):
    """Pyramid pooling module (UperNet): average pools at `bins` (clamped
    to the map), a 1x1 ConvBNReLU each, upsampled and concatenated with
    the input, then a 3x3 ConvBNReLU."""

    def __init__(self, in_ch: int, features: int,
                 bins: Sequence[int] = (1, 2, 3, 6), device=None):
        super().__init__()
        self.bins = tuple(bins)
        for i in range(len(self.bins)):
            self.add_module(f"ConvBNReLU_{i}",
                            ConvBNReLU(in_ch, features, 1, device=device))
        self.add_module(f"ConvBNReLU_{len(self.bins)}", ConvBNReLU(
            in_ch + len(self.bins) * features, features, 3, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        outs = [x]
        for i, b in enumerate(self.bins):
            b = min(b, H, W)  # small feature maps: clamp the bin count
            ph, pw = max(H // b, 1), max(W // b, 1)
            pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), (ph, pw),
                                  (ph, pw)).permute(0, 2, 3, 1)
            pooled = getattr(self, f"ConvBNReLU_{i}")(pooled)
            outs.append(_resize(pooled, (H, W)))
        return getattr(self, f"ConvBNReLU_{len(self.bins)}")(
            torch.cat(outs, -1))


@dataclasses.dataclass(frozen=True)
class UperNetConfig:
    beit: BeitConfig = BeitConfig(use_mean_pooling=False)
    out_indices: Tuple[int, ...] = (3, 5, 7, 11)
    channels: int = 512
    num_classes: int = 150  # ADE20K
    aux_channels: int = 256
    aux_loss_weight: float = 0.4  # FCN aux head (UperNet configs)


class FCNAuxHead(nn.Module):
    """The auxiliary FCN head on an intermediate level (weight 0.4 in the
    reference UperNet configs)."""

    def __init__(self, in_ch: int, channels: int, num_classes: int,
                 device=None):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(in_ch, channels, 3, device=device)
        self.classifier = ConvNHWC(channels, num_classes, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.ConvBNReLU_0(x))


class BeitForSemanticSegmentation(nn.Module):
    """Images [B, H, W, 3] -> logits [B, H, W, num_classes] float32 (and
    the aux head's logits with return_aux)."""

    def __init__(self, cfg: UperNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, C = cfg.beit.embed_dim, cfg.channels
        self.backbone = BeitBackbone(cfg.beit, device=device)
        self.up4 = ConvTransposeNHWC(E, E, 4, device=device)
        self.up2 = ConvTransposeNHWC(E, E, 2, device=device)
        for i in range(3):  # laterals
            self.add_module(f"ConvBNReLU_{i}", ConvBNReLU(E, C, 1,
                                                          device=device))
        self.ppm = PPM(E, C, device=device)
        for i in range(3, 6):  # the fused levels' outputs
            self.add_module(f"ConvBNReLU_{i}", ConvBNReLU(C, C, 3,
                                                          device=device))
        self.fpn_bottleneck = ConvBNReLU(4 * C, C, 3, device=device)
        self.classifier = ConvNHWC(C, cfg.num_classes, 1, device=device)
        self.aux_head = FCNAuxHead(E, cfg.aux_channels, cfg.num_classes,
                                   device=device)

    def init_weights(self, generator: torch.Generator
                     ) -> "BeitForSemanticSegmentation":
        """Random weights from `generator`: the trunk as `init_beit`, the
        convolutions at flax's lecun-normal scale, GroupNorms at identity."""
        init_beit(self, self.cfg.beit, generator)
        return self

    def forward(self, images: torch.Tensor, return_aux: bool = False,
                generator=None):
        cfg = self.cfg
        bcfg = cfg.beit
        _, hiddens = self.backbone(images, return_all_hiddens=True,
                                   generator=generator)
        g = bcfg.img_size // bcfg.patch_size
        B = images.shape[0]
        feats = [hiddens[i][:, 1:].reshape(B, g, g, bcfg.embed_dim).float()
                 for i in cfg.out_indices]
        # multi-scale: 4x up / 2x up / identity / 2x down
        feats[0] = self.up4(feats[0])
        feats[1] = self.up2(feats[1])
        feats[3] = F.max_pool2d(feats[3].permute(0, 3, 1, 2), 2,
                                2).permute(0, 2, 3, 1)
        laterals = [getattr(self, f"ConvBNReLU_{i}")(f)
                    for i, f in enumerate(feats[:-1])]
        laterals.append(self.ppm(feats[-1]))
        # top-down FPN fusion
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize(
                laterals[i], laterals[i - 1].shape[1:3])
        outs = [getattr(self, f"ConvBNReLU_{3 + i}")(l)
                for i, l in enumerate(laterals[:-1])] + [laterals[-1]]
        size = outs[0].shape[1:3]
        fused = torch.cat([_resize(o, size) for o in outs], -1)
        fused = self.fpn_bottleneck(fused)
        logits = _resize(self.classifier(fused), images.shape[1:3])
        if not return_aux:
            return logits
        aux = self.aux_head(feats[2])
        return logits, _resize(aux, images.shape[1:3])


def segmentation_loss(logits: torch.Tensor,  # [B, H, W, C]
                      labels: torch.Tensor,  # [B, H, W] int
                      aux_logits=None, *, aux_weight: float = 0.4,
                      ignore_index: int = 255):
    """Pixel CE (+ weighted aux CE) over the pixels whose label is not
    `ignore_index` (the mmseg decode head + FCN aux loss)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    validf = valid.to(torch.float32)

    def ce(lg):
        logp = F.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return (nll * validf).sum() / torch.clamp(validf.sum(), min=1.0)

    loss = ce(logits)
    metrics = {"seg_loss": loss}
    if aux_logits is not None:
        aux = ce(aux_logits)
        metrics["aux_loss"] = aux
        loss = loss + aux_weight * aux
    return loss, metrics
