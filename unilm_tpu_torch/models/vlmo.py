"""VLMo: vision-language pretraining with mixture-of-modality experts
(port of unilm_tpu/models/vlmo.py).

The modality experts are the multiway A/B experts of the shared core, so
VLMo is a thin task layer over `BEiT3Model`, named `vlmo` here as in the
JAX tree: image-text matching (ITM) on the pooled cls token, masked
language modelling over the text half, and contrastive retrieval (ITC),
which is `BEiT3ForRetrieval`.
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.core.layers import head_dense as head
from unilm_tpu_torch.models.beit3 import (BEiT3Config, BEiT3ForRetrieval,
                                          BEiT3Model, BEiT3Task, Pooler)

VLMoConfig = BEiT3Config
VLMoForRetrieval = BEiT3ForRetrieval  # ITC head


class VLMoForImageTextMatching(BEiT3Task):
    """The pooler over the joint encoding -> `itm_head`: two float32
    logits (match, no match)."""

    def __init__(self, cfg: BEiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.vlmo = BEiT3Model(cfg, device=device)
        self.pooler = Pooler(cfg.embed_dim, cfg.layernorm_eps, device=device)
        self.itm_head = head(cfg.embed_dim, 2, device=device)

    def forward(self, images, tokens, padding_mask=None) -> torch.Tensor:
        out, _ = self.vlmo(textual_tokens=tokens, visual_images=images,
                           text_padding_mask=padding_mask)
        return self.itm_head(self.pooler(out))


class VLMoForMaskedLM(BEiT3Task):
    """`mlm_head` (cfg.dtype) over the text tokens of a joint encoding,
    or of a text-only one when `images` is None."""

    def __init__(self, cfg: BEiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.vlmo = BEiT3Model(cfg, device=device)
        self.mlm_head = head(cfg.embed_dim, cfg.vocab_size, cfg.dtype,
                             device=device)

    def forward(self, images: Optional[torch.Tensor], tokens: torch.Tensor,
                padding_mask=None) -> torch.Tensor:
        out, split = self.vlmo(textual_tokens=tokens, visual_images=images,
                               text_padding_mask=padding_mask)
        return self.mlm_head(out[:, split:] if images is not None else out)
