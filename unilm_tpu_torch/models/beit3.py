"""BEiT-3: the multiway multimodal encoder and its task heads (port of
unilm_tpu/models/beit3.py: `BEiT3Config` :25, `BEiT3Model` :57, `Pooler`
:125, the heads :136-240, `captioning_attn_bias` :178 and the presets
:250-254).

Vision tokens come first and text second; the multiway split sits at the
vision length, so the vision tokens take the A experts and the text
tokens the B experts (a text-only call: all B). Each modality has its own
learned position table with fairseq's offset of 2. Images are NHWC.

The JAX modules create a modality's embeddings only when they are called
with it, so the classification head's tree has no text embeddings and no
head has a mask token. `BEiT3Model(vision=, text=, use_mask_token=)` says
which exist here, so that a state dict compares tensor for tensor.

Attention goes through ops/attention.py's dispatcher, the port's copy of
JAX's (unilm_tpu/ops/attention.py:139-195): a vision-only call (no mask;
captioning's [1, 1, T, T] uni-mask bias) takes the encoder kernel #3, a
call with a text padding mask the doc kernel #9.

Dtypes follow flax's promotion in the JAX modules: the embeddings and the
encoder compute in `cfg.dtype`, the captioning / MLM heads (flax
dtype=cfg.dtype) too; the pooler, the classification, retrieval, VQA,
NLVR2 and ITM heads (flax dtype=None over float32 params) in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import (PositionalEmbedding,
                                            TextEmbedding, VisionEmbedding)
from unilm_tpu_torch.core.layers import Norm, init_weights_
from unilm_tpu_torch.core.layers import head_dense as head
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.ops.attention import NEG_INF


@dataclasses.dataclass(frozen=True)
class BEiT3Config:
    vocab_size: int = 64010
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    img_size: int = 224
    patch_size: int = 16
    max_text_len: int = 512
    layernorm_eps: float = 1e-5
    subln: bool = True
    num_classes: int = 1000
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=True, subln=self.subln, multiway=True,
            layernorm_eps=self.layernorm_eps, dtype=self.dtype,
            use_flash=self.use_flash)

    @property
    def num_vision_tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2 + 1


def f32_norm(dim: int, eps: float, device=None) -> Norm:
    """A flax nn.LayerNorm left at dtype=None over float32 params: float32
    output."""
    return Norm(TransformerConfig(embed_dim=dim, layernorm_eps=eps),
                device=device, dtype=torch.float32)


class BEiT3Model(nn.Module):
    """The embeddings and the multiway encoder; `forward` returns (the
    encoder output [B, T, E], the split position)."""

    def __init__(self, cfg: BEiT3Config, vision: bool = True,
                 text: bool = True, use_mask_token: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.transformer()
        E = cfg.embed_dim
        if vision:
            self.vision_embed = VisionEmbedding(
                cfg.img_size, cfg.patch_size, E, use_cls_token=True,
                use_mask_token=use_mask_token, dtype=tcfg.dtype,
                device=device)
            self.vision_pos_embed = PositionalEmbedding(
                cfg.num_vision_tokens + 2, E, offset=2, dtype=tcfg.dtype,
                device=device)
        if text:
            self.text_embed = TextEmbedding(cfg.vocab_size, E, tcfg.dtype,
                                            device=device)
            self.text_pos_embed = PositionalEmbedding(
                cfg.max_text_len + 2, E, offset=2, dtype=tcfg.dtype,
                device=device)
        self.encoder = Encoder(tcfg, device=device)

    def forward(self, textual_tokens: Optional[torch.Tensor] = None,
                visual_images: Optional[torch.Tensor] = None,
                text_padding_mask: Optional[torch.Tensor] = None,
                vision_masked_position: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None):
        """textual_tokens [B, Lt]; visual_images [B, H, W, 3];
        text_padding_mask [B, Lt] bool, True = PAD; vision_masked_position
        [B, N] bool (needs use_mask_token); attn_bias [B|1, H|1, T, T]."""
        if textual_tokens is None and visual_images is None:
            raise ValueError("BEiT3Model needs text, images or both")
        parts, split = [], -1
        if visual_images is not None:
            if (vision_masked_position is not None
                    and not hasattr(self.vision_embed, "mask_token")):
                raise ValueError("vision_masked_position needs a model built "
                                 "with use_mask_token=True")
            v = self.vision_embed(visual_images, vision_masked_position)
            pos = torch.arange(v.shape[1], device=v.device)
            parts.append(v + self.vision_pos_embed(pos)[None])
            split = v.shape[1]
        if textual_tokens is not None:
            t = self.text_embed(textual_tokens)
            pos = torch.arange(t.shape[1], device=t.device)
            parts.append(t + self.text_pos_embed(pos)[None])
            split = max(split, 0)
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        key_padding = None
        if text_padding_mask is not None and textual_tokens is not None:
            valid = ~text_padding_mask.bool()
            if visual_images is not None:
                valid = torch.cat([valid.new_ones(x.shape[0], split), valid],
                                  dim=1)
            key_padding = valid
        out = self.encoder(x, key_padding_mask=key_padding,
                           attn_bias=attn_bias, multiway_split_mask=split)
        return out, split


@torch.no_grad()
def init_beit3(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights at the JAX initialisers' scales from `generator` (on
    the parameters' device): projections xavier-uniform times their
    deepnorm/subln factor, heads normal(fan_in^-0.5), the patch projection
    lecun-normal, the embeddings normal(embed_dim^-0.5), the cls / mask
    tokens normal(0.02), norms ones / zeros. Returns `model`."""
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, PositionalEmbedding):
            m.init_weights(generator)
        elif isinstance(m, VisionEmbedding):
            w = m.patch_embed.proj.weight
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
            m.patch_embed.proj.bias.zero_()
            for name in ("cls_token", "mask_token"):
                if hasattr(m, name):
                    getattr(m, name).normal_(0.0, 0.02, generator=generator)
    return model


class BEiT3Task(nn.Module):
    """A task model over BEiT3Model (the BEiT-3 heads, VLMo's)."""

    def init_weights(self, generator: torch.Generator):
        """Random weights (`init_beit3`); returns self."""
        return init_beit3(self, generator)


class Pooler(nn.Module):
    """cls-token pooler (beit3/modeling_utils.py Pooler): LN -> dense ->
    tanh, float32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.norm = f32_norm(dim, eps, device)
        self.dense = head(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(self.norm(x[:, 0])))


class BEiT3ForImageClassification(BEiT3Task):
    """Mean over the patch tokens -> fc_norm -> head: float32 logits."""

    def __init__(self, cfg: BEiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.beit3 = BEiT3Model(cfg, text=False, device=device)
        self.fc_norm = f32_norm(cfg.embed_dim, cfg.layernorm_eps, device)
        self.head = head(cfg.embed_dim, cfg.num_classes, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out, _ = self.beit3(visual_images=images)
        return self.head(self.fc_norm(out[:, 1:].mean(1)))


class BEiT3ForRetrieval(BEiT3Task):
    """Two towers over one encoder: the cls feature -> a projection head
    -> L2-normalised (float32). `forward` gives the similarity logits
    (the caller scales them by a temperature)."""

    def __init__(self, cfg: BEiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.beit3 = BEiT3Model(cfg, device=device)
        E = cfg.embed_dim
        self.vision_head = head(E, E, bias=False, device=device)
        self.language_head = head(E, E, bias=False, device=device)

    @staticmethod
    def _unit(x: torch.Tensor) -> torch.Tensor:
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        out, _ = self.beit3(visual_images=images)
        return self._unit(self.vision_head(out[:, 0]))

    def encode_text(self, tokens: torch.Tensor,
                    padding_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        out, _ = self.beit3(textual_tokens=tokens,
                            text_padding_mask=padding_mask)
        return self._unit(self.language_head(out[:, 0]))

    def forward(self, images, tokens, padding_mask=None) -> torch.Tensor:
        return self.encode_image(images) @ self.encode_text(
            tokens, padding_mask).T


def captioning_attn_bias(num_vision: int, num_text: int,
                         device=None) -> torch.Tensor:
    """BEiT-3's captioning uni-mask [1, 1, T, T] float32: vision attends
    vision; text attends vision and, causally, text."""
    T = num_vision + num_text
    allow = torch.zeros(T, T, dtype=torch.bool, device=device)
    allow[:, :num_vision] = True
    allow[num_vision:, num_vision:] = torch.ones(
        num_text, num_text, dtype=torch.bool, device=device).tril()
    return torch.where(allow, 0.0, NEG_INF)[None, None]


class BEiT3ForCaptioning(BEiT3Task):
    """Images and text under the uni-mask; `mlm_head` over the text
    tokens, in cfg.dtype."""

    def __init__(self, cfg: BEiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.beit3 = BEiT3Model(cfg, device=device)
        self.mlm_head = head(cfg.embed_dim, cfg.vocab_size, cfg.dtype,
                             device=device)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
        nv = self.cfg.num_vision_tokens
        bias = captioning_attn_bias(nv, tokens.shape[1], images.device)
        out, _ = self.beit3(textual_tokens=tokens, visual_images=images,
                            attn_bias=bias)
        return self.mlm_head(out[:, nv:])


class BEiT3ForVisualQuestionAnswering(BEiT3Task):
    """The pooler over the joint encoding -> a two-layer classifier
    (VQAv2's 3129 answers), float32."""

    def __init__(self, cfg: BEiT3Config, num_answers: int = 3129,
                 device=None):
        super().__init__()
        self.cfg = cfg
        E, eps = cfg.embed_dim, cfg.layernorm_eps
        self.beit3 = BEiT3Model(cfg, device=device)
        self.pooler = Pooler(E, eps, device=device)
        self.head_dense = head(E, 2 * E, device=device)
        self.head_norm = f32_norm(2 * E, eps, device)
        self.head_out = head(2 * E, num_answers, device=device)

    def forward(self, images, tokens, padding_mask=None) -> torch.Tensor:
        out, _ = self.beit3(textual_tokens=tokens, visual_images=images,
                            text_padding_mask=padding_mask)
        h = self.head_norm(self.head_dense(self.pooler(out)))
        return self.head_out(F.gelu(h, approximate="none"))


class BEiT3ForVisualReasoning(BEiT3Task):
    """NLVR2: two images and one sentence, two joint forwards of the one
    encoder, their cls features concatenated -> two classes, float32."""

    def __init__(self, cfg: BEiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.embed_dim
        self.beit3 = BEiT3Model(cfg, device=device)
        self.head_dense = head(2 * E, E, device=device)
        self.head_out = head(E, 2, device=device)

    def forward(self, image_a, image_b, tokens, padding_mask=None
                ) -> torch.Tensor:
        oa, _ = self.beit3(textual_tokens=tokens, visual_images=image_a,
                           text_padding_mask=padding_mask)
        ob, _ = self.beit3(textual_tokens=tokens, visual_images=image_b,
                           text_padding_mask=padding_mask)
        x = torch.cat([oa[:, 0], ob[:, 0]], dim=-1)
        return self.head_out(F.gelu(self.head_dense(x), approximate="none"))


def beit3_base(**kw) -> BEiT3Config:
    return BEiT3Config(**kw)


def beit3_large(**kw) -> BEiT3Config:
    return BEiT3Config(embed_dim=1024, num_layers=24, num_heads=16,
                       ffn_dim=4096, **kw)
