"""LayoutLM v1: BERT with additive 2-D position embeddings (port of
unilm_tpu/models/layoutlm.py: `LayoutLMConfig` :21, `LayoutLMModel` :45,
`LayoutLMForTokenClassification` :89).

The word, 1-D position, x0/y0/x1/y1 corner, height, width and token type
embeddings are all added (v1; LayoutLMv2 and v3 concatenate the spatial
ones), then a LayerNorm and the post-LN BERT `Encoder` with the
key-padding mask. On the card the mask sends every layer's attention to
the doc attention kernels (#9 forward, #10 backward).

Dtypes follow flax's promotion in the JAX model: the embeddings and their
LayerNorm are float32, the encoder computes in `cfg.dtype`, the
classifier in float32. Parameter names mirror the flax tree, so a JAX
checkpoint loads with `convert.from_jax.load_flax_params`; HF checkpoints
go through `convert.docai.convert_layoutlm`. In training (`model.train()`
with a dropout rate) the masks come from the `generator=` the caller
passes, at the JAX sites (:82, the encoder, :98).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import (dropout, head_dense, init_weights_,
                                         training_rng)
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.layoutlmv3 import embed_table, float32_norm


@dataclasses.dataclass(frozen=True)
class LayoutLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    max_2d_positions: int = 1024
    type_vocab_size: int = 2
    num_labels: int = 2
    layernorm_eps: float = 1e-12
    dropout: float = 0.0
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=False, layernorm_eps=self.layernorm_eps,
            dropout=self.dropout, dtype=self.dtype, use_flash=self.use_flash)


class LayoutLMModel(nn.Module):
    """Embeddings and the post-LN encoder: hidden states [B, L, E]."""

    def __init__(self, cfg: LayoutLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, n2d = cfg.hidden_size, cfg.max_2d_positions
        self.word_embeddings = embed_table(cfg.vocab_size, E, device)
        self.position_embeddings = embed_table(cfg.max_positions, E, device)
        self.x_position_embeddings = embed_table(n2d, E, device)
        self.y_position_embeddings = embed_table(n2d, E, device)
        self.h_position_embeddings = embed_table(n2d, E, device)
        self.w_position_embeddings = embed_table(n2d, E, device)
        self.token_type_embeddings = embed_table(cfg.type_vocab_size, E,
                                                 device)
        self.emb_LayerNorm = float32_norm(cfg, device)
        self.encoder = Encoder(cfg.transformer(), device=device)

    def forward(self, input_ids: torch.Tensor,  # [B, L]
                bbox: torch.Tensor,  # [B, L, 4] in 0..1000
                attention_mask: Optional[torch.Tensor] = None,  # [B, L] 1=valid
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        B, L = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        xe, ye = self.x_position_embeddings, self.y_position_embeddings
        top = cfg.max_2d_positions - 1
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings(torch.arange(L, device=dev))
        x = x + xe(bbox[..., 0]) + ye(bbox[..., 1])
        x = x + xe(bbox[..., 2]) + ye(bbox[..., 3])
        x = x + self.h_position_embeddings(
            torch.clamp(bbox[..., 3] - bbox[..., 1], 0, top))
        x = x + self.w_position_embeddings(
            torch.clamp(bbox[..., 2] - bbox[..., 0], 0, top))
        x = x + self.token_type_embeddings(token_type_ids)
        x = dropout(self.emb_LayerNorm(x), cfg.dropout,
                    training_rng(self, generator))
        return self.encoder(x, key_padding_mask=attention_mask.bool(),
                            generator=generator)


class LayoutLMForTokenClassification(nn.Module):
    """Float32 logits [B, L, num_labels] (FUNSD-style labelling)."""

    def __init__(self, cfg: LayoutLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layoutlm = LayoutLMModel(cfg, device=device)
        self.classifier = head_dense(cfg.hidden_size, cfg.num_labels,
                                     device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights at the flax initialisers' scales from
        `generator`: projections xavier-uniform, embeddings normal(0.02),
        the classifier lecun-normal, norms ones/zeros."""
        init_weights_(self, generator)
        return self

    def forward(self, input_ids, bbox, attention_mask=None,
                token_type_ids=None, generator=None) -> torch.Tensor:
        seq = self.layoutlm(input_ids, bbox, attention_mask, token_type_ids,
                            generator)
        seq = dropout(seq, self.cfg.dropout, training_rng(self, generator))
        return self.classifier(seq)
