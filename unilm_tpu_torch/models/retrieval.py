"""Text retrieval / embedding models: E5 and SimLM (port of
unilm_tpu/models/retrieval.py: `TextEncoderConfig` :23, `BertStyleEncoder`
:47, `EmbeddingModel` :74, `info_nce_loss` :95, `CrossEncoderReranker`
:111).

A BERT-style post-LN encoder (word + position + token-type embeddings,
a float32 LayerNorm, the core `Encoder` under the key-padding mask), the
E5 bi-encoder that mean- or cls-pools it into L2-normalised embeddings,
the InfoNCE loss with in-batch negatives and the SimLM cross-encoder
reranker. On the card the mask sends every layer's attention to the doc
attention kernels (#9 forward, #10 backward), as LayoutLM's.

Dtypes follow flax's promotion in the JAX model: the embeddings and their
LayerNorm are float32, the encoder computes in `cfg.dtype`, the reranker's
score in float32. Module names are the flax tree's, so a JAX checkpoint
loads with `convert.from_jax.load_flax_params`. In training
(`model.train()` with a dropout rate) the masks come from `generator=`.
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
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """Defaults are the JAX registry's `e5_base` (BERT-base)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 2
    pooling: str = "mean"  # mean (E5) | cls (SimLM)
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


class BertStyleEncoder(nn.Module):
    """ids [B, L] -> hidden states [B, L, E]."""

    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.word_embeddings = embed_table(cfg.vocab_size, E, device)
        self.position_embeddings = embed_table(cfg.max_positions, E, device)
        self.token_type_embeddings = embed_table(cfg.type_vocab_size, E,
                                                 device)
        self.emb_LayerNorm = float32_norm(cfg, device)
        self.encoder = Encoder(cfg.transformer(), device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,  # 1 = valid
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings(torch.arange(L, device=dev))
        x = x + self.token_type_embeddings(token_type_ids)
        x = dropout(self.emb_LayerNorm(x), self.cfg.dropout,
                    training_rng(self, generator))
        return self.encoder(x, key_padding_mask=attention_mask.bool(),
                            generator=generator)


class EmbeddingModel(nn.Module):
    """E5 bi-encoder: pooled, L2-normalised sentence embeddings [B, E]."""

    def __init__(self, cfg: TextEncoderConfig, device="cuda"):
        super().__init__()
        if cfg.pooling not in ("mean", "cls"):
            raise ValueError(f"unknown pooling {cfg.pooling!r}")
        self.cfg = cfg
        self.encoder = BertStyleEncoder(cfg, device=resolve_device(device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "EmbeddingModel":
        """Random weights at the flax initialisers' scales from
        `generator`: projections xavier-uniform, embeddings normal(0.02),
        norms ones/zeros."""
        init_weights_(self, generator)
        return self

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        seq = self.encoder(input_ids, attention_mask, generator=generator)
        if self.cfg.pooling == "cls":
            pooled = seq[:, 0]
        else:  # masked mean (e5 average_pool)
            m = attention_mask.to(seq.dtype)[..., None]
            pooled = (seq * m).sum(1) / m.sum(1).clamp(min=1.0)
        return pooled / (torch.linalg.vector_norm(pooled, dim=-1,
                                                  keepdim=True) + 1e-6)


def info_nce_loss(q_emb: torch.Tensor, p_emb: torch.Tensor,
                  temperature: float = 0.01,
                  negatives_per_query: int = 0):
    """Contrastive loss with in-batch negatives (simlm / e5 training) of
    normalised queries [B, D] against passages [B*(1+neg), D], row i's
    positive at i*(1+neg): (loss, accuracy), each a 0-d float32 tensor."""
    logits = (q_emb @ p_emb.T).float() / temperature
    labels = torch.arange(q_emb.shape[0], device=q_emb.device) * (
        1 + negatives_per_query)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


class CrossEncoderReranker(nn.Module):
    """SimLM reranker: joint (query, passage) encoding -> cls -> a float32
    score [B]."""

    def __init__(self, cfg: TextEncoderConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.encoder = BertStyleEncoder(cfg, device=dev)
        self.score = head_dense(cfg.hidden_size, 1, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "CrossEncoderReranker":
        """As `EmbeddingModel.init_weights`; the score head lecun-normal."""
        init_weights_(self, generator)
        return self

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None) -> torch.Tensor:
        seq = self.encoder(input_ids, attention_mask, token_type_ids,
                           generator)
        return self.score(seq[:, 0])[..., 0]

