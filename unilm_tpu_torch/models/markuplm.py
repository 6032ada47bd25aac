"""MarkupLM: an XPath-aware RoBERTa for web pages (port of
unilm_tpu/models/markuplm.py: `MarkupLMConfig` :23, `XPathEmbeddings` :53,
`MarkupLMModel` :75, `MarkupLMForTokenClassification` :121,
`MarkupLMForQuestionAnswering` :135).

Each token's XPath is `max_depth` (tag, subscript) unit ids: their
embeddings are summed per depth, concatenated, and projected through an
inner FFN (ReLU) to the hidden size, then added to the word, fairseq
position and token type embeddings. A LayerNorm and the post-LN
`Encoder` with the key-padding mask follow; on the card the mask sends
every layer's attention to the doc attention kernels (#9 forward, #10
backward).

Dtypes follow flax's promotion in the JAX model: the embeddings, the XPath
FFN and the embedding LayerNorm are float32, the encoder computes in
`cfg.dtype`, the heads in float32. Parameter names mirror the flax tree
(`tag_emb_{i}`, `subs_emb_{i}`), so a JAX checkpoint loads with
`convert.from_jax.load_flax_params`; HF checkpoints go through
`convert.docai.convert_markuplm`. In training the dropout masks come from
the caller's `generator=`, at the JAX sites (:71, :114, the encoder,
:131).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import (dropout, head_dense, init_weights_,
                                         training_rng)
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.layoutlmv3 import (create_position_ids,
                                               embed_table, float32_norm)


@dataclasses.dataclass(frozen=True)
class MarkupLMConfig:
    vocab_size: int = 50267
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1
    type_vocab_size: int = 2
    max_depth: int = 50
    max_xpath_tag_units: int = 256
    max_xpath_subs_units: int = 1024
    xpath_unit_hidden: int = 32
    tag_pad_id: int = 216
    subs_pad_id: int = 1001
    num_labels: int = 2
    layernorm_eps: float = 1e-5
    dropout: float = 0.0
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=False, layernorm_eps=self.layernorm_eps,
            dropout=self.dropout, dtype=self.dtype, use_flash=self.use_flash)


class XPathEmbeddings(nn.Module):
    """Per-depth tag + subscript unit embeddings -> inner FFN -> hidden."""

    def __init__(self, cfg: MarkupLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        U = cfg.xpath_unit_hidden
        for i in range(cfg.max_depth):
            for name, n in ((f"tag_emb_{i}", cfg.max_xpath_tag_units),
                            (f"subs_emb_{i}", cfg.max_xpath_subs_units)):
                emb = nn.Embedding(n, U, device=device)
                emb.init_std = U ** -0.5  # flax's default Embed init
                self.add_module(name, emb)
        self.xpath_unitseq2_inner = head_dense(cfg.max_depth * U,
                                               4 * cfg.hidden_size,
                                               device=device)
        self.inner2emb = head_dense(4 * cfg.hidden_size, cfg.hidden_size,
                                    device=device)

    def forward(self, xpath_tags_seq: torch.Tensor,  # [B, L, depth]
                xpath_subs_seq: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        units = [getattr(self, f"tag_emb_{i}")(xpath_tags_seq[..., i])
                 + getattr(self, f"subs_emb_{i}")(xpath_subs_seq[..., i])
                 for i in range(self.cfg.max_depth)]
        x = F.relu(self.xpath_unitseq2_inner(torch.cat(units, dim=-1)))
        return self.inner2emb(dropout(x, self.cfg.dropout, rng))


class MarkupLMModel(nn.Module):
    """Embeddings and the post-LN encoder: hidden states [B, L, E]."""

    def __init__(self, cfg: MarkupLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.word_embeddings = embed_table(cfg.vocab_size, E, device)
        self.position_embeddings = embed_table(cfg.max_positions, E, device)
        self.token_type_embeddings = embed_table(cfg.type_vocab_size, E,
                                                 device)
        self.xpath_embeddings = XPathEmbeddings(cfg, device=device)
        self.emb_LayerNorm = float32_norm(cfg, device)
        self.encoder = Encoder(cfg.transformer(), device=device)

    def forward(self, input_ids: torch.Tensor,  # [B, L]
                xpath_tags_seq: Optional[torch.Tensor] = None,
                xpath_subs_seq: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,  # [B, L] 1=valid
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        rng = training_rng(self, generator)
        B, L = input_ids.shape
        dev = input_ids.device
        if xpath_tags_seq is None:
            xpath_tags_seq = torch.full((B, L, cfg.max_depth), cfg.tag_pad_id,
                                        dtype=torch.long, device=dev)
        if xpath_subs_seq is None:
            xpath_subs_seq = torch.full((B, L, cfg.max_depth),
                                        cfg.subs_pad_id, dtype=torch.long,
                                        device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(
                 create_position_ids(input_ids, cfg.pad_token_id))
             + self.token_type_embeddings(token_type_ids)
             + self.xpath_embeddings(xpath_tags_seq, xpath_subs_seq, rng))
        x = dropout(self.emb_LayerNorm(x), cfg.dropout, rng)
        return self.encoder(x, key_padding_mask=attention_mask.bool(),
                            generator=generator)


class _MarkupLMHead(nn.Module):
    def __init__(self, cfg: MarkupLMConfig, n_out: int, head: str,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.markuplm = MarkupLMModel(cfg, device=device)
        self.add_module(head, head_dense(cfg.hidden_size, n_out,
                                         device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights at the flax initialisers' scales from
        `generator`: projections xavier-uniform, the word, position and
        type embeddings normal(0.02), the XPath units normal(unit^-0.5),
        the XPath FFN and the head lecun-normal, norms ones/zeros."""
        init_weights_(self, generator)
        return self


class MarkupLMForTokenClassification(_MarkupLMHead):
    """Float32 logits [B, L, num_labels] (node labelling, SWDE)."""

    def __init__(self, cfg: MarkupLMConfig, device=None):
        super().__init__(cfg, cfg.num_labels, "classifier", device)

    def forward(self, input_ids, xpath_tags_seq=None, xpath_subs_seq=None,
                attention_mask=None, generator=None) -> torch.Tensor:
        seq = self.markuplm(input_ids, xpath_tags_seq, xpath_subs_seq,
                            attention_mask, generator=generator)
        seq = dropout(seq, self.cfg.dropout, training_rng(self, generator))
        return self.classifier(seq)


class MarkupLMForQuestionAnswering(_MarkupLMHead):
    """Extractive QA (WebSRC): float32 (start, end) logits [B, L] each."""

    def __init__(self, cfg: MarkupLMConfig, device=None):
        super().__init__(cfg, 2, "qa_outputs", device)

    def forward(self, input_ids, xpath_tags_seq=None, xpath_subs_seq=None,
                attention_mask=None, generator=None):
        seq = self.markuplm(input_ids, xpath_tags_seq, xpath_subs_seq,
                            attention_mask, generator=generator)
        logits = self.qa_outputs(seq)
        return logits[..., 0], logits[..., 1]
