"""UniLM-style masked seq2seq: s2s-ft / unilm-v1 / LayoutReader (port of
unilm_tpu/models/unilm_s2s.py: `UniLMConfig` :27, `seq2seq_attn_bias`
:51, `UniLMForSeq2Seq` :63 with its train forward :97, `prefill` :108 and
`decode_step` :117).

One BERT-style post-LN transformer on the core `Decoder`: the source
attends bidirectionally, the target to the source and causally to
itself (a prefix LM). The train forward runs the Decoder with
`causal=False` and the float32 [1, 1, T, T] `seq2seq_attn_bias` holding
NEG_INF = -1e30 where a key is hidden; generation is a non-causal prefill
over the source, then causal cached decode steps.

On the card the train forward's attention takes the fused encoder
attention (#3) with the bias (cast to the compute dtype: -1e30 is a
finite bf16 value, and every row sees its source keys, so the online max
is finite and exp(-1e30 - max) is 0); the prefill takes #3 without a
bias, and a one-token decode step the run-decode kernel (#13).

Dtypes follow flax's promotion: the embeddings, their LayerNorm and the
LM head (dense, exact GELU, LayerNorm, the tied word embeddings) are
float32, the decoder computes in `cfg.dtype`. Module names are the flax
tree's (`load_flax_params`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import head_dense, init_weights_
from unilm_tpu_torch.core.transformer import Decoder
from unilm_tpu_torch.models.layoutlmv3 import embed_table, float32_norm
from unilm_tpu_torch.ops.attention import NEG_INF
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class UniLMConfig:
    """Defaults are the JAX registry's `unilm_seq2seq_base`."""
    vocab_size: int = 28996
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 6  # unilm uses segment ids 4 = src, 5 = tgt
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


def seq2seq_attn_bias(src_len: int, tgt_len: int,
                      device=None) -> torch.Tensor:
    """[1, 1, T, T] float32 additive bias: the source bidirectional, the
    target sees the source and itself causally (the UniLM seq2seq mask)."""
    T = src_len + tgt_len
    allow = torch.zeros(T, T, dtype=torch.bool, device=device)
    allow[:, :src_len] = True
    t = torch.arange(tgt_len, device=device)
    allow[src_len:, src_len:] = t[:, None] >= t[None, :]
    allow[:src_len, src_len:] = False
    zero = torch.zeros((), device=device)
    return torch.where(allow, zero, NEG_INF)[None, None]


class UniLMForSeq2Seq(nn.Module):
    """`forward(tokens, token_type_ids, src_len)` -> float32 logits
    [B, T, V]; `prefill` / `decode_step` return (logits, cache)."""

    def __init__(self, cfg: UniLMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E = cfg.hidden_size
        self.word_embeddings = embed_table(cfg.vocab_size, E, dev)
        self.position_embeddings = embed_table(cfg.max_positions, E, dev)
        self.token_type_embeddings = embed_table(cfg.type_vocab_size, E, dev)
        self.emb_LayerNorm = float32_norm(cfg, dev)
        self.decoder = Decoder(cfg.transformer(), device=dev)
        self.lm_dense = head_dense(E, E, device=dev)
        self.lm_norm = float32_norm(cfg, dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UniLMForSeq2Seq":
        """Random weights at the flax initialisers' scales from
        `generator`: projections xavier-uniform, embeddings normal(0.02),
        `lm_dense` lecun-normal, norms ones/zeros."""
        init_weights_(self, generator)
        return self

    def _embed(self, tokens, token_type_ids, positions):
        x = self.word_embeddings(tokens)
        x = x + self.position_embeddings(positions)
        x = x + self.token_type_embeddings(token_type_ids)
        return self.emb_LayerNorm(x)

    def lm_head(self, x: torch.Tensor) -> torch.Tensor:
        """BERT's transform + the tied decoder (cls.predictions), float32."""
        x = F.gelu(self.lm_dense(x.float()), approximate="none")
        return F.linear(self.lm_norm(x), self.word_embeddings.weight)

    def forward(self, tokens: torch.Tensor, token_type_ids: torch.Tensor,
                src_len: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward over [src ++ tgt] under the seq2seq mask."""
        T = tokens.shape[1]
        dev = tokens.device
        x = self._embed(tokens, token_type_ids, torch.arange(T, device=dev))
        bias = seq2seq_attn_bias(src_len, T - src_len, dev)
        x = self.decoder(x, attn_bias=bias, causal=False, generator=generator)
        return self.lm_head(x)

    @torch.no_grad()
    def prefill(self, src_tokens: torch.Tensor, token_type_ids: torch.Tensor,
                cache_size: int) -> Tuple[torch.Tensor, Dict]:
        """Bidirectional source encoding into a fresh cache: (logits
        [B, S, V], cache)."""
        S = src_tokens.shape[1]
        x = self._embed(src_tokens, token_type_ids,
                        torch.arange(S, device=src_tokens.device))
        x, dec = self.decoder(x, causal=False, mode="prefill",
                              cache_size=cache_size)
        return self.lm_head(x), {"decoder": dec}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, token_type_ids: torch.Tensor,
                    position: torch.Tensor, cache: Dict,
                    cache_size: int) -> Tuple[torch.Tensor, Dict]:
        """Causal steps at `position` [T] (or [B, T]): (logits [B, T, V],
        cache); the pools are written in place."""
        x = self._embed(tokens, token_type_ids, position)
        x, dec = self.decoder(x, causal=True, mode="decode",
                              cache_size=cache_size, cache=cache["decoder"])
        return self.lm_head(x), {"decoder": dec}


def make_generate_fns(model: UniLMForSeq2Seq, cache_size: int,
                      src_type: int = 4, tgt_type: int = 5):
    """(prefill, step) closures for runtime.generate: the prompt is the
    source (segment `src_type`), each generated token a target token
    (segment `tgt_type`) at the cache's next position."""

    def prefill(tokens, aux):
        return model.prefill(tokens, torch.full_like(tokens, src_type),
                             cache_size)

    def step(tokens, cache, aux):
        start = cache["decoder"]["cache_index"]
        pos = start + torch.arange(tokens.shape[1], device=tokens.device)
        return model.decode_step(tokens, torch.full_like(tokens, tgt_type),
                                 pos, cache, cache_size)

    return prefill, step

