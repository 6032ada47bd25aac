"""XLM-T: multilingual NMT over the core encoder-decoder (port of
unilm_tpu/models/translation.py: `TranslationConfig` :35, `make_lang_tokens`
:57, `MultilingualTranslationModel` :64, `make_generate_fns` :119,
`xlmt_base` :136 and `xlmt_big` :140).

A pre-LN encoder-decoder with language-token conditioning (the source
starts with its language token, the decoder is primed with the target
language token), embeddings shared between both sides and tied to the
output projection, learned positions and the sqrt(d) embedding scale.
Generation follows the (prefill, step) protocol of runtime/generate.py
(the TrOCR one): `aux` = (encoder output, source padding mask).

The JAX config sets `use_flash=False` (:50), so JAX runs its XLA
attention everywhere; the port runs its plain attention, on the card
too, and launches no kernel on this model's path. The decoder's cache is
the core `Decoder`'s (the scanned JAX stack's leaves: pools, cache_index,
the cross K/V shared by a sentence's beams).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import PositionalEmbedding, TextEmbedding
from unilm_tpu_torch.core.layers import init_weights_
from unilm_tpu_torch.core.transformer import Decoder, Encoder
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TranslationConfig:
    vocab_size: int = 64000  # includes the language tokens
    embed_dim: int = 512
    num_layers: int = 6
    dec_layers: Optional[int] = None
    num_heads: int = 8
    ffn_dim: int = 2048
    max_positions: int = 1024
    dropout: float = 0.1
    pad_id: int = 1
    dtype: Any = torch.float32

    def tcfg(self, layers: int) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, num_heads=self.num_heads,
            ffn_dim=self.ffn_dim, num_layers=layers, dropout=self.dropout,
            normalize_before=True, dtype=self.dtype, use_flash=False)


def make_lang_tokens(langs: Sequence[str],
                     base_vocab_size: int) -> Dict[str, int]:
    """__lang__ token ids after the base vocabulary, in sorted order (the
    fairseq multilingual convention)."""
    return {lang: base_vocab_size + i for i, lang in enumerate(sorted(langs))}


def init_seq2seq_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the flax initialisers' scales: projections
    xavier-uniform, the shared embedding and the learned positions
    normal(embed_dim^-0.5), norms ones/zeros."""
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, PositionalEmbedding):
            m.init_weights(generator)


class MultilingualTranslationModel(nn.Module):
    """`forward(src_tokens, prev_tgt_tokens)` -> logits [B, T, V] in
    `cfg.dtype`; `encode`, `prefill` and `decode_step` for generation."""

    def __init__(self, cfg: TranslationConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E, dt = cfg.embed_dim, cfg.dtype
        self.embed = TextEmbedding(cfg.vocab_size, E, dt, device=dev)
        self.enc_pos = PositionalEmbedding(cfg.max_positions, E, dtype=dt,
                                           device=dev)
        self.dec_pos = PositionalEmbedding(cfg.max_positions, E, dtype=dt,
                                           device=dev)
        self.encoder = Encoder(cfg.tcfg(cfg.num_layers), device=dev)
        self.decoder = Decoder(cfg.tcfg(cfg.dec_layers or cfg.num_layers),
                               has_cross_attention=True, device=dev)
        self.scale = E ** 0.5

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "MultilingualTranslationModel":
        init_seq2seq_(self, generator)
        return self

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied output projection, in `cfg.dtype`."""
        return F.linear(x, self.embed.embed.weight.to(x.dtype))

    def encode(self, src_tokens: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """src_tokens [B, S], the source language token first: (encoder
        output [B, S, E], padding mask [B, S], True = valid)."""
        S = src_tokens.shape[1]
        x = (self.embed(src_tokens) * self.scale
             + self.enc_pos(torch.arange(S, device=src_tokens.device)))
        pad_mask = src_tokens != self.cfg.pad_id
        enc = self.encoder(x, key_padding_mask=pad_mask, generator=generator)
        return enc, pad_mask

    def _decode(self, prev_tokens, enc, enc_mask, mode, cache_size,
                positions=None, cache=None, generator=None):
        T = prev_tokens.shape[1]
        if positions is None:
            positions = torch.arange(T, device=prev_tokens.device)
        x = self.embed(prev_tokens) * self.scale + self.dec_pos(positions)
        out = self.decoder(x, mode=mode, cache_size=cache_size, cache=cache,
                           causal=True, encoder_out=enc,
                           encoder_padding_mask=enc_mask,
                           generator=generator)
        if mode == "train":
            return self.attend(out)
        out, dec = out
        return self.attend(out), {"decoder": dec}

    def forward(self, src_tokens: torch.Tensor, prev_tgt_tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward: prev_tgt_tokens start with the target
        language token."""
        enc, mask = self.encode(src_tokens, generator)
        return self._decode(prev_tgt_tokens, enc, mask, "train", 0,
                            generator=generator)

    @torch.no_grad()
    def prefill(self, prev_tokens: torch.Tensor, encoder_out: Tuple,
                cache_size: int):
        enc, mask = encoder_out
        return self._decode(prev_tokens, enc, mask, "prefill", cache_size)

    @torch.no_grad()
    def decode_step(self, prev_tokens: torch.Tensor, encoder_out: Tuple,
                    cache: Dict, cache_size: int):
        """One step at the cache's next position (the cross K/V come from
        the prefill; the mask from `encoder_out`, tiled to beams or not)."""
        enc, mask = encoder_out
        start = cache["decoder"]["cache_index"]
        pos = start + torch.arange(prev_tokens.shape[1],
                                   device=prev_tokens.device)
        return self._decode(prev_tokens, None, mask, "decode", cache_size,
                            positions=pos, cache=cache["decoder"])


def make_generate_fns(model: nn.Module, cache_size: int):
    """(prefill, step) closures for runtime.generate; aux = (enc,
    enc_mask) from `model.encode`. Serves XLM-T and DeltaLM alike."""

    def prefill(tokens, aux):
        return model.prefill(tokens, aux, cache_size)

    def step(tokens, cache, aux):
        return model.decode_step(tokens, aux, cache, cache_size)

    return prefill, step


def xlmt_base(**kw) -> TranslationConfig:
    return TranslationConfig(**kw)


def xlmt_big(**kw) -> TranslationConfig:
    kw.setdefault("embed_dim", 1024)
    kw.setdefault("num_heads", 16)
    kw.setdefault("ffn_dim", 4096)
    return TranslationConfig(**kw)
