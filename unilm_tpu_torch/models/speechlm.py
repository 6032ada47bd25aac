"""SpeechLM: joint speech-text pre-training with a shared encoder (port of
unilm_tpu/models/speechlm.py: `SpeechLMConfig` :33, `SpeechLM` :60 with
`encode_speech` / `encode_text` / its forward, `speechlm_pretrain_loss`
:126 and `speechlm_base` :146).

One pre-LN encoder takes either speech (WavLM's conv feature extractor,
a LayerNorm and projection, frames replaced by `mask_emb` where masked,
WavLM's positional conv) or phoneme / unit tokens (an embedding plus
learned positions), and is pre-trained by masked unit prediction on the
speech frames and masked LM on the text. Masking is static-shape: a
boolean mask selects `mask_emb` in place of a frame (a where, no
gather). The speech front end is float32 (flax defaults); the encoder
and both heads compute in `cfg.dtype`. On the card the encoder's
attention takes the fused encoder attention (#3; #4 in the backward).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, head_dense, init_weights_
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.wavlm import (ConvPositionalEmbedding,
                                          FeatureExtractor, WavLMConfig,
                                          layer_norm)
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpeechLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3)
    conv_stride: Tuple[int, ...] = (5, 2, 2)
    unit_vocab: int = 504  # speech units (HuBERT km500 + specials)
    text_vocab: int = 1000  # phoneme / character vocabulary
    max_text_positions: int = 1024
    dropout: float = 0.0
    dtype: Any = torch.float32
    use_flash: bool = True

    def enc_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=True, dropout=self.dropout,
            dtype=self.dtype, use_flash=self.use_flash)


class SpeechLM(nn.Module):
    """`forward(audio, mask_indices, text_tokens)` -> (unit logits
    [B, Ts, Vu], text logits [B, Tt, Vt]) in `cfg.dtype`."""

    def __init__(self, cfg: SpeechLMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E = cfg.hidden_size
        wcfg = WavLMConfig(hidden_size=E, conv_dim=cfg.conv_dim,
                           conv_kernel=cfg.conv_kernel,
                           conv_stride=cfg.conv_stride)
        self.feature_extractor = FeatureExtractor(wcfg, device=dev)
        self.feature_proj = head_dense(cfg.conv_dim[-1], E, device=dev)
        self.feature_norm = layer_norm(cfg.conv_dim[-1], 1e-6, dev)
        self.conv_pos = ConvPositionalEmbedding(wcfg, device=dev)
        self.mask_emb = nn.Parameter(torch.zeros(E, device=dev))
        self.text_embed = nn.Embedding(cfg.text_vocab, E, device=dev)
        self.text_pos = nn.Embedding(cfg.max_text_positions, E, device=dev)
        self.text_embed.init_std = self.text_pos.init_std = E ** -0.5
        self.encoder = Encoder(cfg.enc_cfg(), device=dev)
        head = lambda v: Dense(E, v, bias=True, dtype=cfg.dtype,
                               param_dtype=torch.float32, device=dev)
        self.unit_head = head(cfg.unit_vocab)
        self.text_head = head(cfg.text_vocab)
        for h in (self.unit_head, self.text_head):
            h.init_std = E ** -0.5

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SpeechLM":
        """Random weights from `generator` at the flax initialisers'
        scales; `mask_emb` uniform [0, 1)."""
        init_weights_(self, generator)
        self.mask_emb.uniform_(0.0, 1.0, generator=generator)
        return self

    def encode_speech(self, audio: torch.Tensor,
                      mask_indices: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        x = self.feature_proj(self.feature_norm(self.feature_extractor(audio)))
        if mask_indices is not None:
            x = torch.where(mask_indices[..., None], self.mask_emb.to(x.dtype),
                            x)
        x = x + self.conv_pos(x)
        return self.encoder(x, generator=generator)

    def encode_text(self, tokens: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
        pos = self.text_pos(torch.arange(tokens.shape[1],
                                         device=tokens.device))
        return self.encoder(self.text_embed(tokens) + pos[None],
                            generator=generator)

    def forward(self, audio: torch.Tensor, mask_indices: torch.Tensor,
                text_tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        h_speech = self.encode_speech(audio, mask_indices, generator)
        h_text = self.encode_text(text_tokens, generator)
        return self.unit_head(h_speech), self.text_head(h_text)


def speechlm_pretrain_loss(unit_logits: torch.Tensor,  # [B, T, Vu]
                           unit_targets: torch.Tensor,  # [B, T]
                           mask_indices: torch.Tensor,  # [B, T] bool
                           text_logits: torch.Tensor,  # [B, L, Vt]
                           text_targets: torch.Tensor,  # [B, L], -100 = none
                           text_weight: float = 1.0):
    """Masked-unit CE on the masked speech frames + masked-LM CE on the
    text, each over its masked count: (total, {"unit_loss",
    "text_loss"}), float32."""

    def masked_ce(logits, targets, mask):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp(min=1.0)

    unit_loss = masked_ce(unit_logits, unit_targets, mask_indices)
    text_loss = masked_ce(text_logits, text_targets, text_targets >= 0)
    total = unit_loss + text_weight * text_loss
    return total, {"unit_loss": unit_loss, "text_loss": text_loss}


def speechlm_base(**kw) -> SpeechLMConfig:
    return SpeechLMConfig(**kw)
