"""SpeechT5: a unified-modal encoder-decoder for speech and text (port of
unilm_tpu/models/speecht5.py: `SpeechT5Config` :25, `SpeechEncoderPrenet`
:74, `SpeechDecoderPrenet` :88, `SpeechDecoderPostnet` :108,
`SpeechT5Model` :131 with `encode_speech`, `encode_text`, `asr_forward`
and `tts_forward`).

One shared pre-LN encoder-decoder with modality pre- and post-nets: the
speech encoder prenet (WavLM's conv feature extractor, a LayerNorm and
projection, WavLM's positional conv), the text prenet (an embedding plus
the learned `dec_pos` table), the speech decoder prenet (two ReLU denses
and a projection of the reduced mel frames, optionally a speaker
x-vector), the speech decoder postnet (mel and stop heads, a 5-layer
conv refinement) and the text postnet (the tied text embedding).

The pre/post-nets are flax defaults (float32); the encoder and decoder
compute in `cfg.dtype`. On the card `asr_forward` runs the encoder's
attention on the fused encoder attention (#3), the decoder's causal
self-attention on the flash forward (#5 or #1 by the selector) and its
cross-attention on #3; `tts_forward` likewise over the text.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import head_dense, init_weights_
from unilm_tpu_torch.core.transformer import Decoder, Encoder
from unilm_tpu_torch.models.wavlm import (Conv1d, ConvPositionalEmbedding,
                                          FeatureExtractor, WavLMConfig,
                                          layer_norm)
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SpeechT5Config:
    vocab_size: int = 10000
    hidden_size: int = 768
    enc_layers: int = 12
    dec_layers: int = 6
    num_heads: int = 12
    ffn_dim: int = 3072
    mel_bins: int = 80
    reduction_factor: int = 2  # mel frames predicted per decoder step
    speaker_dim: int = 0  # x-vector dim (0 = off)
    max_positions: int = 1024
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    layernorm_eps: float = 1e-5
    dropout: float = 0.0
    dtype: Any = torch.float32
    use_flash: bool = True

    def enc_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.enc_layers, num_heads=self.num_heads,
            normalize_before=True, layernorm_eps=self.layernorm_eps,
            dropout=self.dropout, dtype=self.dtype, use_flash=self.use_flash)

    def dec_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.dec_layers, num_heads=self.num_heads,
            normalize_before=True, is_encoder_decoder=True,
            layernorm_eps=self.layernorm_eps, dropout=self.dropout,
            dtype=self.dtype, use_flash=self.use_flash)

    def wavlm_cfg(self) -> WavLMConfig:
        return WavLMConfig(
            hidden_size=self.hidden_size, conv_dim=self.conv_dim,
            conv_stride=self.conv_stride, conv_kernel=self.conv_kernel,
            layernorm_eps=self.layernorm_eps)


class SpeechEncoderPrenet(nn.Module):
    """Raw audio -> frame features + conv positions, float32 [B, T, E]."""

    def __init__(self, cfg: SpeechT5Config, device=None):
        super().__init__()
        wcfg = cfg.wavlm_cfg()
        self.feature_extractor = FeatureExtractor(wcfg, device=device)
        self.fp_norm = layer_norm(cfg.conv_dim[-1], cfg.layernorm_eps, device)
        self.fp_proj = head_dense(cfg.conv_dim[-1], cfg.hidden_size,
                                  device=device)
        self.pos_conv = ConvPositionalEmbedding(wcfg, device=device)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.fp_proj(self.fp_norm(self.feature_extractor(audio)))
        return x + self.pos_conv(x)


class SpeechDecoderPrenet(nn.Module):
    """Reduced mel frames [B, T, mel_bins * r] -> hidden (two ReLU denses
    + projection), with the speaker x-vector when cfg.speaker_dim."""

    def __init__(self, cfg: SpeechT5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.fc1 = head_dense(cfg.mel_bins * cfg.reduction_factor, 256,
                              device=device)
        self.fc2 = head_dense(256, 256, device=device)
        self.proj = head_dense(256, cfg.hidden_size, device=device)
        if cfg.speaker_dim:
            self.spk_proj = head_dense(cfg.hidden_size + cfg.speaker_dim,
                                  cfg.hidden_size, device=device)

    def forward(self, mels: torch.Tensor,
                speaker: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = F.relu(self.fc2(F.relu(self.fc1(mels.float()))))
        h = self.proj(h)
        if self.cfg.speaker_dim and speaker is not None:
            s = speaker / (torch.linalg.vector_norm(speaker, dim=-1,
                                                    keepdim=True) + 1e-6)
            s = s[:, None].expand(*h.shape[:2], s.shape[-1])
            h = F.relu(self.spk_proj(torch.cat([h, s], -1)))
        return h


class SpeechDecoderPostnet(nn.Module):
    """hidden -> (mel_before, mel_after [B, T*r, mel_bins], stop logits
    [B, T*r]): the linear mel head, the stop head and the tacotron-style
    5-layer conv refinement (SAME padding, LayerNorm eps 1e-6, tanh)."""

    def __init__(self, cfg: SpeechT5Config, device=None):
        super().__init__()
        self.cfg = cfg
        r = cfg.reduction_factor
        self.feat_out = head_dense(cfg.hidden_size, cfg.mel_bins * r,
                                   device=device)
        self.prob_out = head_dense(cfg.hidden_size, r, device=device)
        cin = cfg.mel_bins
        for i in range(4):
            self.add_module(f"conv_{i}", Conv1d(cin, 256, 5, padding=2,
                                                device=device))
            self.add_module(f"cn_{i}", layer_norm(256, 1e-6, device))
            cin = 256
        self.conv_out = Conv1d(256, cfg.mel_bins, 5, padding=2,
                               device=device)

    def forward(self, h: torch.Tensor):
        cfg = self.cfg
        mel = self.feat_out(h)
        stop = self.prob_out(h)
        B, T, _ = mel.shape
        frames = mel.reshape(B, T * cfg.reduction_factor, cfg.mel_bins)
        x = frames
        for i in range(4):
            x = torch.tanh(getattr(self, f"cn_{i}")(
                getattr(self, f"conv_{i}")(x)))
        x = self.conv_out(x)
        return frames, frames + x, stop.reshape(B, T * cfg.reduction_factor)


class SpeechT5Model(nn.Module):
    """The shared encoder-decoder with its task methods; `forward` is
    `asr_forward`."""

    def __init__(self, cfg: SpeechT5Config, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E = cfg.hidden_size
        self.speech_prenet = SpeechEncoderPrenet(cfg, device=dev)
        self.text_embed = nn.Embedding(cfg.vocab_size, E, device=dev)
        self.text_embed.init_std = E ** -0.5
        self.dec_pos = nn.Parameter(torch.zeros(cfg.max_positions, E,
                                                device=dev))
        self.encoder = Encoder(cfg.enc_cfg(), device=dev)
        self.decoder = Decoder(cfg.dec_cfg(), has_cross_attention=True,
                               device=dev)
        self.speech_dec_prenet = SpeechDecoderPrenet(cfg, device=dev)
        self.speech_postnet = SpeechDecoderPostnet(cfg, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SpeechT5Model":
        """Random weights from `generator` at the flax initialisers'
        scales (`dec_pos` normal(0.02))."""
        init_weights_(self, generator)
        self.dec_pos.normal_(0.0, 0.02, generator=generator)
        return self

    def _text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_embed(tokens) + self.dec_pos[None, :tokens.shape[1]]

    def encode_speech(self, audio: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.speech_prenet(audio))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.encoder(self._text(tokens))

    def asr_forward(self, audio: torch.Tensor,
                    prev_tokens: torch.Tensor) -> torch.Tensor:
        """speech -> float32 text logits [B, T, V] (teacher forcing)."""
        enc = self.encode_speech(audio)
        h = self.decoder(self._text(prev_tokens), encoder_out=enc)
        return F.linear(h.float(), self.text_embed.weight)

    def tts_forward(self, tokens: torch.Tensor, prev_mels: torch.Tensor,
                    speaker: Optional[torch.Tensor] = None):
        """text -> (mel_before, mel_after, stop) (teacher forcing);
        prev_mels [B, Tdec, mel_bins * reduction] the shifted frames."""
        enc = self.encode_text(tokens)
        y = self.speech_dec_prenet(prev_mels, speaker)
        y = y + self.dec_pos[None, :y.shape[1]]
        h = self.decoder(y, encoder_out=enc)
        return self.speech_postnet(h.float())

    def forward(self, audio, prev_tokens):
        return self.asr_forward(audio, prev_tokens)
