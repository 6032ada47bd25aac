"""BEATs: audio pre-training with acoustic tokenizers (port of
unilm_tpu/models/beats.py: `BEATsConfig` :24, `BEATsEncoder` :53,
`BEATsForAudioClassification` :72, `BEATsTokenizer` :82).

A mel spectrogram [B, frames, mel_bins] is patchified by a stride-16
16x16 convolution (`patch_embedding`, an OIHW `nn.Conv2d` loaded from the
flax HWIO kernel by convert/from_jax.py; float32, as the flax Conv at its
defaults), LayerNorm'd and run through the post-LN core `Encoder` with
T5 relative buckets (`rel_pos_buckets=320`, `max_rel_pos=800`: the
encoder's `relative_position` bias [1, H, T, T]). The classifier mean-
pools; the tokenizer projects and quantizes with BEiT-2's
`NormEMAVectorQuantizer` (l2-normalised codebook whose EMA buffers move
only under `update_ema=True`; `load_flax_params(model, params,
ema=variables["ema"])`).

On the card every encoder layer takes the fused encoder attention (#3)
with the bucket bias: 998 frames x 128 mel bins are 62 x 8 = 496
patches.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import head_dense, init_weights_
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.beit2 import NormEMAVectorQuantizer
from unilm_tpu_torch.models.wavlm import layer_norm
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BEATsConfig:
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    patch_size: int = 16
    mel_bins: int = 128
    deepnorm: bool = False
    num_classes: int = 527  # AudioSet
    codebook_size: int = 1024
    codebook_dim: int = 256
    layernorm_eps: float = 1e-5
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=False, deepnorm=self.deepnorm,
            rel_pos_buckets=320, max_rel_pos=800,
            layernorm_eps=self.layernorm_eps, dtype=self.dtype,
            use_flash=self.use_flash)


class PatchConv(nn.Conv2d):
    """The flax stride-p VALID Conv over [B, F, M] spectrograms (one input
    channel) -> [B, (F/p)*(M/p), E] patches, row-major; float32."""

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        x = super().forward(spec.float()[:, None])  # [B, E, f, m]
        return x.flatten(2).transpose(1, 2)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """flax's lecun-normal kernel, zero bias."""
        fan_in = self.weight[0].numel()
        self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        self.bias.zero_()


class BEATsEncoder(nn.Module):
    """[B, frames, mel_bins] spectrogram -> token representations
    [B, patches, E] in `cfg.dtype`."""

    def __init__(self, cfg: BEATsConfig, device=None):
        super().__init__()
        p = cfg.patch_size
        self.patch_embedding = PatchConv(1, cfg.embed_dim, p, stride=p,
                                         device=device)
        self.layer_norm = layer_norm(cfg.embed_dim, cfg.layernorm_eps, device)
        self.encoder = Encoder(cfg.transformer(), device=device)

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.layer_norm(self.patch_embedding(spectrogram)))


class BEATsForAudioClassification(nn.Module):
    """Mean-pooled encoder -> float32 logits [B, num_classes]."""

    def __init__(self, cfg: BEATsConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.beats = BEATsEncoder(cfg, device=dev)
        self.classifier = head_dense(cfg.embed_dim, cfg.num_classes,
                                     device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "BEATsForAudioClassification":
        """Random weights from `generator` at the flax initialisers'
        scales (the T5 table normal(0.02))."""
        init_weights_(self, generator)
        return self

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.beats(spectrogram).mean(1))


class BEATsTokenizer(nn.Module):
    """Acoustic tokenizer (beats/Tokenizers.py): encoder -> float32
    projection -> l2-EMA vector quantizer -> (quantized, loss, ids)."""

    def __init__(self, cfg: BEATsConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.encoder = BEATsEncoder(cfg, device=dev)
        self.quantize_proj = head_dense(cfg.embed_dim, cfg.codebook_dim,
                                        device=dev)
        self.quantize = NormEMAVectorQuantizer(cfg.codebook_size,
                                               cfg.codebook_dim, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BEATsTokenizer":
        init_weights_(self, generator)
        self.quantize.init_weights(generator)
        return self

    def forward(self, spectrogram: torch.Tensor, update_ema: bool = False):
        z = self.quantize_proj(self.encoder(spectrogram))
        return self.quantize(z, update_ema=update_ema)

    @torch.no_grad()
    def get_codebook_indices(self, spectrogram: torch.Tensor) -> torch.Tensor:
        return self(spectrogram)[2]
