"""WavLM: the self-supervised speech encoder with a gated relative
position bias (port of unilm_tpu/models/wavlm.py: `WavLMConfig` :24,
`FeatureExtractor` :42, `ConvPositionalEmbedding` :63,
`GatedRelPosAttention` :80, `WavLMModel` :114).

- A 1-D conv feature extractor over raw audio (the first layer
  group-normed per channel, exact GELU), 320x downsampling at the
  defaults: 10 s of 16 kHz audio is 499 frames.
- The feature projection (LayerNorm + Linear) and a grouped positional
  conv (even kernel: its last output frame dropped, JAX :74-75).
- A post-LN transformer whose attention adds a T5-bucketed relative bias,
  computed once from `rel_attn_embed` and gated per layer and per
  example by a sigmoid gate of the query (gru_rel_pos), so the bias is
  [B, H, T, T].

As in JAX, every module is a flax default (float32 params, no `dtype`),
so the model computes in float32 whatever `cfg.dtype` says, and its
attention is the plain `dot_product_attention` with that per-example
bias (JAX :110): no kernel, on the card too. Module names are the flax
tree's; an HF `WavLMModel` state dict converts through
convert/wavlm.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Norm, head_dense, init_weights_
from unilm_tpu_torch.core.positional import relative_position_bucket
from unilm_tpu_torch.ops.attention import dot_product_attention
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """Defaults are the JAX registry's `wavlm_base`."""
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layernorm_eps: float = 1e-5
    dropout: float = 0.0
    dtype: Any = torch.float32


def layer_norm(dim: int, eps: float, device=None) -> Norm:
    """A flax nn.LayerNorm at its defaults: float32 params and output."""
    return Norm(TransformerConfig(embed_dim=dim, layernorm_eps=eps),
                device=device)


class Conv1d(nn.Conv1d):
    """A flax 1-D Conv on channels-last input [B, T, C] (weight [O, I/g, K]
    from the flax kernel [K, I/g, O], convert/from_jax.py). `init_params_`
    draws flax's lecun-normal, bias zeros."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class GroupNorm(nn.Module):
    """flax nn.GroupNorm with one group per channel on [B, T, C]: each
    channel normalised over time (flax's E[x^2] - E[x]^2 variance),
    float32 `scale` -> `weight` and `bias`."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(1, keepdim=True)
        var = ((x * x).mean(1, keepdim=True) - mean * mean).clamp(min=0.0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


class FeatureExtractor(nn.Module):
    """Raw audio [B, samples] -> frames [B, T, conv_dim[-1]]."""

    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        cin = 1
        for i, (dim, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel,
                                            cfg.conv_stride)):
            self.add_module(f"conv_{i}", Conv1d(cin, dim, k, stride=s,
                                                bias=False, device=device))
            cin = dim
        self.group_norm = GroupNorm(cfg.conv_dim[0], cfg.layernorm_eps,
                                    device=device)
        self.n = len(cfg.conv_dim)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = audio.float()[:, :, None]
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x)
            if i == 0:
                x = self.group_norm(x)
            x = F.gelu(x, approximate="none")
        return x


class ConvPositionalEmbedding(nn.Module):
    """The grouped positional conv over [B, T, E] (kernel
    num_conv_pos_embeddings, padding k//2 each side; an even kernel's
    last output frame dropped), exact GELU."""

    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.even = k % 2 == 0
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                           padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = self.conv(x)
        if self.even:
            pos = pos[:, :-1]
        return F.gelu(pos, approximate="none")


class GatedRelPosAttention(nn.Module):
    """WavLM attention: the shared bucketed bias, gated per layer by the
    query (HF WavLMAttention.forward steps 1-4)."""

    def __init__(self, cfg: WavLMConfig, device=None):
        super().__init__()
        E, H = cfg.hidden_size, cfg.num_heads
        self.H = H
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, n, head_dense(E, E, device=device))
        self.gru_rel_pos_linear = head_dense(E // H, 8, device=device)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1,
                                                         device=device))

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        self.gru_rel_pos_const.fill_(1.0)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None):
        B, T, E = x.shape
        H = self.H
        D = E // H
        q = self.q_proj(x).view(B, T, H, D)
        k = self.k_proj(x).view(B, T, H, D)
        v = self.v_proj(x).view(B, T, H, D)
        # the gate reads the raw hidden states split by heads
        gates = self.gru_rel_pos_linear(x.view(B, T, H, D))
        gates = torch.sigmoid(gates.view(B, T, H, 2, 4).sum(-1))
        gate_a, gate_b = gates[..., 0], gates[..., 1]  # [B, T, H]
        const = self.gru_rel_pos_const[0, :, 0, 0][None, None]
        gate_a_1 = gate_a * (gate_b * const - 1.0) + 2.0
        gated_bias = gate_a_1.permute(0, 2, 1)[..., None] * position_bias
        mask = (None if key_padding_mask is None
                else key_padding_mask[:, None, None, :])
        out = dot_product_attention(q, k, v, bias=gated_bias, mask=mask)
        return self.out_proj(out.reshape(B, T, E))


class WavLMModel(nn.Module):
    """Raw audio [B, samples] -> float32 hidden states [B, T, E]."""

    def __init__(self, cfg: WavLMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E, eps = cfg.hidden_size, cfg.layernorm_eps
        self.feature_extractor = FeatureExtractor(cfg, device=dev)
        self.fp_layer_norm = layer_norm(cfg.conv_dim[-1], eps, dev)
        self.fp_projection = head_dense(cfg.conv_dim[-1], E, device=dev)
        self.pos_conv_embed = ConvPositionalEmbedding(cfg, device=dev)
        self.encoder_layer_norm = layer_norm(E, eps, dev)
        self.rel_attn_embed = nn.Parameter(torch.zeros(
            cfg.num_buckets, cfg.num_heads, device=dev))
        for i in range(cfg.num_layers):
            self.add_module(f"attn_{i}", GatedRelPosAttention(cfg, dev))
            self.add_module(f"ln1_{i}", layer_norm(E, eps, dev))
            self.add_module(f"fc1_{i}", head_dense(E, cfg.ffn_dim,
                                                   device=dev))
            self.add_module(f"fc2_{i}", head_dense(cfg.ffn_dim, E,
                                                   device=dev))
            self.add_module(f"ln2_{i}", layer_norm(E, eps, dev))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WavLMModel":
        """Random weights at the flax defaults' scales from `generator`:
        convs and projections lecun-normal, the bucket table
        normal(0.02), norms and the gate constants ones."""
        init_weights_(self, generator)
        self.rel_attn_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def position_bias(self, T: int) -> torch.Tensor:
        """The shared bucketed bias [1, H, T, T] (bucket of key - query)."""
        cfg = self.cfg
        ar = torch.arange(T, device=self.rel_attn_embed.device)
        rel = ar[None, :] - ar[:, None]
        buckets = relative_position_bucket(rel, True, cfg.num_buckets,
                                           cfg.max_bucket_distance)
        return self.rel_attn_embed[buckets].permute(2, 0, 1)[None]

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        feats = self.feature_extractor(audio)
        x = self.fp_projection(self.fp_layer_norm(feats))
        x = x + self.pos_conv_embed(x)
        x = self.encoder_layer_norm(x)
        bias = self.position_bias(x.shape[1])
        for i in range(cfg.num_layers):
            a = getattr(self, f"attn_{i}")(x, bias)
            x = getattr(self, f"ln1_{i}")(x + a)
            h = F.gelu(getattr(self, f"fc1_{i}")(x), approximate="none")
            h = getattr(self, f"fc2_{i}")(h)
            x = getattr(self, f"ln2_{i}")(x + h)
        return x
