"""RetNet: the multi-scale retention decoder (port of
unilm_tpu/models/retnet.py: `RetNetConfig` :31, `retention_decays` :53,
`_group_norm` :60, `MultiScaleRetention` :66, `RetNetDecoder` :118,
`init_retnet_states` :162, `retnet_base` :169 and `retnet_medium` :173).

Multi-scale retention is gated retention with a constant per-head
log-decay log(1 - 2^(-5 - h)), so ops/retention.py's chunk form trains
it (and runs a prefill) and its recurrent form decodes one token from an
O(1) state [B, H, Dk, Dv] float32 per layer (Dv = 2 Dk: the value width
is twice the embedding). Interleaved rotary on q and k, a scale-invariant
per-head group norm on the retention output, the swish gate, pre-RMSNorm
blocks with a SwiGLU FFN, logits from the tied embedding.

No kernel: JAX runs these forms as XLA programs (ops/retention.py has no
Pallas kernel), and the port runs their plain torch versions, on the card
too. Module names are the flax tree's (`embed_tokens`, `ret_norm_{i}`,
`retention_{i}`, `ffn_norm_{i}`, `ffn_{i}`, `final_norm`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, FeedForward, init_weights_
from unilm_tpu_torch.models.yoco import RMS, apply_rotary, rotary_sin_cos
from unilm_tpu_torch.ops.retention import (chunk_gate_retention,
                                           recurrent_gate_retention)
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RetNetConfig:
    vocab_size: int = 32000
    embed_dim: int = 768
    value_dim: Optional[int] = None  # default 2 * embed_dim
    num_layers: int = 12
    num_heads: Optional[int] = None  # default embed_dim // 256 (key head 256)
    ffn_dim: Optional[int] = None  # default 2 * embed_dim (swiglu)
    chunk_size: int = 256
    norm_eps: float = 1e-6
    dtype: Any = torch.float32

    @property
    def heads(self) -> int:
        return self.num_heads or max(1, self.embed_dim // 256)

    @property
    def vdim(self) -> int:
        return self.value_dim or 2 * self.embed_dim


def retention_decays(num_heads: int, device=None) -> torch.Tensor:
    """Per-head log-decay log(1 - 2^(-5 - h)), float32 [H]."""
    h = torch.arange(num_heads, dtype=torch.float32, device=device)
    return torch.log(1.0 - torch.exp2(-5.0 - h))


def _group_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Scale-invariant per-head normalisation (RetNet's GroupNorm without
    affine), float32 statistics, in x's dtype."""
    var = x.float().pow(2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype)


class MultiScaleRetention(nn.Module):
    def __init__(self, cfg: RetNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, V = cfg.embed_dim, cfg.vdim
        dense = lambda i, o: Dense(i, o, bias=False, dtype=cfg.dtype,
                                   param_dtype=torch.float32, device=device)
        self.q_proj, self.k_proj = dense(E, E), dense(E, E)
        self.v_proj, self.g_proj = dense(E, V), dense(E, V)
        self.out_proj = dense(V, E)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                state: Optional[torch.Tensor] = None, mode: str = "train"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, E] -> (out [B, T, E], state [B, H, Dk, Dv] float32).
        mode "decode" takes one token and the state of the previous ones;
        any other mode runs the chunk form from `state` (None: zeros)."""
        cfg = self.cfg
        H = cfg.heads
        B, T, _ = x.shape
        Dk, Dv = cfg.embed_dim // H, cfg.vdim // H
        q = self.q_proj(x).view(B, T, H, Dk)
        k = self.k_proj(x).view(B, T, H, Dk)
        v = self.v_proj(x).view(B, T, H, Dv)
        sin, cos = rotary_sin_cos(positions, Dk)
        q, k = apply_rotary(q, sin, cos), apply_rotary(k, sin, cos)
        gate = self.g_proj(x)
        g = retention_decays(H, x.device)[None, None].expand(B, T, H)
        if mode == "decode":
            o, state = recurrent_gate_retention(q, k, v, g, state)
        else:
            o, state = chunk_gate_retention(q, k, v, g, cfg.chunk_size,
                                            initial_state=state)
        o = _group_norm(o, cfg.norm_eps).reshape(B, T, cfg.vdim)
        o = F.silu(gate.float()).to(o.dtype) * o
        return self.out_proj(o), state


class RetNetDecoder(nn.Module):
    """Decoder-only retention LM: `forward(tokens)` runs the chunk form
    over the whole sequence (from `states`, when given); mode "decode"
    consumes one token at `positions` [1]. Returns (logits [B, T, V] in
    `cfg.dtype`, states [L, B, H, Dk, Dv] float32)."""

    def __init__(self, cfg: RetNetConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E = cfg.embed_dim
        tcfg = TransformerConfig(
            embed_dim=E, ffn_dim=cfg.ffn_dim or 2 * E, activation="swiglu",
            norm_type="rmsnorm", use_bias=False, dtype=cfg.dtype,
            use_flash=False)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=dev)
        self.embed_tokens.init_std = E ** -0.5
        for i in range(cfg.num_layers):
            self.add_module(f"ret_norm_{i}", RMS(E, cfg.norm_eps, device=dev))
            self.add_module(f"retention_{i}",
                            MultiScaleRetention(cfg, device=dev))
            self.add_module(f"ffn_norm_{i}", RMS(E, cfg.norm_eps, device=dev))
            self.add_module(f"ffn_{i}", FeedForward(tcfg, device=dev))
        self.final_norm = RMS(E, cfg.norm_eps, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RetNetDecoder":
        """Random weights from `generator`: projections xavier-uniform,
        the embedding normal(E^-0.5), norms ones."""
        init_weights_(self, generator)
        return self

    def forward(self, tokens: torch.Tensor,
                states: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                mode: str = "train"):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        emb = self.embed_tokens.weight.to(cfg.dtype)
        x = F.embedding(tokens, emb) * math.sqrt(cfg.embed_dim)
        new_states = []
        for i in range(cfg.num_layers):
            h = getattr(self, f"ret_norm_{i}")(x)
            o, s = getattr(self, f"retention_{i}")(
                h, positions, None if states is None else states[i], mode)
            new_states.append(s)
            x = x + o
            h = getattr(self, f"ffn_norm_{i}")(x)
            x = x + getattr(self, f"ffn_{i}")(h)
        x = self.final_norm(x)
        return F.linear(x, emb), torch.stack(new_states)


def init_retnet_states(cfg: RetNetConfig, batch: int,
                       device=None) -> torch.Tensor:
    """Zero states [L, B, H, Dk, Dv] float32."""
    H = cfg.heads
    return torch.zeros(cfg.num_layers, batch, H, cfg.embed_dim // H,
                       cfg.vdim // H, dtype=torch.float32, device=device)


def retnet_base(**kw) -> RetNetConfig:
    return RetNetConfig(**kw)


def retnet_medium(**kw) -> RetNetConfig:
    kw.setdefault("embed_dim", 1024)
    kw.setdefault("num_layers", 16)
    return RetNetConfig(**kw)
