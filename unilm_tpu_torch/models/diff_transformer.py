"""Differential Transformer (port of unilm_tpu/models/diff_transformer.py:
`lambda_init_fn` :26, `MultiheadDiffAttn` :30, `DiffTransformerConfig`
:89, `DiffTransformerLM` :101).

Each head computes two softmax attentions over split query/key halves
and subtracts them with a learned, reparameterised lambda (lambda_init =
0.8 - 0.6 exp(-0.3 depth)); a per-head RMSNorm, then the (1 - lambda_init)
scale. GQA by repeating the kv heads; interleaved rotary; pre-RMSNorm
blocks with a SwiGLU FFN; logits from the tied embedding.

JAX computes the two attentions inline with einsums (float32 logits, a
float32 softmax), not through a kernel; the port does the same plain
computation, on the card too. Module names are the flax tree's
(`attn_{i}` with `lambda_q1` ... `lambda_k2` and `subln`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, FeedForward, init_weights_
from unilm_tpu_torch.models.yoco import RMS, apply_rotary, rotary_sin_cos
from unilm_tpu_torch.ops.attention import NEG_INF, make_causal_mask
from unilm_tpu_torch.runtime.device import resolve_device


def lambda_init_fn(depth: int) -> float:
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


class MultiheadDiffAttn(nn.Module):
    """num_heads = HALF the baseline transformer's heads (each diff head
    spends two softmaxes)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 num_kv_heads: Optional[int] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        E, H = embed_dim, num_heads
        self.H, self.KV = H, num_kv_heads or H
        self.rep = H // self.KV
        self.D = E // H // 2  # split head dim
        self.lambda_init = lambda_init_fn(depth)
        dense = lambda i, o: Dense(i, o, bias=False, dtype=dtype,
                                   param_dtype=torch.float32, device=device)
        self.q_proj = dense(E, E)
        self.k_proj = dense(E, E // self.rep)
        self.v_proj = dense(E, E // self.rep)
        self.out_proj = dense(E, E)
        for n in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            setattr(self, n, nn.Parameter(torch.zeros(self.D, device=device)))
        self.subln = RMS(2 * self.D, 1e-5, device=device)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """The lambdas normal(0.1), the flax initialiser."""
        for n in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            getattr(self, n).normal_(0.0, 0.1, generator=generator)

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        H, KV, D, rep = self.H, self.KV, self.D, self.rep
        B, T, E = x.shape
        q = self.q_proj(x).view(B, T, 2 * H, D)
        k = self.k_proj(x).view(B, T, 2 * KV, D)
        v = self.v_proj(x).view(B, T, KV, 2 * D)
        sin, cos = rotary_sin_cos(torch.arange(T, device=x.device), D)
        q, k = apply_rotary(q, sin, cos), apply_rotary(k, sin, cos)
        k = k.repeat_interleave(rep, dim=2)  # [B, T, 2H, D]
        v = v.repeat_interleave(rep, dim=2)  # [B, T, H, 2D]
        # two softmax attentions per diff head: the sub-head pair axis p
        q2 = q.reshape(B, T, H, 2, D) * D ** -0.5
        k2 = k.reshape(B, T, H, 2, D)
        logits = torch.einsum("bthpd,bshpd->bhpts", q2.float(), k2.float())
        if causal:
            pos = torch.arange(T, device=x.device)
            logits = logits.masked_fill(~make_causal_mask(pos, pos), NEG_INF)
        p = torch.softmax(logits, dim=-1)  # [B, H, 2, T, S]
        lam = (torch.exp(torch.dot(self.lambda_q1, self.lambda_k1))
               - torch.exp(torch.dot(self.lambda_q2, self.lambda_k2))
               + self.lambda_init)
        diff = p[:, :, 0] - lam * p[:, :, 1]  # [B, H, T, S]
        o = torch.einsum("bhts,bshe->bthe", diff.to(v.dtype).float(),
                         v.float()).to(v.dtype)
        o = self.subln(o) * (1.0 - self.lambda_init)
        return self.out_proj(o.reshape(B, T, E))


@dataclasses.dataclass(frozen=True)
class DiffTransformerConfig:
    vocab_size: int = 32000
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 6  # half of the 12-head baseline
    num_kv_heads: Optional[int] = None
    ffn_dim: int = 2048
    norm_eps: float = 1e-5
    dtype: Any = torch.float32


class DiffTransformerLM(nn.Module):
    """tokens [B, T] -> logits [B, T, V] in `cfg.dtype`."""

    def __init__(self, cfg: DiffTransformerConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E = cfg.embed_dim
        tcfg = TransformerConfig(
            embed_dim=E, ffn_dim=cfg.ffn_dim, activation="swiglu",
            norm_type="rmsnorm", use_bias=False, dtype=cfg.dtype,
            use_flash=False)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=dev)
        self.embed_tokens.init_std = E ** -0.5
        for i in range(cfg.num_layers):
            self.add_module(f"attn_norm_{i}", RMS(E, cfg.norm_eps,
                                                  device=dev))
            self.add_module(f"attn_{i}", MultiheadDiffAttn(
                E, i, cfg.num_heads, cfg.num_kv_heads, cfg.dtype, device=dev))
            self.add_module(f"ffn_norm_{i}", RMS(E, cfg.norm_eps, device=dev))
            self.add_module(f"ffn_{i}", FeedForward(tcfg, device=dev))
        self.final_norm = RMS(E, cfg.norm_eps, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DiffTransformerLM":
        """Random weights from `generator`: projections xavier-uniform,
        the embedding normal(E^-0.5), the lambdas normal(0.1), norms
        ones."""
        init_weights_(self, generator)
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = self.embed_tokens.weight.to(cfg.dtype)
        x = F.embedding(tokens, emb)
        for i in range(cfg.num_layers):
            h = getattr(self, f"attn_norm_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(h)
            h = getattr(self, f"ffn_norm_{i}")(x)
            x = x + getattr(self, f"ffn_{i}")(h)
        return F.linear(self.final_norm(x), emb)

