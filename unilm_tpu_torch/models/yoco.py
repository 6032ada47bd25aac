"""YOCO: decoder-decoder long-context LM ("You Only Cache Once"); port of
unilm_tpu/models/yoco.py.

- Self-decoder: sliding-window attention or gated retention layers over
  the first half of the depth.
- One GLOBAL K/V pair computed once from the self-decoder's output; every
  cross-decoder layer attends to it (GQA: the kv heads are repeated).
- RMSNorm pre-norm, SwiGLU FFN, interleaved rotary positions, bias-free
  projections, logits from the tied embedding.

The flax modules' dtype rules hold: float32 parameters, compute in
`cfg.dtype`, RMS statistics in float32 cast back to x's dtype, the
retention gates in float32. Module names are the flax tree's
(`self_{i}`, `self_norm1_{i}`, `cross_ffn_{i}`, `global_k`, ...), so
`convert.from_jax.load_flax_params` loads a JAX checkpoint as it is.

Attention goes through `ops.attention.attention`: on a CUDA tensor the
flash forward, whose selector sends short calls (a cache of <= 256 slots
at yoco_base width in bf16) to the one-pass kernel (#5) and longer ones
to #1. Generation state is an explicit `YOCOCache`, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, FeedForward, init_weights_
from unilm_tpu_torch.ops.attention import attention
from unilm_tpu_torch.ops.retention import (chunk_gate_retention,
                                           recurrent_gate_retention)
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class YOCOConfig:
    """Defaults are the JAX registry's `yoco_base`."""
    vocab_size: int = 64000
    dim: int = 1024
    self_layers: int = 12  # first half: efficient self attention
    cross_layers: int = 12  # second half: shared-KV cross attention
    num_heads: int = 16
    kv_heads: int = 4  # GQA on the global KV
    ffn_dim: int = 4096
    self_type: str = "sliding_window"  # sliding_window | gate_retention
    window_size: int = 1024
    rope_base: float = 10000.0
    gate_logit_normalizer: int = 16
    retention_chunk: int = 256
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    use_flash: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def tcfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.dim, ffn_dim=self.ffn_dim, num_heads=self.num_heads,
            activation="swiglu", norm_type="rmsnorm", use_bias=False,
            layernorm_eps=self.norm_eps, dtype=self.dtype,
            use_flash=self.use_flash)


@dataclasses.dataclass
class YOCOCache:
    """Generation state. `self_state[i]` is layer i's (K, V) pair
    [B, cache, H, D] in the compute dtype (sliding window) or its
    retention state [B, H, D, D] float32; `global_k` / `global_v` the one
    global pair [B, cache, Hkv, D]; `pos` the number of tokens seen."""
    self_state: List[Union[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]]
    global_k: torch.Tensor
    global_v: torch.Tensor
    pos: int = 0

    @property
    def cache_size(self) -> int:
        return self.global_k.shape[1]


def rotary_sin_cos(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """(sin, cos) float32 [T, dim/2] of positions [T]."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    freqs = positions.float()[:, None] * inv[None]
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """Interleaved rotary on x [B, T, H, D] (Tri Dao's kernel convention):
    the pair (x[2i], x[2i+1]) turns by the angle of frequency i."""
    sin = sin.repeat_interleave(2, dim=-1)[None, :, None, :]
    cos = cos.repeat_interleave(2, dim=-1)[None, :, None, :]
    rot = torch.stack((-x[..., 1::2], x[..., ::2]), dim=-1).reshape(x.shape)
    return (x * cos + rot * sin).to(x.dtype)


class RMS(nn.Module):
    """RMSNorm with float32 statistics, cast back to x's dtype; `affine`
    adds the learned float32 `weight` (flax `scale`)."""

    def __init__(self, dim: int, eps: float = 1e-5, affine: bool = True,
                 device=None):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, device=device))
        else:
            self.register_parameter("weight", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        if self.weight is not None:
            y = y * self.weight
        return y.to(x.dtype)


def _dense(cfg: YOCOConfig, i: int, o: int, device) -> Dense:
    return Dense(i, o, bias=False, dtype=cfg.dtype, param_dtype=torch.float32,
                 device=device)


class SlidingWindowLayer(nn.Module):
    """Windowed causal self attention (sliding_window_attention.py)."""

    def __init__(self, cfg: YOCOConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, _dense(cfg, cfg.dim, cfg.dim, device))

    def forward(self, x, sin, cos, state=None, start: int = 0):
        """`state`: this layer's cached (K, V), written at `start` in place;
        None in train mode. Returns (y, state)."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = apply_rotary(self.q_proj(x).reshape(B, T, H, D), sin, cos)
        k = apply_rotary(self.k_proj(x).reshape(B, T, H, D), sin, cos)
        v = self.v_proj(x).reshape(B, T, H, D)
        q_offset = kv_len = None
        if state is not None:
            ck, cv = state
            ck[:, start:start + T] = k
            cv[:, start:start + T] = v
            k, v = ck, cv
            q_offset, kv_len = start, start + T
        o = attention(q, k, v, causal=True, window=cfg.window_size,
                      q_offset=q_offset, kv_len=kv_len,
                      use_flash=cfg.use_flash)
        return self.out_proj(o.reshape(B, T, cfg.dim)), state


class GateRetentionLayer(nn.Module):
    """gate_retention.py GateRetention: q/k/v/g/gt projections, chunked
    scan (prefill, train) or one recurrent step (decode), head RMS without
    affine, swish-gated output."""

    def __init__(self, cfg: YOCOConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "g_proj"):
            self.add_module(name, _dense(cfg, cfg.dim, cfg.dim, device))
        self.gt_proj = _dense(cfg, cfg.dim, cfg.num_heads, device)
        self.subln = RMS(cfg.head_dim, cfg.norm_eps, affine=False)
        self.out_proj = _dense(cfg, cfg.dim, cfg.dim, device)

    def forward(self, x, sin, cos, state=None, mode: str = "train"):
        """`state`: the retention state [B, H, D, D] float32 a decode step
        starts from (prefill and train start from zero). Returns (y, the
        final state; None in train mode)."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = apply_rotary(self.q_proj(x).reshape(B, T, H, D), sin, cos)
        k = apply_rotary(self.k_proj(x).reshape(B, T, H, D), sin, cos)
        v = self.v_proj(x).reshape(B, T, H, D)
        g = self.g_proj(x)
        logg = F.logsigmoid(self.gt_proj(x).float()) / cfg.gate_logit_normalizer
        if mode == "decode":
            o, state = recurrent_gate_retention(q, k, v, logg, state)
        else:
            o, state = chunk_gate_retention(q, k, v, logg,
                                            cfg.retention_chunk)
            if mode == "train":
                state = None
        o = self.subln(o).reshape(B, T, cfg.dim) * F.silu(g.float()).to(o.dtype)
        return self.out_proj(o), state


class CrossLayer(nn.Module):
    """Cross-decoder attention: a q projection only; K/V are the global
    pair, its kv heads repeated to the query heads."""

    def __init__(self, cfg: YOCOConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.q_proj = _dense(cfg, cfg.dim, cfg.dim, device)
        self.out_proj = _dense(cfg, cfg.dim, cfg.dim, device)

    def forward(self, x, gk, gv, sin, cos, q_offset=None, kv_len=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = apply_rotary(self.q_proj(x).reshape(B, T, H, D), sin, cos)
        rep = H // gk.shape[2]
        k = gk.repeat_interleave(rep, dim=2)
        v = gv.repeat_interleave(rep, dim=2)
        o = attention(q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len,
                      use_flash=cfg.use_flash)
        return self.out_proj(o.reshape(B, T, cfg.dim))


class YOCO(nn.Module):
    """The decoder-decoder LM. `forward(tokens)` gives train-mode logits;
    `forward(tokens, "prefill", cache_size=n)` and
    `forward(tokens, "decode", cache=c)` return (logits, cache). The
    device defaults to the card ("cuda" raises without one); pass
    device="cpu" to run on the CPU."""

    def __init__(self, cfg: YOCOConfig, device="cuda"):
        super().__init__()
        if cfg.self_type not in ("sliding_window", "gate_retention"):
            raise ValueError(f"unknown self_type {cfg.self_type!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        tcfg = cfg.tcfg()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, device=dev)
        self.embed_tokens.init_std = cfg.dim ** -0.5
        SelfLayer = (GateRetentionLayer if cfg.self_type == "gate_retention"
                     else SlidingWindowLayer)
        for i in range(cfg.self_layers):
            self.add_module(f"self_norm1_{i}", RMS(cfg.dim, cfg.norm_eps,
                                                   device=dev))
            self.add_module(f"self_{i}", SelfLayer(cfg, device=dev))
            self.add_module(f"self_norm2_{i}", RMS(cfg.dim, cfg.norm_eps,
                                                   device=dev))
            self.add_module(f"self_ffn_{i}", FeedForward(tcfg, device=dev))
        self.kv_norm = RMS(cfg.dim, cfg.norm_eps, device=dev)
        kv_dim = cfg.kv_heads * cfg.head_dim
        self.global_k = _dense(cfg, cfg.dim, kv_dim, dev)
        self.global_v = _dense(cfg, cfg.dim, kv_dim, dev)
        for i in range(cfg.cross_layers):
            self.add_module(f"cross_norm1_{i}", RMS(cfg.dim, cfg.norm_eps,
                                                    device=dev))
            self.add_module(f"cross_{i}", CrossLayer(cfg, device=dev))
            self.add_module(f"cross_norm2_{i}", RMS(cfg.dim, cfg.norm_eps,
                                                    device=dev))
            self.add_module(f"cross_ffn_{i}", FeedForward(tcfg, device=dev))
        self.final_norm = RMS(cfg.dim, cfg.norm_eps, device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "YOCO":
        """Random weights from `generator` (on the parameters' device):
        projections xavier-uniform, the embedding normal(dim^-0.5) as
        flax's, norms ones."""
        init_weights_(self, generator)
        return self

    def new_cache(self, batch: int, cache_size: int) -> YOCOCache:
        """Zeroed generation state for `batch` rows of `cache_size` slots."""
        cfg, dev = self.cfg, self.device
        H, D, Hkv = cfg.num_heads, cfg.head_dim, cfg.kv_heads
        z = lambda *s, dt=cfg.dtype: torch.zeros(*s, dtype=dt, device=dev)
        if cfg.self_type == "gate_retention":
            states = [z(batch, H, D, D, dt=torch.float32)
                      for _ in range(cfg.self_layers)]
        else:
            states = [(z(batch, cache_size, H, D), z(batch, cache_size, H, D))
                      for _ in range(cfg.self_layers)]
        return YOCOCache(states, z(batch, cache_size, Hkv, D),
                         z(batch, cache_size, Hkv, D), 0)

    def forward(self, tokens: torch.Tensor, mode: str = "train",
                cache: Optional[YOCOCache] = None, cache_size: int = 0):
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, T = tokens.shape
        if mode == "prefill":
            cache = self.new_cache(B, cache_size)
        elif mode == "decode":
            if cache is None:
                raise ValueError("decode needs the cache of a prefill")
        elif mode != "train":
            raise ValueError(f"unknown mode {mode!r}")
        start = 0 if cache is None else cache.pos
        if cache is not None and start + T > cache.cache_size:
            raise ValueError(f"{start} + {T} tokens overflow a cache of "
                             f"{cache.cache_size} slots")
        positions = start + torch.arange(T, device=self.device)
        sin, cos = rotary_sin_cos(positions, cfg.head_dim, cfg.rope_base)
        x = self.embed_tokens.weight.to(cfg.dtype)[tokens]

        for i in range(cfg.self_layers):
            layer = getattr(self, f"self_{i}")
            h = getattr(self, f"self_norm1_{i}")(x)
            state = None if cache is None else cache.self_state[i]
            if cfg.self_type == "gate_retention":
                y, state = layer(h, sin, cos, state, mode)
            else:
                y, state = layer(h, sin, cos, state, start)
            if cache is not None:
                cache.self_state[i] = state
            x = x + y
            x = x + getattr(self, f"self_ffn_{i}")(
                getattr(self, f"self_norm2_{i}")(x))

        # ---- ONE global KV (yoco.py:241) ---------------------------------
        kvn = self.kv_norm(x)
        Hkv, D = cfg.kv_heads, cfg.head_dim
        gk = apply_rotary(self.global_k(kvn).reshape(B, T, Hkv, D), sin, cos)
        gv = self.global_v(kvn).reshape(B, T, Hkv, D)
        q_offset = kv_len = None
        if cache is not None:
            cache.global_k[:, start:start + T] = gk
            cache.global_v[:, start:start + T] = gv
            gk, gv = cache.global_k, cache.global_v
            q_offset, kv_len = start, start + T
            cache.pos = start + T

        for i in range(cfg.cross_layers):
            h = getattr(self, f"cross_norm1_{i}")(x)
            x = x + getattr(self, f"cross_{i}")(h, gk, gv, sin, cos, q_offset,
                                                kv_len)
            x = x + getattr(self, f"cross_ffn_{i}")(
                getattr(self, f"cross_norm2_{i}")(x))

        x = self.final_norm(x)
        logits = F.linear(x, self.embed_tokens.weight.to(cfg.dtype))
        return logits if mode == "train" else (logits, cache)


def make_yoco_generate_fns(model: YOCO, cache_size: int):
    """(prefill, step) closures for runtime.generate, without autograd:
    prefill(tokens [B, P], aux) -> (logits [B, P, V], cache) and
    step(tokens [B, 1], cache, aux) -> (logits [B, 1, V], cache). `aux` is
    unread."""

    @torch.no_grad()
    def prefill(tokens, aux):
        return model(tokens, "prefill", cache_size=cache_size)

    @torch.no_grad()
    def step(tokens, cache, aux):
        return model(tokens, "decode", cache=cache)

    return prefill, step
