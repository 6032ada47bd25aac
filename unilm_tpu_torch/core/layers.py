"""Shared building blocks (port of unilm_tpu/core/layers.py): projections,
norms, activations and the feed-forward block.

Parameters are stored in `cfg.param_dtype` and cast to the compute dtype
`cfg.dtype` on use, as flax's `dtype`/`param_dtype` pair does. Norm
statistics run in float32 and the result is cast to the compute dtype,
as flax's LayerNorm does.

Random initialisation follows the JAX initialisers' scales (xavier-uniform
times the deepnorm/subln factor for projections, normal(std) for
embeddings) and draws from an explicit `torch.Generator`
(`init_weights_`).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig


def get_activation(name: str, dtype=None) -> Callable:
    """Activation zoo. 'gelu' is exact erf-GELU except under bf16 compute,
    where the JAX package swaps in the tanh approximation
    (unilm_tpu/core/layers.py get_activation); the same rule, and the same
    UNILM_TPU_EXACT_GELU override, apply here so bf16 runs of the two
    packages compute the same function."""
    if (
        name == "gelu"
        and dtype == torch.bfloat16
        and not os.environ.get("UNILM_TPU_EXACT_GELU")
    ):
        name = "gelu_tanh"
    return _ACTIVATIONS[name]


_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}

GATED_ACTIVATIONS = {"swiglu": "silu", "geglu": "gelu", "geglu_new": "gelu_new"}


class Dense(nn.Linear):
    """nn.Linear in `param_dtype` computing in `dtype`. `init_scale` is the
    xavier-uniform multiplier the JAX module initialises this projection
    with (scaled_init in unilm_tpu/core/layers.py)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 dtype, param_dtype, init_scale: float = 1.0, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype
        self.init_scale = init_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Norm(nn.Module):
    """LayerNorm or RMSNorm (cfg.norm_type), float32 statistics, output in
    the compute dtype."""

    def __init__(self, cfg: TransformerConfig, dim: Optional[int] = None,
                 device=None):
        super().__init__()
        dim = cfg.embed_dim if dim is None else dim
        self.rms = cfg.norm_type == "rmsnorm"
        self.eps = cfg.layernorm_eps
        self.compute_dtype = cfg.dtype
        self.weight = nn.Parameter(
            torch.ones(dim, device=device, dtype=cfg.param_dtype))
        if self.rms:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(
                torch.zeros(dim, device=device, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rms:
            xf = x.float()
            y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
            y = y * self.weight.float()
        elif x.dtype == self.weight.dtype:
            # torch's layer_norm keeps float32 statistics for bf16 inputs
            # and rounds once at the end: one kernel, no upcast copies
            y = F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                             self.eps)
        else:
            y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                             self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def make_norm(cfg: TransformerConfig, dim: Optional[int] = None,
              device=None) -> Norm:
    """LayerNorm or RMSNorm over `dim` (default embed_dim)."""
    return Norm(cfg, dim, device=device)


def make_dense(cfg: TransformerConfig, in_features: int, features: int, *,
               init_scale: float = 1.0, use_kernel: bool = True,
               device=None) -> nn.Module:
    """Dense projection factory: int8 weight-only `QuantDense` when
    cfg.quant_weights (conversion-only weights; `use_kernel=False` keeps it
    on the plain version), else `Dense`. Unlike the JAX factory, a scanned
    stack keeps the kernel (see ops/quant.py)."""
    if cfg.quant_weights:
        from unilm_tpu_torch.ops.quant import QuantDense

        return QuantDense(in_features, features, bias=cfg.use_bias,
                          dtype=cfg.dtype, use_kernel=use_kernel,
                          device=device)
    return Dense(in_features, features, bias=cfg.use_bias, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype, init_scale=init_scale,
                 device=device)


class FeedForward(nn.Module):
    """fc1 -> act -> (ffn_layernorm if subln) -> fc2, or the gated variant
    (torchscale FeedForwardNetwork). Dropout is not applied: a config
    that asks for it raises in the train-mode Decoder."""

    def __init__(self, cfg: TransformerConfig, init_scale: float = 1.0,
                 use_kernel: bool = True, device=None):
        super().__init__()
        E, Fd = cfg.embed_dim, cfg.ffn_dim
        self.gated = cfg.activation in GATED_ACTIVATIONS
        self.act = get_activation(
            GATED_ACTIVATIONS.get(cfg.activation, cfg.activation), cfg.dtype)
        dense = lambda i, o: make_dense(cfg, i, o, init_scale=init_scale,
                                        use_kernel=use_kernel, device=device)
        self.fc1 = dense(E, Fd)
        if self.gated:
            self.fc3 = dense(E, Fd)
        if cfg.subln:
            self.ffn_layernorm = make_norm(cfg, Fd, device=device)
        self.fc2 = dense(Fd, E)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = self.act(self.fc1(x)) * self.fc3(x)
        else:
            h = self.act(self.fc1(x))
        if hasattr(self, "ffn_layernorm"):
            h = self.ffn_layernorm(h)
        return self.fc2(h)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every Dense (xavier-uniform * init_scale, or normal(0, init_std)
    where set; zero bias), Norm (ones/zeros) and embedding
    (normal(0, init_std)) under `module` from
    `generator`, at the scales of the JAX initialisers."""
    for m in module.modules():
        if isinstance(m, Dense):
            if getattr(m, "init_std", None) is not None:
                m.weight.normal_(0.0, m.init_std, generator=generator)
            else:
                fan_out, fan_in = m.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out)) * m.init_scale
                m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Norm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, getattr(m, "init_std", 1.0),
                             generator=generator)
