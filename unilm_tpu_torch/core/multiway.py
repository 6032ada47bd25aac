"""Multiway networks: token-local modules duplicated into A/B experts
(port of unilm_tpu/core/multiway.py:24-73; BEiT-3 / VLMo).

Tokens before the split position go through expert A (vision), tokens
from it on through expert B (text). Both experts always hold parameters,
named `A` and `B` as in the JAX module, so a state dict compares tensor
for tensor with the flax tree.

`split` takes three forms:
- None: every token through A (the JAX module's `split_mask=None`); B
  holds parameters and does no work;
- an int position p (what BEiT3Model passes): tokens [0, p) through A
  and [p, T) through B, computed on the two slices of the sequence. A
  negative p, or p >= T, is all A, as `split_mask_from_position` reads
  -1. JAX runs both experts on the whole sequence and selects; slicing
  computes the same rows and does half the work;
- a bool tensor [T] or [B, T] (True = B): both experts on the whole
  sequence, then a select, as in JAX.

The model path is the int slice: BEiT3Model passes a position. The mask
form and `split_mask_from_position` exist for parity with the JAX API
(its tests give [T] and [B, T] masks); no module of the port calls them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, Norm

Split = Union[None, int, torch.Tensor]


def split_mask_from_position(seq_len: int, split_position: int,
                             device=None) -> torch.Tensor:
    """[T] bool; True = the second (B) expert. -1 -> all A (torchscale
    set_split_position semantics)."""
    pos = torch.arange(seq_len, device=device)
    return pos >= (seq_len if split_position < 0 else split_position)


def apply_split(a: nn.Module, b: nn.Module, x: torch.Tensor,
                split: Split) -> torch.Tensor:
    """Expert `a` on the A tokens of x [B, T, ...], `b` on the B tokens."""
    if split is None:
        return a(x)
    if isinstance(split, int):
        T = x.shape[1]
        if split < 0 or split >= T:
            return a(x)
        if split == 0:
            return b(x)
        return torch.cat([a(x[:, :split]), b(x[:, split:])], dim=1)
    m = split[None, :, None] if split.ndim == 1 else split[..., None]
    return torch.where(m, b(x), a(x))


class MultiwayDense(nn.Module):
    """Two `Dense` experts, `A` and `B`, of one shape."""

    def __init__(self, cfg: TransformerConfig, in_features: int,
                 features: int, *, init_scale: float = 1.0, device=None):
        super().__init__()
        mk = lambda: Dense(in_features, features, bias=cfg.use_bias,
                           dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                           init_scale=init_scale, device=device)
        self.A, self.B = mk(), mk()

    def forward(self, x: torch.Tensor, split: Split = None) -> torch.Tensor:
        return apply_split(self.A, self.B, x, split)


class MultiwayNorm(nn.Module):
    """Two norms of cfg.norm_type, `A` and `B`."""

    def __init__(self, cfg: TransformerConfig, dim: Optional[int] = None,
                 device=None):
        super().__init__()
        self.A = Norm(cfg, dim, device=device)
        self.B = Norm(cfg, dim, device=device)

    def forward(self, x: torch.Tensor, split: Split = None) -> torch.Tensor:
        return apply_split(self.A, self.B, x, split)
