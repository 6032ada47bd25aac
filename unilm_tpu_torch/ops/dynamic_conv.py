"""Lightweight and dynamic convolution (port of
unilm_tpu/ops/dynamic_conv.py): fairseq's LightConv / DynamicConv,
depthwise softmax-normalised convolutions where DynamicConv predicts each
time step's kernel from the input.

In JAX these are banded einsums with no Pallas kernel, so the port writes
them in plain torch, on the input's device: a gather of each output's K
inputs ([B, T, K, C]) and one einsum.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import head_dense


def _band_gather(x: torch.Tensor, kernel_size: int,
                 padding_l: int) -> torch.Tensor:
    """[B, T, C] -> [B, T, K, C]: the window of K inputs feeding output t."""
    T = x.shape[1]
    pad_r = kernel_size - 1 - padding_l
    xp = F.pad(x, (0, 0, padding_l, max(pad_r, 0)))
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(kernel_size, device=x.device)[None, :])
    return xp[:, idx]


def light_conv(x: torch.Tensor, weight: torch.Tensor, num_heads: int,
               padding_l: Optional[int] = None, softmax: bool = True,
               causal: bool = False) -> torch.Tensor:
    """LightConv over x [B, T, C]: a depthwise conv whose kernel weight
    [H, K] is shared by the C / H channels of each head."""
    C = x.shape[-1]
    H, K = weight.shape
    if padding_l is None:
        padding_l = K - 1 if causal else K // 2
    w = torch.softmax(weight, dim=-1) if softmax else weight
    windows = _band_gather(x, K, padding_l)
    wc = torch.repeat_interleave(w, C // H, dim=0).T  # [K, C]
    return torch.einsum("btkc,kc->btc", windows, wc)


def dynamic_conv(x: torch.Tensor, weights: torch.Tensor,
                 padding_l: Optional[int] = None, softmax: bool = True,
                 causal: bool = True) -> torch.Tensor:
    """DynamicConv over x [B, T, C] with per-position kernels weights [B,
    T, H, K] (fairseq's dynamicconv_layer)."""
    B, T, C = x.shape
    H, K = weights.shape[2], weights.shape[3]
    if padding_l is None:
        padding_l = K - 1 if causal else K // 2
    w = torch.softmax(weights, dim=-1) if softmax else weights
    windows = _band_gather(x, K, padding_l).reshape(B, T, K, H, C // H)
    return torch.einsum("btkhd,bthk->bthd", windows, w).reshape(B, T, C)


class DynamicConvLayer(nn.Module):
    """fairseq's DynamicConv module: the GLU input projection `in_proj`,
    the predicted kernels `weight_linear` (no bias), the depthwise dynamic
    conv and `out_proj`; float32, as the flax Dense layers."""

    def __init__(self, dim: int, kernel_size: int = 7, num_heads: int = 8,
                 causal: bool = True, device=None):
        super().__init__()
        self.kernel_size, self.num_heads, self.causal = (kernel_size,
                                                         num_heads, causal)
        self.in_proj = head_dense(dim, 2 * dim, device=device)
        self.weight_linear = head_dense(dim, num_heads * kernel_size,
                                        bias=False, device=device)
        self.out_proj = head_dense(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.glu(self.in_proj(x), dim=-1)
        B, T, _ = h.shape
        w = self.weight_linear(h).reshape(B, T, self.num_heads,
                                          self.kernel_size)
        return self.out_proj(dynamic_conv(h, w, causal=self.causal))
