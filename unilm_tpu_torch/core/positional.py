"""xPos/SoPE rotary, the length-extrapolation rescale and T5 relative
position buckets (port of unilm_tpu/core/positional.py:28-94,
`relative_position_bucket` :102 and `RelativePositionBias` :133).

The rotation is the INTERLEAVED every-two rotation of torchscale
([-x2, x1, -x4, x3, ...]), not the half-split rotation of HF Llama.
sin, cos and the xPos decay scale are computed in float32 — the scale
`base**(pos/512)` reaches ~1e2 for keys at positions in the thousands —
and `apply_xpos` casts back to the input dtype once, at the end.
"""

from __future__ import annotations

import math

import torch


def xpos_scale(head_dim: int, device=None) -> torch.Tensor:
    """Per-frequency decay base: (arange(0,d,2) + 0.4d) / (1.4d).  [d/2]"""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return (ar + 0.4 * head_dim) / (1.4 * head_dim)


def xpos_sin_cos_scale(positions: torch.Tensor, center: float, head_dim: int,
                       scale_base: int = 512):
    """(sin, cos, scale), each float32 [L, d/2], for integer positions [L]."""
    pos = positions.to(torch.float32)
    half = head_dim // 2
    base = xpos_scale(head_dim, pos.device)
    power = (pos - center)[:, None] / scale_base
    scale = base[None, :] ** power
    ar = torch.arange(0, half, dtype=torch.float32, device=pos.device)
    inv_freq = 1.0 / (10000 ** (ar / half))
    sinusoid = pos[:, None] * inv_freq[None, :]
    return torch.sin(sinusoid), torch.cos(sinusoid), scale


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1, -x4, x3, ...] on the last dim."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def _duplicate_interleave(m: torch.Tensor) -> torch.Tensor:
    """[L, d/2] -> [L, d]: (a, b) -> (a, a, b, b)."""
    return torch.repeat_interleave(m, 2, dim=-1)


def rotary_tables(sin: torch.Tensor, cos: torch.Tensor, scale):
    """(sin*scale, cos*scale) duplicate-interleaved to float32 [L, d]."""
    return (_duplicate_interleave(sin * scale),
            _duplicate_interleave(cos * scale))


def apply_rotary(x: torch.Tensor, sin_d: torch.Tensor,
                 cos_d: torch.Tensor) -> torch.Tensor:
    """x*cos + rot(x)*sin with tables from `rotary_tables` broadcast against
    x. Float32 math, cast to x.dtype once."""
    return (x * cos_d + _rotate_every_two(x) * sin_d).to(x.dtype)


def apply_xpos(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               scale) -> torch.Tensor:
    """x*cos + rot(x)*sin on [..., L, d], sin/cos pre-multiplied by the xPos
    scale (pass 1/scale for keys). Float32 math, cast to x.dtype once."""
    return apply_rotary(x, *rotary_tables(sin, cos, scale))


def length_extrapolation_qscale(q_positions: torch.Tensor, k_len: int,
                                scale_length: int) -> torch.Tensor:
    """max(1, log(pos)/log(scale_length)) per query when k_len >
    scale_length, else ones. Float32 [Lq]."""
    pos = torch.clamp(q_positions.to(torch.float32), min=1.0)
    if k_len <= scale_length:
        return torch.ones_like(pos)
    return torch.clamp(torch.log(pos) / math.log(scale_length), min=1.0)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool = True,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5 log-bucketing of (memory_pos - query_pos), in the input's integer
    dtype: exact buckets below num_buckets/4 (per direction when
    bidirectional), logarithmic ones up to max_distance, the last bucket
    beyond. LayoutLMv3's 1D and 2D relative biases use it
    (models/layoutlmv3.py)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(ret.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(torch.nn.Module):
    """T5's learned bucketed bias (JAX `RelativePositionBias` :133):
    `relative_attention_bias` [num_buckets, heads] looked up at the bucket
    of (memory position - query position) -> [1, heads, qlen, klen] in
    `dtype`. `step` offsets the query positions: a decoder's prefill and
    decode rows sit at step..step+qlen-1 against klen cache slots."""

    def __init__(self, num_buckets: int = 32, max_distance: int = 128,
                 num_heads: int = 12, bidirectional: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.bidirectional, self.dtype = bidirectional, dtype
        self.relative_attention_bias = torch.nn.Parameter(
            torch.zeros(num_buckets, num_heads, device=device))

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        """normal(0.02), the flax initialiser."""
        self.relative_attention_bias.normal_(0.0, 0.02, generator=generator)

    def forward(self, qlen: int, klen: int, step: int = 0) -> torch.Tensor:
        dev = self.relative_attention_bias.device
        context = step + torch.arange(qlen, device=dev)[:, None]
        memory = torch.arange(klen, device=dev)[None, :]
        bucket = relative_position_bucket(
            memory - context, bidirectional=self.bidirectional,
            num_buckets=self.num_buckets, max_distance=self.max_distance)
        values = self.relative_attention_bias[bucket]  # [q, k, heads]
        return values.permute(2, 0, 1)[None].to(self.dtype)
