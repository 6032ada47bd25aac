"""The one place a dropout mask is drawn (flax `nn.Dropout`'s and the
attention probabilities' `jax.random.bernoulli`): core/layers.py's
`dropout` and ops/attention.py's plain path both call `draw_keep`."""

from __future__ import annotations

import torch


def draw_keep(shape, rate: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """Keep flags of `shape`, bool, keep ~ Bernoulli(1 - rate), from
    `generator`."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate
