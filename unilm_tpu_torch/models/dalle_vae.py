"""DALL-E discrete VAE encoder, BEiT's visual tokenizer (port of
unilm_tpu/models/dalle_vae.py: `map_pixels` :28, `DalleEncoderConfig`
:34, `EncoderBlock` :44 and `DalleEncoder` :72).

The OpenAI DALL-E encoder (beit/dall_e/encoder.py): an input conv 7x7,
then group_count groups of n_blk_per_group `EncoderBlock`s (channels
n_hid x 1, 2, 4, 8; each block's residual path scaled by 1 / n_layers^2;
a 2x2 max pool between groups), then relu and a 1x1 conv to the vocab
logits, whose argmax are the visual token ids BEiT predicts at masked
patches. `convert/dalle.py` loads a released encoder.pkl.

Images are NHWC [B, H, W, C] in [0, 1] at the public functions and the
logits NHWC [B, H/8, W/8, V], as in JAX; inside, the activations are
NCHW and every convolution is `F.conv2d` (the JAX package computes these
convolutions in XLA, outside any Pallas kernel). Weights are OIHW, the
layout of the torch checkpoint. flax's "SAME" padding is reproduced,
asymmetric where it is (`Conv2d`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

LOGIT_LAPLACE_EPS = 0.1


def map_pixels(x: torch.Tensor) -> torch.Tensor:
    """dall_e/utils.py map_pixels: squeeze [0, 1] into the logit-Laplace
    range."""
    return (1.0 - 2.0 * LOGIT_LAPLACE_EPS) * x + LOGIT_LAPLACE_EPS


def same_padding(n: int, k: int, s: int):
    """flax / lax "SAME" padding of one spatial axis: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """A flax nn.Conv with "SAME" padding on NCHW activations: weight
    [O, I, kh, kw] and bias [O] float32 (convert/from_jax.py turns the
    flax HWIO kernel into this layout), computing in `dtype`."""

    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.k, self.stride, self.compute_dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(n_out, n_in, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        ph = same_padding(x.shape[2], self.k, self.stride)
        pw = same_padding(x.shape[3], self.k, self.stride)
        x = x.to(dt)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x, pad = F.pad(x, (pw[0], pw[1], ph[0], ph[1])), 0
        return F.conv2d(x, self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride, padding=pad)


@torch.no_grad()
def init_convs(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every `Conv2d` under `module` lecun-normal (flax's Conv default),
    its bias zero. Returns `module`."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                             generator=generator)
            m.bias.zero_()
    return module


@dataclasses.dataclass(frozen=True)
class DalleEncoderConfig:
    group_count: int = 4
    n_hid: int = 256
    n_blk_per_group: int = 2
    input_channels: int = 3
    vocab_size: int = 8192
    dtype: Any = torch.float32


class EncoderBlock(nn.Module):
    """id_path (a 1x1 conv where the width changes) + post_gain x
    (relu, conv 3x3, relu, conv 3x3, relu, conv 3x3, relu, conv 1x1)."""

    def __init__(self, n_in: int, n_out: int, n_layers: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = 1.0 / (n_layers ** 2)
        conv = lambda i, o, k: Conv2d(i, o, k, dtype=dtype, device=device)
        if n_in != n_out:
            self.id_path = conv(n_in, n_out, 1)
        self.conv_1 = conv(n_in, n_hid, 3)
        self.conv_2 = conv(n_hid, n_hid, 3)
        self.conv_3 = conv(n_hid, n_hid, 3)
        self.conv_4 = conv(n_hid, n_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ident = self.id_path(x) if hasattr(self, "id_path") else x
        h = self.conv_1(F.relu(x))
        h = self.conv_2(F.relu(h))
        h = self.conv_3(F.relu(h))
        h = self.conv_4(F.relu(h))
        return ident + self.post_gain * h


class DalleEncoder(nn.Module):
    """images [B, H, W, C] in [0, 1] -> vocab logits [B, H/8, W/8, V],
    float32 (the output conv computes in float32 whatever cfg.dtype)."""

    def __init__(self, cfg: DalleEncoderConfig = DalleEncoderConfig(),
                 device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        n_layers = cfg.group_count * cfg.n_blk_per_group
        self.input = Conv2d(cfg.input_channels, cfg.n_hid, 7, dtype=dt,
                            device=device)
        n_in = cfg.n_hid
        for gi, m in enumerate([1, 2, 4, 8][:cfg.group_count], start=1):
            for bi in range(1, cfg.n_blk_per_group + 1):
                self.add_module(f"group_{gi}_block_{bi}", EncoderBlock(
                    n_in, m * cfg.n_hid, n_layers, dt, device))
                n_in = m * cfg.n_hid
        self.output = Conv2d(n_in, cfg.vocab_size, 1, dtype=torch.float32,
                             device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = map_pixels(images.to(cfg.dtype)).permute(0, 3, 1, 2)
        x = self.input(x)
        for gi in range(1, cfg.group_count + 1):
            for bi in range(1, cfg.n_blk_per_group + 1):
                x = getattr(self, f"group_{gi}_block_{bi}")(x)
            if gi < cfg.group_count:
                x = F.max_pool2d(x, 2, 2)
        return self.output(F.relu(x)).permute(0, 2, 3, 1)

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H/8 * W/8] visual token ids (modeling_discrete_vae.py:223)."""
        logits = self(images)
        return logits.argmax(-1).reshape(logits.shape[0], -1)

    def init_weights(self, generator: torch.Generator) -> "DalleEncoder":
        """Random weights (`init_convs`)."""
        return init_convs(self, generator)
