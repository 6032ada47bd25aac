"""TextDiffuser: text-rendering diffusion conditioned on a character mask
(port of unilm_tpu/models/textdiffuser.py).

- `render_char_mask` (numpy, a copy of JAX's): a layout of (text, box)
  pairs -> an [H, W] int mask, 0 background, c + 1 the charset index of
  the character whose column slice of the box covers the pixel.
- `TextDiffuserUNet`: the compact NHWC UNet over [noisy image, embedded
  mask] predicting ε. Its modules carry the flax auto-names (`Dense_0` /
  `Dense_1` of the time MLP, `mask_embed`, `stem`, `ResBlock_{i}`, the
  resampling `Conv_{i}`, the final `GroupNorm_0`, `out`), so a flax tree
  loads through convert/from_jax.py. GroupNorm has gcd(channels, 32)
  groups at eps 1e-6; each level but the last downsamples with a 3x3
  stride-2 "SAME" conv (flax pads an even side by (0, 1)); the decoder
  upsamples by nearest x2 (`jax.image.resize(..., "nearest")`: output i
  reads input i // 2) before a 3x3 conv; `out` starts at zero.
- `diffusion_loss` (DDPM ε-MSE at integer timesteps drawn uniformly) and
  `ddim_sample` (deterministic DDIM from noise over `steps` integer
  timesteps from T - 1 down to 0, ᾱ_next = 1 at the last step), both on
  LatentLM's cosine schedule.

The UNet launches no hand-written kernel (JAX's has no Pallas call).
Draws come from an explicit `torch.Generator`, or are given (`t=`,
`eps=`, `z=`) so that a test can replay JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import (ConvNHWC, GroupNormNHWC,
                                         head_dense, init_weights_)
from unilm_tpu_torch.models.latentlm import (cosine_alpha_bar,
                                             timestep_embedding)
from unilm_tpu_torch.runtime.device import resolve_device


def _gn(channels: int, device=None) -> GroupNormNHWC:
    return GroupNormNHWC(math.gcd(channels, 32) or 1, channels,
                         device=device)


# --------------------------------------------------------------------------- #
# Character layout mask
# --------------------------------------------------------------------------- #

DEFAULT_CHARSET = " abcdefghijklmnopqrstuvwxyz0123456789"


def render_char_mask(
    text_boxes: Sequence[Tuple[str, Tuple[int, int, int, int]]],
    img_size: int,
    charset: str = DEFAULT_CHARSET,
) -> np.ndarray:
    """[(text, (x0, y0, x1, y1)), ...] -> [H, W] int mask: 0 = background,
    c+1 = charset index of the character occupying that column slice of the
    box (each character gets an equal horizontal slice)."""
    mask = np.zeros((img_size, img_size), np.int32)
    c2i = {c: i for i, c in enumerate(charset)}
    for text, (x0, y0, x1, y1) in text_boxes:
        text = text.lower()
        n = max(len(text), 1)
        w = (x1 - x0) / n
        for i, ch in enumerate(text):
            if ch not in c2i:
                continue
            cx0 = int(x0 + i * w)
            cx1 = max(int(x0 + (i + 1) * w), cx0 + 1)
            mask[y0:y1, cx0:cx1] = c2i[ch] + 1
    return mask


# --------------------------------------------------------------------------- #
# Compact conditional UNet
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class TextDiffuserConfig:
    img_size: int = 64
    in_channels: int = 3          # pixel space (or VAE latent channels)
    base_channels: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 1
    charset_size: int = len(DEFAULT_CHARSET) + 1  # + background
    mask_channels: int = 8        # character-mask embedding channels
    time_dim: int = 128
    timesteps: int = 1000
    dtype: Any = torch.float32


class ResBlock(nn.Module):
    """GN -> SiLU -> 3x3 conv, + the time embedding's projection, GN ->
    SiLU -> 3x3 conv, + the input (a 1x1 `Conv_2` where the width
    changes). The convs and the projection compute in `dtype`; the norms
    in float32 (flax's promotion to their float32 params)."""

    def __init__(self, in_ch: int, channels: int, time_dim: int, dtype,
                 device=None):
        super().__init__()
        self.GroupNorm_0 = _gn(in_ch, device)
        self.Conv_0 = ConvNHWC(in_ch, channels, 3, dtype=dtype,
                               device=device)
        self.Dense_0 = head_dense(time_dim, channels, dtype=dtype,
                                  device=device)
        self.GroupNorm_1 = _gn(channels, device)
        self.Conv_1 = ConvNHWC(channels, channels, 3, dtype=dtype,
                               device=device)
        if in_ch != channels:
            self.Conv_2 = ConvNHWC(in_ch, channels, 1, dtype=dtype,
                                   device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x.float())))
        h = h + self.Dense_0(F.silu(temb))[:, None, None, :]
        h = self.Conv_1(F.silu(self.GroupNorm_1(h.float())))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class TextDiffuserUNet(nn.Module):
    """eps = unet(z_noisy [B, H, W, C], t [B] int, char_mask [B, H, W] int)."""

    def __init__(self, cfg: TextDiffuserConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        td, base, mults = cfg.time_dim, cfg.base_channels, cfg.channel_mults
        self.Dense_0 = head_dense(td, td, device=dev)
        self.Dense_1 = head_dense(td, td, device=dev)
        self.mask_embed = nn.Embedding(cfg.charset_size, cfg.mask_channels,
                                       device=dev)
        self.mask_embed.init_std = cfg.mask_channels ** -0.5
        self.stem = ConvNHWC(cfg.in_channels + cfg.mask_channels, base, 3,
                             device=dev)
        blocks, convs, skips = [], [], []
        ch = base
        for li, mult in enumerate(mults):
            for _ in range(cfg.num_res_blocks):
                blocks.append((ch, base * mult))
                ch = base * mult
            skips.append(ch)
            if li < len(mults) - 1:
                convs.append((ch, ch, 2))
        blocks.append((ch, ch))
        for li in reversed(range(len(mults))):
            ch_in = ch + skips[li]
            for _ in range(cfg.num_res_blocks):
                blocks.append((ch_in, base * mults[li]))
                ch_in = ch = base * mults[li]
            if li > 0:
                convs.append((ch, ch, 1))
        for i, (a, b) in enumerate(blocks):
            self.add_module(f"ResBlock_{i}",
                            ResBlock(a, b, td, cfg.dtype, device=dev))
        for i, (a, b, s) in enumerate(convs):
            self.add_module(f"Conv_{i}", ConvNHWC(a, b, 3, stride=s,
                                                  device=dev))
        self.GroupNorm_0 = _gn(ch, dev)
        self.out = ConvNHWC(ch, cfg.in_channels, 3, device=dev)

    def init_weights(self, generator: torch.Generator) -> "TextDiffuserUNet":
        """Random weights at the flax initialisers' scales from `generator`
        (on the parameters' device); `out` zero, as flax's zeros init."""
        init_weights_(self, generator)
        with torch.no_grad():
            self.out.weight.zero_()
        return self

    def forward(self, z_noisy: torch.Tensor, t: torch.Tensor,
                char_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        temb = self.Dense_0(timestep_embedding(t.float(), cfg.time_dim))
        temb = self.Dense_1(F.silu(temb))
        memb = self.mask_embed(char_mask.long()).to(z_noisy.dtype)
        x = self.stem(torch.cat([z_noisy, memb], dim=-1))
        blocks = iter(getattr(self, f"ResBlock_{i}") for i in range(
            2 * len(cfg.channel_mults) * cfg.num_res_blocks + 1))
        convs = iter(getattr(self, f"Conv_{i}") for i in range(
            2 * (len(cfg.channel_mults) - 1)))
        skips = []
        for li in range(len(cfg.channel_mults)):
            for _ in range(cfg.num_res_blocks):
                x = next(blocks)(x, temb)
            skips.append(x)
            if li < len(cfg.channel_mults) - 1:
                x = next(convs)(x)
        x = next(blocks)(x, temb)
        for li in reversed(range(len(cfg.channel_mults))):
            x = torch.cat([x, skips[li].to(x.dtype)], dim=-1)
            for _ in range(cfg.num_res_blocks):
                x = next(blocks)(x, temb)
            if li > 0:
                # nearest x2 (jax.image.resize "nearest"): out i <- in i // 2
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                x = next(convs)(x)
        x = self.GroupNorm_0(x.float())
        return self.out(F.silu(x))


# --------------------------------------------------------------------------- #
# Training loss + DDIM sampling
# --------------------------------------------------------------------------- #

def diffusion_loss(model: TextDiffuserUNet, images: torch.Tensor,
                   char_mask: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ε-prediction MSE at timesteps t ~ U{0..T-1} (DDPM): (loss,
    {"mse": loss}). t [B] and eps (images' shape) are drawn from
    `generator` unless given."""
    cfg = model.cfg
    B = images.shape[0]
    if t is None:
        t = torch.randint(0, cfg.timesteps, (B,), generator=generator,
                          device=images.device)
    if eps is None:
        eps = torch.randn(images.shape, generator=generator,
                          device=images.device).to(images.dtype)
    ab = cosine_alpha_bar(t.float() / cfg.timesteps)[:, None, None, None]
    z_noisy = torch.sqrt(ab) * images + torch.sqrt(1.0 - ab) * eps
    pred = model(z_noisy, t, char_mask)
    loss = torch.mean((pred - eps) ** 2)
    return loss, {"mse": loss}


def ddim_timesteps(timesteps: int, steps: int) -> list:
    """The integer timesteps of a DDIM run: JAX's float32 `linspace(T - 1,
    0, steps)` truncated to int32, computed the same way."""
    if steps == 1:
        return [timesteps - 1]
    frac = torch.arange(steps - 1, dtype=torch.float32) / (steps - 1)
    ts = (timesteps - 1) * (1 - frac)
    return ts.to(torch.int64).tolist() + [0]


@torch.no_grad()
def ddim_sample(model: TextDiffuserUNet, char_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                steps: int = 20, shape=None,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic DDIM from pure noise z (drawn from `generator` unless
    given), conditioned on the char mask [B, H, W]."""
    cfg = model.cfg
    B = char_mask.shape[0]
    shape = shape or (B, cfg.img_size, cfg.img_size, cfg.in_channels)
    if z is None:
        z = torch.randn(shape, generator=generator, device=char_mask.device)
    ts = ddim_timesteps(cfg.timesteps, steps)
    # ᾱ of every step (float32 t / T, as JAX's), and 1 after the last
    ab_all = cosine_alpha_bar(torch.tensor(
        ts, dtype=torch.float32) / cfg.timesteps).tolist() + [1.0]
    for i, t in enumerate(ts):
        ab, ab_next = (torch.tensor(a, dtype=torch.float32, device=z.device)
                       for a in ab_all[i:i + 2])
        eps = model(z, torch.full((B,), t, device=z.device), char_mask)
        x0 = (z - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)
        z = torch.sqrt(ab_next) * x0 + torch.sqrt(1.0 - ab_next) * eps
    return z
