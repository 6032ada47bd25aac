"""Embedding front-ends (port of unilm_tpu/core/embedding.py
`TextEmbedding` :18, `PositionalEmbedding` :41, `PatchEmbed` :62 and
`VisionEmbedding` :90).

Images keep the JAX package's NHWC layout [B, H, W, C] at the public
functions. The patchify is the product of each flattened p x p x C patch,
in (kh, kw, C) order, with `proj.weight` [E, p*p*C]: a reshape and one
`F.linear`, not `F.conv2d`. It is the same product as flax's stride-p
VALID convolution, and it keeps float32 inputs on a float32 matrix product
where cuDNN would run the convolution in TF32 by default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class TextEmbedding(nn.Module):
    """Token embedding: a float32 table (`embed.weight`, the flax
    `embed/embedding`, initialised normal(embed_dim^-0.5)) looked up and
    cast to `dtype`."""

    def __init__(self, vocab_size: int, embed_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_dim, device=device)
        self.embed.init_std = embed_dim ** -0.5

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed(ids).to(self.compute_dtype)


class PositionalEmbedding(nn.Module):
    """Learned positions: a float32 table `weight` [max_positions + offset,
    embed_dim] (the flax `embedding`), read at positions + offset and cast
    to `dtype`. `offset` is fairseq's padding_idx + 1 shift, so converted
    checkpoints line up."""

    def __init__(self, max_positions: int, embed_dim: int, offset: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.offset = offset
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(max_positions + offset,
                                               embed_dim, device=device))

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return self.weight[positions + self.offset].to(self.compute_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """normal(embed_dim^-0.5), the flax initialiser."""
        self.weight.normal_(0.0, self.weight.shape[1] ** -0.5,
                            generator=generator)


def patchify(images: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], each patch flattened in
    (kh, kw, C) order, patches in row-major order."""
    B, Hh, Ww, C = images.shape
    h, w = Hh // p, Ww // p
    x = images[:, :h * p, :w * p].reshape(B, h, p, w, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, h * w, p * p * C)


class PatchProjection(nn.Module):
    """The flax Conv `proj` of PatchEmbed as a linear map over flattened
    patches: weight [E, p*p*C] (the flax kernel [p, p, C, E] reshaped and
    transposed, convert/from_jax.py), bias [E]. Float32 params computing in
    `dtype`, as the flax Conv with dtype=cfg.dtype does."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, *,
                 dtype, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            embed_dim, patch_size * patch_size * in_chans, device=device))
        self.bias = nn.Parameter(torch.zeros(embed_dim, device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = patchify(images.to(dt), self.patch_size)
        return F.linear(x, self.weight.to(dt), self.bias.to(dt))


class PatchEmbed(nn.Module):
    """Patchify: [B, H, W, C] -> [B, (H/p)*(W/p), E]."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 in_chans: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = PatchProjection(patch_size, in_chans, embed_dim,
                                    dtype=dtype, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.proj(images)


class VisionEmbedding(nn.Module):
    """PatchEmbed + optional cls token + optional mask-token substitution
    (BEiT pretraining). The tokens are float32 params cast to the compute
    dtype. Like the flax module, which creates `mask_token` only when it
    is called with a mask, the mask token exists only with
    use_mask_token."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, use_cls_token: bool = True,
                 use_mask_token: bool = False, dtype=torch.float32,
                 in_chans: int = 3, device=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, in_chans, dtype,
                                      device=device)
        if use_mask_token:
            self.mask_token = nn.Parameter(
                torch.zeros(1, 1, embed_dim, device=device))
        if use_cls_token:
            self.cls_token = nn.Parameter(
                torch.zeros(1, 1, embed_dim, device=device))

    def forward(self, images: torch.Tensor,
                bool_masked_pos: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.patch_embed(images)
        B, N, E = x.shape
        if hasattr(self, "mask_token") and bool_masked_pos is not None:
            m = bool_masked_pos[..., None].to(x.dtype)
            x = x * (1.0 - m) + self.mask_token.to(x.dtype) * m
        if hasattr(self, "cls_token"):
            cls = self.cls_token.to(x.dtype).expand(B, 1, E)
            x = torch.cat([cls, x], dim=1)
        return x
