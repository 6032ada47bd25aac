"""LatentLM with its σ-VAE (port of unilm_tpu/models/latentlm.py).

Images become continuous latents through a σ-VAE (a fixed-variance
posterior); a causal decoder runs over text tokens with the latents
spliced into their slots; text positions train with cross-entropy on the
tied embedding and latent positions with a diffusion head (an
ε-prediction MLP conditioned on the hidden state before the slot);
generation samples each latent by DDIM and the VAE decodes it.

- `SigmaVAE` (JAX :36-77): NHWC, 4x4 stride-2 "SAME" convs `enc_{i}`,
  the 1x1 `to_latent`, 4x4 stride-2 "SAME" transposed convs `dec_{i}`
  (core/layers.py `ConvTransposeNHWC`: convert/from_jax.py loads their
  kernels flipped by the module's type) and the 3x3 `to_rgb`, float32.
- `LatentLM.backbone` (JAX :152-159) splices `latent_in(latents)` into the
  token embeddings (models/kosmos.py `splice_image_features`) and runs
  the core `Decoder` (swiglu, RMSNorm, no bias, xPos, causal): on a CUDA
  tensor with `use_flash` the flash kernels, forward and backward.
- The train forward's conditioning gather (JAX :161-185): the k-th
  latent slot of a row is conditioned on the hidden state at the
  position before it; an `index_add_` into a [B, Q + 1, D] buffer, where
  positions that are no latent slot go to row Q and are dropped.

Draws: the train forward draws t ~ U[0, 1) and the noise, `sample_latent`
its starting z, each from an explicit `torch.Generator`; both also take
the draws themselves (`t=`, `noise=`, `z=`), so that a test can replay
JAX's.

`sample_latent` reproduces the reference's schedule: it starts at t = 1,
where `cosine_alpha_bar` is ~1.9e-15 in float32, so its first step
divides by sqrt(ᾱ) ~ 4.4e-8 and the latents it returns are ~1e7 in
magnitude. That is a fault of the reference (ROADMAP, "Faults of the
reference itself"); the port reproduces it and does not clamp it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import (ConvNHWC, ConvTransposeNHWC,
                                         head_dense, init_weights_)
from unilm_tpu_torch.core.transformer import Decoder
from unilm_tpu_torch.models.kosmos import splice_image_features
from unilm_tpu_torch.runtime.device import resolve_device


# --------------------------------------------------------------------------- #
# σ-VAE
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class SigmaVAEConfig:
    latent_dim: int = 16
    channels: Tuple[int, ...] = (64, 128, 256)
    sigma: float = 0.1  # fixed posterior std (the σ in σ-VAE)


class SigmaVAE(nn.Module):
    """The σ-VAE tokenizer over NHWC images in [B, H, W, 3]: each 4x4
    stride-2 conv halves the side, so a 128 px image gives a 16 x 16 grid
    of latents with the three default channel widths."""

    def __init__(self, cfg: SigmaVAEConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        chans = (3,) + tuple(cfg.channels)
        for i in range(len(cfg.channels)):
            self.add_module(f"enc_{i}", ConvNHWC(chans[i], chans[i + 1], 4,
                                                 stride=2, device=dev))
        self.to_latent = ConvNHWC(chans[-1], cfg.latent_dim, 1, device=dev)
        rev = (cfg.latent_dim,) + tuple(reversed(cfg.channels))
        for i in range(len(cfg.channels)):
            self.add_module(f"dec_{i}", ConvTransposeNHWC(
                rev[i], rev[i + 1], 4, stride=2, device=dev))
        self.to_rgb = ConvNHWC(rev[-1], 3, 3, device=dev)

    def init_weights(self, generator: torch.Generator) -> "SigmaVAE":
        init_weights_(self, generator)
        return self

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> the posterior mean [B, h, w, latent_dim]."""
        x = images
        for i in range(len(self.cfg.channels)):
            x = F.silu(getattr(self, f"enc_{i}")(x))
        return self.to_latent(x)

    def sample_posterior(self, mean: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """mean + σ noise, the noise drawn from `generator` unless given."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        return mean + self.cfg.sigma * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for i in range(len(self.cfg.channels)):
            x = F.silu(getattr(self, f"dec_{i}")(x))
        return self.to_rgb(x)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """(recon, recon_loss, kl): the KL of N(mean, σ²I) || N(0, I) at a
        fixed σ, 0.5 mean(mean² + σ² - 1 - 2 log σ)."""
        mean = self.encode(images)
        recon = self.decode(self.sample_posterior(mean, generator, noise))
        recon_loss = torch.mean((recon - images) ** 2)
        s2 = self.cfg.sigma ** 2
        kl = 0.5 * torch.mean(mean ** 2 + s2 - 1.0 - math.log(s2))
        return recon, recon_loss, kl


# --------------------------------------------------------------------------- #
# diffusion utilities (cosine schedule, timestep embedding, the head)
# --------------------------------------------------------------------------- #


def cosine_alpha_bar(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    """ᾱ(t) for t in [0, 1] (improved-DDPM cosine schedule)."""
    f = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
    f0 = math.cos(s / (1 + s) * math.pi / 2) ** 2
    return f / f0


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., dim]: sin then cos of t times exp(-log(10000) i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DiffusionHead(nn.Module):
    """ε-prediction MLP conditioned on the decoder's hidden state: fc1 and
    fc2 (SiLU) over [z_noisy, timestep embedding, cond], then `out`;
    float32, as the flax Dense layers."""

    def __init__(self, latent_dim: int, model_dim: int, hidden: int = 256,
                 time_dim: int = 64, device=None):
        super().__init__()
        self.time_dim = time_dim
        self.fc1 = head_dense(latent_dim + time_dim + model_dim, hidden,
                              device=device)
        self.fc2 = head_dense(hidden, hidden, device=device)
        self.out = head_dense(hidden, latent_dim, device=device)

    def forward(self, z_noisy: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        """z_noisy [..., latent], t [...] in [0, 1], cond [..., model_dim]."""
        te = timestep_embedding(t, self.time_dim)
        h = torch.cat([z_noisy.float(), te, cond.float()], dim=-1)
        h = F.silu(self.fc1(h))
        h = F.silu(self.fc2(h))
        return self.out(h)


# --------------------------------------------------------------------------- #
# LatentLM
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LatentLMConfig:
    vocab_size: int = 32000
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 2048
    latent_dim: int = 16
    dtype: Any = torch.float32
    use_flash: bool = True

    def decoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            activation="swiglu", norm_type="rmsnorm", use_bias=False,
            xpos_rel_pos=True, dtype=self.dtype, use_flash=self.use_flash,
        )


class LatentLM(nn.Module):
    """Causal LM over interleaved text tokens and continuous latents.

    Inputs: tokens [B, T], the latent slots marked by latent_mask [B, T]
    (bool), latents [B, Q, latent_dim] filling the marked slots in order.
    Parameters: `embed_tokens` (normal(E^-0.5), tied to the text head),
    `latent_in`, `decoder` and `diffusion_head`, float32 (the decoder
    computes in cfg.dtype)."""

    def __init__(self, cfg: LatentLMConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        E = cfg.embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=dev)
        self.embed_tokens.init_std = E ** -0.5
        self.latent_in = head_dense(cfg.latent_dim, E, device=dev)
        self.decoder = Decoder(cfg.decoder_cfg(), device=dev)
        self.diffusion_head = DiffusionHead(cfg.latent_dim, E, device=dev)

    def init_weights(self, generator: torch.Generator) -> "LatentLM":
        """Random weights at the JAX initialisers' scales from `generator`
        (on the parameters' device)."""
        init_weights_(self, generator)
        return self

    def backbone(self, tokens: torch.Tensor, latents: Optional[torch.Tensor],
                 latent_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The decoder's last hidden states [B, T, E] in cfg.dtype."""
        emb = self.embed_tokens(tokens)
        if latents is not None:
            emb = splice_image_features(emb, self.latent_in(latents),
                                        latent_mask)
        return self.decoder(emb, causal=True)

    def text_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The tied head (flax `embed_tokens.attend`): float32 logits."""
        return F.linear(h.float(), self.embed_tokens.weight)

    def forward(self, tokens: torch.Tensor, latents: torch.Tensor,
                latent_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None):
        """Training: (text logits [B, T, V], the diffusion ε-loss over the
        latent slots, each conditioned on the hidden state before it). t
        [B, Q] and noise [B, Q, latent_dim] are drawn from `generator`
        unless given."""
        h = self.backbone(tokens, latents, latent_mask)
        B, Q, LD = latents.shape
        D = h.shape[-1]
        prev_h = F.pad(h, (0, 0, 1, 0))[:, :-1]
        take = torch.where(latent_mask[..., None], prev_h,
                           torch.zeros((), dtype=h.dtype, device=h.device))
        # the k-th latent slot of a row -> cond[:, k]; other positions -> Q
        idx = torch.cumsum(latent_mask.to(torch.int64), dim=1) - 1
        order = torch.where(latent_mask, idx, torch.full_like(idx, Q))
        flat = (order + (Q + 1) * torch.arange(
            B, device=h.device)[:, None]).reshape(-1)
        cond = torch.zeros(B * (Q + 1), D, dtype=h.dtype, device=h.device)
        cond = cond.index_add(0, flat, take.reshape(-1, D))
        cond = cond.view(B, Q + 1, D)[:, :Q]

        if t is None:
            t = torch.rand((B, Q), generator=generator, device=h.device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=h.device)
        ab = cosine_alpha_bar(t)[..., None]
        z_noisy = torch.sqrt(ab) * latents + torch.sqrt(1 - ab) * noise
        eps = self.diffusion_head(z_noisy, t, cond)
        diff_loss = torch.mean((eps - noise) ** 2)
        return self.text_logits(h), diff_loss

    @torch.no_grad()
    def sample_latent(self, cond: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      steps: int = 20, z: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """DDIM sampling of one latent per condition row [B, D_model] from
        t = 1 to 0 in `steps` steps; z [B, latent_dim] ~ N(0, I) drawn from
        `generator` unless given."""
        if z is None:
            z = torch.randn((cond.shape[0], self.cfg.latent_dim),
                            generator=generator, device=cond.device)
        return ddim_latents(self.diffusion_head, cond, z, steps)


@torch.no_grad()
def ddim_latents(head: DiffusionHead, cond: torch.Tensor, z: torch.Tensor,
                 steps: int) -> torch.Tensor:
    """`LatentLM.sample_latent`'s loop (JAX :196-210): DDIM from z [B,
    latent_dim] over t = linspace(1, 0, steps + 1), ε from `head`."""
    B = cond.shape[0]
    ts = torch.linspace(1.0, 0.0, steps + 1, device=cond.device)
    for i in range(steps):
        t_now = ts[i].expand(B)
        ab_now = cosine_alpha_bar(t_now)[..., None]
        ab_next = cosine_alpha_bar(ts[i + 1].expand(B))[..., None]
        eps = head(z, t_now, cond)
        z0 = (z - torch.sqrt(1 - ab_now) * eps) / torch.sqrt(ab_now)
        z = torch.sqrt(ab_next) * z0 + torch.sqrt(1 - ab_next) * eps
    return z
