"""BEiT-2: the VQ-KD visual tokenizer and CLS pretraining (port of
unilm_tpu/models/beit2.py: `l2norm` :29, `NormEMAVectorQuantizer` :33,
`VQKDConfig` :82, `VQKD` :112, `DiscreteVAE` :152 and
`BEiT2ForMaskedImageModelingCLS` :177 with `Beit2PretrainConfig` :212).

- `NormEMAVectorQuantizer` (beit2/norm_ema_quantizer.py): an
  l2-normalised codebook updated by an exponential moving average with
  Laplace-smoothed cluster counts. The JAX `ema` collection (`embedding`,
  `cluster_size`) is two registered buffers here, updated in place under
  `torch.no_grad()` only when a call passes `update_ema=True`; the
  gradient is straight-through.
- `VQKD` (beit2/modeling_vqkd.py): a ViT encoder -> the Linear-tanh-Linear
  bottleneck -> the quantizer -> a ViT decoder regressing teacher (CLIP)
  features. `get_codebook_indices` gives BEiT-2's pretraining targets.
  Its encoder attention is the encoder kernel #3 on the card.
- `DiscreteVAE`: the small conv tokenizer (beit/modeling_discrete_vae.py),
  on models/dalle_vae.py's `Conv2d`.
- `BEiT2ForMaskedImageModelingCLS` (beit2/modeling_pretrain.py:266): the
  BEiT backbone with one shared rel-pos bias and the mask token, `norm`
  and `lm_head` over the final patch states, and `lm_head_cls` over the
  early layer's patch states (see its docstring for where this departs
  from what the reference describes).

Dtypes follow flax's promotion in the JAX modules: the encoders compute
in `cfg.dtype`; the VQ-KD bottleneck, decoder input and task layers (flax
dtype=None over float32 params) and so the quantizer in float32; the
pretraining `norm` and heads in `cfg.dtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import VisionEmbedding
from unilm_tpu_torch.core.layers import Norm, head_dense, init_weights_
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.beit import BeitBackbone, BeitConfig, init_beit
from unilm_tpu_torch.models.dalle_vae import Conv2d, init_convs


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


class NormEMAVectorQuantizer(nn.Module):
    """z [..., D] -> (quantized, commitment loss, indices [...]).

    The nearest code by the squared distance on l2-normalised vectors
    (the JAX expression, so near-ties resolve alike; argmin takes the
    first of equal values in both). With `update_ema=True` the buffers
    move after the lookup: cluster_size <- decay * cluster_size + (1 -
    decay) * counts, Laplace-smoothed; each used code's row <-
    l2norm(decay * row + (1 - decay) * l2norm(mean of its vectors)).
    The returned values use the codebook as it was before the update."""

    def __init__(self, num_tokens: int = 8192, codebook_dim: int = 32,
                 beta: float = 1.0, decay: float = 0.99, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_tokens, self.codebook_dim = num_tokens, codebook_dim
        self.beta, self.decay, self.eps = beta, decay, eps
        self.register_buffer("embedding", l2norm(torch.randn(
            num_tokens, codebook_dim, device=device)))
        self.register_buffer("cluster_size",
                             torch.zeros(num_tokens, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """A fresh codebook: l2norm(normal), cluster sizes 0."""
        self.embedding.copy_(l2norm(torch.randn(
            self.embedding.shape, generator=generator,
            device=self.embedding.device)))
        self.cluster_size.zero_()

    @torch.no_grad()
    def _update(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        N, emb = self.num_tokens, self.embedding
        counts = torch.bincount(idx, minlength=N).to(flat.dtype)
        embed_sum = torch.zeros_like(emb).index_add_(0, idx, flat)
        cluster = self.cluster_size * self.decay + counts * (1 - self.decay)
        n = cluster.sum()
        smoothed = (cluster + self.eps) / (n + N * self.eps) * n
        mean = embed_sum / counts.clamp(min=1.0)[:, None]
        updated = emb * self.decay + l2norm(mean) * (1 - self.decay)
        updated = torch.where((counts > 0)[:, None], l2norm(updated), emb)
        self.embedding.copy_(updated)
        self.cluster_size.copy_(smoothed)

    def forward(self, z: torch.Tensor, update_ema: bool = False):
        flat = l2norm(z.reshape(-1, self.codebook_dim))
        emb = self.embedding.to(flat.dtype)
        d = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ emb.T
             + (emb ** 2).sum(1)[None])
        idx = d.argmin(1)
        quant = emb[idx]
        if update_ema:
            self._update(flat.detach(), idx)
        loss = self.beta * ((quant - flat) ** 2).mean()
        quant = flat + (quant - flat).detach()  # straight-through
        return quant.reshape(z.shape), loss, idx.reshape(z.shape[:-1])


@dataclasses.dataclass(frozen=True)
class VQKDConfig:
    img_size: int = 224
    patch_size: int = 16
    encoder_dim: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    decoder_dim: int = 768
    decoder_layers: int = 3
    decoder_heads: int = 12
    codebook_size: int = 8192
    codebook_dim: int = 32
    teacher_dim: int = 512  # CLIP feature dim (modeling_vqkd.py:179-221)
    dtype: Any = torch.float32
    use_flash: bool = True

    def enc_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.encoder_dim, ffn_dim=self.encoder_dim * 4,
            num_layers=self.encoder_layers, num_heads=self.encoder_heads,
            normalize_before=True, dtype=self.dtype, use_flash=self.use_flash)

    def dec_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.decoder_dim, ffn_dim=self.decoder_dim * 4,
            num_layers=self.decoder_layers, num_heads=self.decoder_heads,
            normalize_before=True, dtype=self.dtype, use_flash=self.use_flash)


class VQKD(nn.Module):
    """Visual tokenizer: encode -> quantize -> decode to teacher
    features. `forward` returns (reconstructed features [B, N,
    teacher_dim], the commitment loss, ids [B, N])."""

    def __init__(self, cfg: VQKDConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder_embed = VisionEmbedding(
            cfg.img_size, cfg.patch_size, cfg.encoder_dim,
            use_cls_token=False, dtype=cfg.dtype, device=device)
        self.encoder = Encoder(cfg.enc_cfg(), device=device)
        self.encode_task_1 = head_dense(cfg.encoder_dim, cfg.encoder_dim,
                                        device=device)
        self.encode_task_2 = head_dense(cfg.encoder_dim, cfg.codebook_dim,
                                        device=device)
        self.quantize = NormEMAVectorQuantizer(
            cfg.codebook_size, cfg.codebook_dim, device=device)
        self.decoder_in = head_dense(cfg.codebook_dim, cfg.decoder_dim,
                                     device=device)
        self.decoder = Encoder(cfg.dec_cfg(), device=device)
        self.decode_task_1 = head_dense(cfg.decoder_dim, cfg.decoder_dim,
                                        device=device)
        self.decode_task_2 = head_dense(cfg.decoder_dim, cfg.teacher_dim,
                                        device=device)

    def encode(self, images: torch.Tensor, update_ema: bool = False):
        x = self.encoder(self.encoder_embed(images))
        z = self.encode_task_2(torch.tanh(self.encode_task_1(x)))
        return self.quantize(z, update_ema=update_ema)

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """modeling_vqkd.py:135: the BEiT-2 pretraining target ids
        [B, N]."""
        return self.encode(images)[2]

    def forward(self, images: torch.Tensor, update_ema: bool = False):
        quant, vq_loss, idx = self.encode(images, update_ema)
        h = self.decoder(self.decoder_in(quant))
        rec = self.decode_task_2(torch.tanh(self.decode_task_1(h)))
        return rec, vq_loss, idx

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VQKD":
        """Random weights: projections xavier-uniform, the task layers
        normal(fan_in^-0.5), the patch projection lecun-normal, norms
        ones / zeros, a fresh codebook."""
        init_weights_(self, generator)
        w = self.encoder_embed.patch_embed.proj.weight
        w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
        self.encoder_embed.patch_embed.proj.bias.zero_()
        self.quantize.init_weights(generator)
        return self


class DiscreteVAE(nn.Module):
    """The lightweight DALL-E-style conv tokenizer: `downscale` convs 4x4
    stride 2 with relu (`Conv_0` ..), then a 1x1 conv to the codebook
    logits (`Conv_{downscale}`); NHWC in, logits [B, h, w, vocab] out,
    float32 (the flax convs have no dtype)."""

    def __init__(self, vocab_size: int = 8192, hidden: int = 128,
                 image_size: int = 224, downscale: int = 3,
                 in_chans: int = 3, device=None):
        super().__init__()
        self.downscale = downscale
        n_in = in_chans
        for i in range(downscale):
            self.add_module(f"Conv_{i}", Conv2d(n_in, hidden * 2 ** i, 4, 2,
                                                device=device))
            n_in = hidden * 2 ** i
        self.add_module(f"Conv_{downscale}", Conv2d(n_in, vocab_size, 1,
                                                    device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float().permute(0, 3, 1, 2)
        for i in range(self.downscale):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return getattr(self, f"Conv_{self.downscale}")(x).permute(0, 2, 3, 1)

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        logits = self(images)
        return logits.argmax(-1).reshape(logits.shape[0], -1)

    def init_weights(self, generator: torch.Generator) -> "DiscreteVAE":
        """Random weights (models/dalle_vae.py's `init_convs`)."""
        return init_convs(self, generator)


@dataclasses.dataclass(frozen=True)
class Beit2PretrainConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    vocab_size: int = 8192
    early_layer: int = 9
    dtype: Any = torch.float32
    use_flash: bool = True

    def beit(self) -> BeitConfig:
        """The backbone's BeitConfig, as the JAX module builds it."""
        return BeitConfig(
            img_size=self.img_size, patch_size=self.patch_size,
            embed_dim=self.embed_dim, num_layers=self.num_layers,
            num_heads=self.num_heads, ffn_dim=self.embed_dim * 4,
            use_rel_pos_bias=False, use_shared_rel_pos_bias=True,
            use_mean_pooling=False, init_values=0.1,
            vocab_size=self.vocab_size, dtype=self.dtype,
            use_flash=self.use_flash)


class BEiT2ForMaskedImageModelingCLS(nn.Module):
    """BEiT-2 masked image modelling with the CLS branch: returns (logits,
    logits_cls), each [B, N, vocab_size] in cfg.dtype.

    `logits` is `lm_head(norm(final states))` over the patch tokens.
    The reference (beit2/modeling_pretrain.py:266) and the JAX docstring
    describe the CLS branch as the early layer's patch states
    concatenated with the final CLS token and run through shared last
    blocks. The JAX code (unilm_tpu/models/beit2.py:199-208) runs no
    blocks: it concatenates [final cls, early patches] and applies
    `lm_head_cls` to `mix[:, 1:]`, the early patch states alone, so the
    final CLS never reaches `logits_cls`. The port reproduces the JAX
    code (ROADMAP Queue 3, "Faults of the reference itself";
    tests/test_torch_beit2.py pins it)."""

    def __init__(self, cfg: Beit2PretrainConfig, device=None):
        super().__init__()
        self.cfg = cfg
        bcfg = cfg.beit()
        self.bcfg = bcfg
        E, V = cfg.embed_dim, cfg.vocab_size
        self.backbone = BeitBackbone(bcfg, use_mask_token=True, device=device)
        self.norm = Norm(TransformerConfig(embed_dim=E, layernorm_eps=1e-6),
                         device=device, dtype=cfg.dtype)
        self.lm_head = head_dense(E, V, cfg.dtype, device=device)
        self.lm_head_cls = head_dense(E, V, cfg.dtype, device=device)

    def forward(self, images: torch.Tensor, bool_masked_pos: torch.Tensor):
        """images [B, H, W, C]; bool_masked_pos [B, N] bool."""
        x, hiddens = self.backbone(images, bool_masked_pos,
                                   return_all_hiddens=True)
        logits = self.lm_head(self.norm(x)[:, 1:])
        early = hiddens[self.cfg.early_layer][:, 1:]
        return logits, self.lm_head_cls(early)

    def init_weights(self, generator: torch.Generator
                     ) -> "BEiT2ForMaskedImageModelingCLS":
        """Random weights (models/beit.py's `init_beit`)."""
        init_beit(self, self.bcfg, generator)
        return self
