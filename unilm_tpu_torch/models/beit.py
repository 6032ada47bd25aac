"""BEiT / BEiT-2 / DiT image models (port of unilm_tpu/models/beit.py:
`beit_relative_position_index` :29, `Beit2DRelativePositionBias` :52,
`BeitConfig` :76, `BeitBackbone` :127, `BeitForImageClassification` :195,
`BeitForMaskedImageModeling` :216 and the registry :241-273).

NHWC images, the shared `Encoder`, and per-layer (or one shared) 2D
relative-position bias tables gathered once per forward into contiguous
[1, H, N+1, N+1] tensors, which the encoder attention reads as its bias
(kernel #3 on the card).

Dtypes follow flax's promotion in the JAX model: the embeddings, the
encoder and the bias compute in `cfg.dtype`; params are float32; `fc_norm`
and `head` (flax dtype=None over float32 params) compute in float32, so
the logits are float32 in a bf16 model; the pretraining `norm` and
`lm_head` compute in `cfg.dtype`, as the JAX module sets them.

In training (`model.train()`), drop-path draws its keep flags from the
`torch.Generator` the caller passes to `forward`, all of them before the
encoder runs (`Encoder.draw_drop_path`); dropout (`dropout`,
`attention_dropout`) draws from the same generator (core/layers.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import VisionEmbedding
from unilm_tpu_torch.core.layers import (Dense, LayerScale, Norm, dropout,
                                         init_weights_, training_rng)
from unilm_tpu_torch.core.transformer import Encoder


def beit_relative_position_index(window_size) -> np.ndarray:
    """Static [N+1, N+1] index into the (2h-1)(2w-1)+3 bias table:
    pairwise 2D offsets plus 3 entries for cls->token, token->cls and
    cls->cls."""
    h, w = window_size
    num_rel = (2 * h - 1) * (2 * w - 1)
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)  # N, N, 2
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    n = h * w
    index = np.zeros((n + 1, n + 1), dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel
    index[0:, 0] = num_rel + 1
    index[0, 0] = num_rel + 2
    return index


class Beit2DRelativePositionBias(nn.Module):
    """Learned 2D bias table [(2h-1)(2w-1)+3, heads] (float32) -> a
    contiguous [1, heads, N+1, N+1] additive bias in `dtype`."""

    def __init__(self, window_size, num_heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        h, w = window_size
        self.n = h * w + 1
        self.out_dtype = dtype
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * h - 1) * (2 * w - 1) + 3, num_heads, device=device))
        index = torch.from_numpy(beit_relative_position_index(window_size))
        self.register_buffer("index", index.reshape(-1).to(device),
                             persistent=False)

    def forward(self) -> torch.Tensor:
        bias = self.relative_position_bias_table[self.index]  # [n*n, H]
        bias = bias.reshape(self.n, self.n, -1).permute(2, 0, 1)
        return bias[None].to(self.out_dtype).contiguous()


@dataclasses.dataclass(frozen=True)
class BeitConfig:
    img_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    use_abs_pos_emb: bool = False
    use_rel_pos_bias: bool = True  # per-block tables (fine-tuned checkpoints)
    use_shared_rel_pos_bias: bool = False  # one table for all blocks
    use_mean_pooling: bool = True
    init_values: float = 0.1  # LayerScale gamma init (0 = off)
    drop_path_rate: float = 0.0
    dropout: float = 0.0
    attention_dropout: float = 0.0
    layernorm_eps: float = 1e-6
    vocab_size: int = 8192  # visual-token codebook (pretraining head)
    dtype: Any = torch.float32
    use_flash: bool = True
    remat: bool = False
    remat_policy: str = "full"

    @property
    def grid_size(self):
        g = self.img_size // self.patch_size
        return (g, g)

    @property
    def num_patches(self) -> int:
        g = self.grid_size
        return g[0] * g[1]

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            dropout=self.dropout, attention_dropout=self.attention_dropout,
            drop_path_rate=self.drop_path_rate, normalize_before=True,
            layernorm_eps=self.layernorm_eps, dtype=self.dtype,
            use_flash=self.use_flash, remat=self.remat,
            remat_policy=self.remat_policy)


class BeitBackbone(nn.Module):
    """Patch embed + (abs pos) + encoder with the 2D rel-pos bias; returns
    the tokens [B, N+1, E]. `final_norm` (JAX :135): None builds the
    trailing LayerNorm unless the head mean-pools through fc_norm; False
    builds none at all (the detection trunk taps intermediate blocks and
    has no final norm, models/rcnn.py `DetectionViT`); True builds it."""

    def __init__(self, cfg: BeitConfig, use_mask_token: bool = False,
                 device=None, final_norm: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.transformer()
        E = cfg.embed_dim
        self.embeddings = VisionEmbedding(
            cfg.img_size, cfg.patch_size, E, use_cls_token=True,
            use_mask_token=use_mask_token, dtype=tcfg.dtype, device=device)
        if cfg.use_abs_pos_emb:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, cfg.num_patches + 1, E, device=device))
        if cfg.use_shared_rel_pos_bias:
            self.rel_pos_bias = Beit2DRelativePositionBias(
                cfg.grid_size, cfg.num_heads, tcfg.dtype, device=device)
        elif cfg.use_rel_pos_bias:
            for i in range(cfg.num_layers):
                self.add_module(f"rel_pos_bias_{i}", Beit2DRelativePositionBias(
                    cfg.grid_size, cfg.num_heads, tcfg.dtype, device=device))
        self.encoder = Encoder(
            tcfg, final_layer_norm=(not cfg.use_mean_pooling
                                    if final_norm is None else final_norm),
            layer_scale_init=cfg.init_values, device=device)

    def attn_bias(self):
        """None, the shared [1, H, N+1, N+1] bias, or the per-layer list."""
        cfg = self.cfg
        if cfg.use_shared_rel_pos_bias:
            return self.rel_pos_bias()
        if cfg.use_rel_pos_bias:
            return [getattr(self, f"rel_pos_bias_{i}")()
                    for i in range(cfg.num_layers)]
        return None

    def forward(self, images: torch.Tensor,
                bool_masked_pos: Optional[torch.Tensor] = None,
                return_all_hiddens: bool = False,
                generator: Optional[torch.Generator] = None):
        """`generator`: where a training forward draws its drop-path
        flags and its dropout masks (needed in training when
        cfg.drop_path_rate or a dropout rate is > 0): the flags, the
        embedding's dropout (JAX :163), then the encoder's."""
        keep = (None if generator is None
                else self.encoder.draw_drop_path(images.shape[0], generator))
        x = self.embeddings(images, bool_masked_pos)
        if self.cfg.use_abs_pos_emb:
            x = x + self.pos_embed.to(x.dtype)
        x = dropout(x, self.cfg.dropout, training_rng(self, generator))
        return self.encoder(x, attn_bias=self.attn_bias(),
                            return_all_hiddens=return_all_hiddens,
                            drop_path_keep=keep, generator=generator)


@torch.no_grad()
def init_beit(model: nn.Module, cfg: BeitConfig,
               generator: torch.Generator) -> None:
    """Random weights at the JAX initialisers' scales from `generator`
    (on the parameters' device): projections xavier-uniform, the patch
    projection lecun-normal, cls/mask tokens and pos_embed normal(0.02),
    heads normal(init_std), norms ones/zeros; the rel-pos tables zeros and
    the LayerScale gammas init_values, as in flax."""
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, LayerScale):
            m.gamma.fill_(cfg.init_values)
        elif isinstance(m, Beit2DRelativePositionBias):
            m.relative_position_bias_table.zero_()
    emb = model.backbone.embeddings
    w = emb.patch_embed.proj.weight
    w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)
    emb.patch_embed.proj.bias.zero_()
    for name in ("cls_token", "mask_token"):
        if hasattr(emb, name):
            getattr(emb, name).normal_(0.0, 0.02, generator=generator)
    if hasattr(model.backbone, "pos_embed"):
        model.backbone.pos_embed.normal_(0.0, 0.02, generator=generator)


class BeitForImageClassification(nn.Module):
    """BEiT with the classification head: mean-pool the patch tokens ->
    fc_norm, or the cls token; -> head. Logits are float32."""

    def __init__(self, cfg: BeitConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = BeitBackbone(cfg, device=device)
        if cfg.use_mean_pooling:
            self.fc_norm = Norm(
                TransformerConfig(embed_dim=cfg.embed_dim,
                                  layernorm_eps=cfg.layernorm_eps),
                device=device, dtype=torch.float32)
        self.head = Dense(cfg.embed_dim, cfg.num_classes, bias=True,
                          dtype=torch.float32, param_dtype=torch.float32,
                          device=device)
        self.head.init_std = 0.02

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, H, W, C] (NHWC) -> logits [B, num_classes] float32.
        `generator`: the drop-path draws of a training forward."""
        x = self.backbone(images, generator=generator)
        if self.cfg.use_mean_pooling:
            x = self.fc_norm(x[:, 1:].mean(1))
        else:
            x = x[:, 0]
        return self.head(x)

    def init_weights(self, generator: torch.Generator
                     ) -> "BeitForImageClassification":
        """Random weights (`init_beit`); the head normal(0.02)."""
        init_beit(self, self.cfg, generator)
        return self


class BeitForMaskedImageModeling(nn.Module):
    """BEiT pretraining (beit/modeling_pretrain.py): the backbone with the
    mask token substituted at `bool_masked_pos`, then `norm` and `lm_head`
    over the patch tokens, both in `cfg.dtype` (the JAX module sets their
    dtype so the [B, N, E] x [E, vocab] head runs in the compute dtype).
    Returns logits [B, N, vocab_size] in cfg.dtype."""

    def __init__(self, cfg: BeitConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = BeitBackbone(cfg, use_mask_token=True, device=device)
        self.norm = Norm(TransformerConfig(embed_dim=cfg.embed_dim,
                                           layernorm_eps=cfg.layernorm_eps),
                         device=device, dtype=cfg.dtype)
        self.lm_head = Dense(cfg.embed_dim, cfg.vocab_size, bias=True,
                             dtype=cfg.dtype, param_dtype=torch.float32,
                             device=device)
        self.lm_head.init_std = cfg.embed_dim ** -0.5  # flax's lecun-normal

    def forward(self, images: torch.Tensor, bool_masked_pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.backbone(images, bool_masked_pos, generator=generator)
        return self.lm_head(self.norm(x)[:, 1:])

    def init_weights(self, generator: torch.Generator
                     ) -> "BeitForMaskedImageModeling":
        """Random weights (`init_beit`)."""
        init_beit(self, self.cfg, generator)
        return self


# --------------------------------------------------------------------------- #
# Architecture registry (beit/modeling_finetune.py:378-420, dit presets)
# --------------------------------------------------------------------------- #

def beit_base_patch16_224(**kw) -> BeitConfig:
    return BeitConfig(**kw)


def beit_base_patch16_384(**kw) -> BeitConfig:
    return BeitConfig(img_size=384, **kw)


def beit_large_patch16_224(**kw) -> BeitConfig:
    return BeitConfig(embed_dim=1024, num_layers=24, num_heads=16, ffn_dim=4096,
                      init_values=1e-5, **kw)


def beit_large_patch16_384(**kw) -> BeitConfig:
    return BeitConfig(img_size=384, embed_dim=1024, num_layers=24, num_heads=16,
                      ffn_dim=4096, init_values=1e-5, **kw)


def beit_large_patch16_512(**kw) -> BeitConfig:
    return BeitConfig(img_size=512, embed_dim=1024, num_layers=24, num_heads=16,
                      ffn_dim=4096, init_values=1e-5, **kw)


def dit_base_patch16_224(**kw) -> BeitConfig:
    """DiT document-image classifier (RVL-CDIP, 16 classes)."""
    kw.setdefault("num_classes", 16)
    return BeitConfig(**kw)


def dit_large_patch16_224(**kw) -> BeitConfig:
    kw.setdefault("num_classes", 16)
    return BeitConfig(embed_dim=1024, num_layers=24, num_heads=16, ffn_dim=4096,
                      init_values=1e-5, **kw)
