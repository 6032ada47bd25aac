"""LayoutLMv2 / LayoutXLM: text, layout and CNN visual features, with the
relation-extraction head (port of unilm_tpu/models/layoutlmv2.py:
`LayoutLMv2Config` :30, `ConvBackbone` :69, `visual_grid_bbox` :88,
`LayoutLMv2Model` :102, `LayoutLMv2ForTokenClassification` :185,
`RelationExtractionHead` :199).

- Text embeddings: word + 1-D position + the concatenated x/y/h/w spatial
  embedding (`SpatialEmbedding`, shared with LayoutLMv3) + token type,
  then a LayerNorm.
- Visual stream (with `images`): a strided conv pyramid with GroupNorm
  and ReLU, resized to the `image_feature_pool_shape` grid (the JAX
  module's compact stand-in for the detectron2 ResNeXt-FPN), projected to
  the hidden size, plus the grid cells' positions and boxes, a LayerNorm;
  appended after the text, always unmasked.
- The 1-D and 2-D bucketed relative attention bias: a dense per-example
  [B, H, T, T] float32 bias from the three tables, divided by
  sqrt(head_dim), computed once and read by every layer; the tables'
  gradient is one one-hot contraction (ops/bucket_bias.py). With the
  key-padding mask it sends each layer's attention on the card to the doc
  attention kernels (#9 forward, #10 backward with dbias), where JAX's
  dispatcher sends it too; on the CPU the plain attention.
- RelationExtractionHead: the biaffine classifier over (head, tail)
  entity pairs of layoutlmft's RE decoder.

Three details of the flax modules the port keeps:
- `nn.Conv(padding="SAME", strides=2)` pads an even side by (0, 1), not
  torch's symmetric `padding=1` (`same_pad`);
- flax's GroupNorm epsilon is 1e-6;
- `jax.image.resize(..., "bilinear")` antialiases when it shrinks:
  `F.interpolate(..., antialias=True)` computes the same triangle filter
  (tests/test_torch_docai.py holds the backbone against JAX).

Dtypes follow flax's promotion in the JAX model: everything before the
encoder (embeddings, the backbone, the projection, the LayerNorms, the
bias) is float32, the encoder computes in `cfg.dtype` and reads the bias
cast to it once, the heads compute in float32. Parameter names mirror the
flax tree, so a JAX checkpoint loads with `convert.from_jax.
load_flax_params`. In training the dropout masks come from the caller's
`generator=` (the encoder's, then the head's at :195; the JAX model has
no embedding dropout).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import (dropout, head_dense, init_weights_,
                                         training_rng)
from unilm_tpu_torch.core.positional import relative_position_bucket
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.layoutlmv3 import (SpatialEmbedding, embed_table,
                                               float32_norm)
from unilm_tpu_torch.ops.bucket_bias import (bias_grad_collector,
                                             pack_bucket_planes)


@dataclasses.dataclass(frozen=True)
class LayoutLMv2Config:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    pad_token_id: int = 0
    type_vocab_size: int = 2
    coordinate_size: int = 128
    shape_size: int = 128
    max_2d_positions: int = 1024
    image_feature_pool_shape: Tuple[int, int] = (7, 7)
    rel_pos_bins: int = 32
    max_rel_pos: int = 128
    rel_2d_pos_bins: int = 64
    max_rel_2d_pos: int = 256
    has_relative_attention_bias: bool = True
    has_spatial_attention_bias: bool = True
    num_labels: int = 2
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    layernorm_eps: float = 1e-12
    dropout: float = 0.0
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=False, layernorm_eps=self.layernorm_eps,
            dropout=self.dropout, dtype=self.dtype, use_flash=self.use_flash)

    @property
    def visual_len(self) -> int:
        return self.image_feature_pool_shape[0] * self.image_feature_pool_shape[1]


def same_pad(n: int) -> Tuple[int, int]:
    """(low, high) padding of one side of length n under flax's "SAME" for
    the backbone's 3-wide kernels at stride 2: the output has ceil(n / 2)
    positions and the odd pixel of padding goes to the high end."""
    total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class ConvBackbone(nn.Module):
    """The visual stream's feature extractor: per channel count, a 3x3
    stride-2 conv with flax's SAME padding, GroupNorm(min(32, C), eps 1e-6)
    and ReLU; then an antialiased bilinear resize to the pool grid.
    Images [B, H, W, 3] (NHWC) -> features [B, gh * gw, C], float32."""

    def __init__(self, cfg: LayoutLMv2Config, device=None):
        super().__init__()
        self.cfg = cfg
        c_in = 3
        for i, ch in enumerate(cfg.backbone_channels):
            self.add_module(f"conv_{i}", nn.Conv2d(c_in, ch, 3, stride=2,
                                                   device=device))
            self.add_module(f"gn_{i}", nn.GroupNorm(min(32, ch), ch,
                                                    eps=1e-6, device=device))
            c_in = ch

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float().permute(0, 3, 1, 2)
        for i in range(len(self.cfg.backbone_channels)):
            (h0, h1), (w0, w1) = same_pad(x.shape[2]), same_pad(x.shape[3])
            x = getattr(self, f"conv_{i}")(F.pad(x, (w0, w1, h0, h1)))
            x = F.relu(getattr(self, f"gn_{i}")(x))
        gh, gw = self.cfg.image_feature_pool_shape
        x = F.interpolate(x, size=(gh, gw), mode="bilinear",
                          align_corners=False, antialias=True)
        return x.flatten(2).transpose(1, 2)


def visual_grid_bbox(grid: Tuple[int, int], max_len: int = 1000
                     ) -> np.ndarray:
    """[gy * gx, 4] int64 boxes of the visual grid's cells over a
    `max_len`-unit page, row by row."""
    gy, gx = grid
    xs = (np.arange(gx + 1) * max_len) // gx
    ys = (np.arange(gy + 1) * max_len) // gy
    boxes = np.stack([np.tile(xs[:-1], gy), np.repeat(ys[:-1], gx),
                      np.tile(xs[1:], gy), np.repeat(ys[1:], gx)], axis=-1)
    return boxes.astype(np.int64)


class LayoutLMv2Model(nn.Module):
    """Embeddings, the visual stream, the shared relative bias and the
    post-LN encoder: hidden states [B, L (+ visual_len), E]."""

    def __init__(self, cfg: LayoutLMv2Config, device=None):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.hidden_size, cfg.num_heads
        self.word_embeddings = embed_table(cfg.vocab_size, E, device)
        self.position_embeddings = embed_table(cfg.max_positions, E, device)
        self.spatial = SpatialEmbedding(cfg, device=device)
        self.token_type_embeddings = embed_table(cfg.type_vocab_size, E,
                                                 device)
        self.emb_LayerNorm = float32_norm(cfg, device)
        self.visual = ConvBackbone(cfg, device=device)
        self.visual_proj = head_dense(cfg.backbone_channels[-1], E,
                                      device=device)
        self.visual_LayerNorm = float32_norm(cfg, device)
        self.register_buffer("visual_bbox", torch.from_numpy(
            visual_grid_bbox(cfg.image_feature_pool_shape)).to(device),
            persistent=False)
        if cfg.has_relative_attention_bias:
            self.rel_pos_bias = nn.Parameter(
                torch.zeros(cfg.rel_pos_bins, H, device=device))
        if cfg.has_spatial_attention_bias:
            self.rel_pos_x_bias = nn.Parameter(
                torch.zeros(cfg.rel_2d_pos_bins, H, device=device))
            self.rel_pos_y_bias = nn.Parameter(
                torch.zeros(cfg.rel_2d_pos_bins, H, device=device))
        self.encoder = Encoder(cfg.transformer(), device=device)

    def bias_tables(self):
        """The [nb, H] tables of the relative bias present in the config,
        in (rel_pos_bias, rel_pos_x_bias, rel_pos_y_bias) order."""
        return [getattr(self, n) for n in ("rel_pos_bias", "rel_pos_x_bias",
                                           "rel_pos_y_bias")
                if hasattr(self, n)]

    def attention_bias(self, position_ids: torch.Tensor,  # [B, T]
                       full_bbox: torch.Tensor  # [B, T, 4]
                       ) -> Optional[torch.Tensor]:
        """The (rel_pos + rel_2d_pos) / sqrt(head_dim) bias [B, H, T, T]
        (JAX :155-177): float32 sums of the tables' rows at the bucket
        planes, cast to cfg.dtype and made contiguous once for every layer;
        None without either bias. The lookup is ops/bucket_bias.py's
        `bias_grad_collector` (the 1/sqrt(head_dim) folded into the
        tables, a power of two at head_dim 64), so the tables' gradient is
        one one-hot contraction of the layers' summed bias gradient rather
        than a scatter-add of every [B, H, T, T] element."""
        cfg = self.cfg
        tables = self.bias_tables()
        if not tables:
            return None
        planes = []
        if cfg.has_relative_attention_bias:
            rel = position_ids[:, None, :] - position_ids[:, :, None]
            planes.append(relative_position_bucket(
                rel, True, cfg.rel_pos_bins, cfg.max_rel_pos))
        if cfg.has_spatial_attention_bias:
            for c in (full_bbox[..., 0], full_bbox[..., 3]):
                planes.append(relative_position_bucket(
                    c[:, None, :] - c[:, :, None], True, cfg.rel_2d_pos_bins,
                    cfg.max_rel_2d_pos))
        hbts = bias_grad_collector(
            tables, pack_bucket_planes(*planes),
            1.0 / math.sqrt(cfg.hidden_size // cfg.num_heads), torch.float32)
        return hbts.permute(1, 0, 2, 3).to(cfg.dtype).contiguous()

    def forward(self, input_ids: torch.Tensor,  # [B, L]
                bbox: torch.Tensor,  # [B, L, 4] in 0..1000
                attention_mask: Optional[torch.Tensor] = None,  # [B, L] 1=valid
                images: Optional[torch.Tensor] = None,  # [B, H, W, 3] NHWC
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        B, L = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(L, device=dev).expand(B, L)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos_ids)
             + self.spatial(bbox))
        x = self.emb_LayerNorm(x + self.token_type_embeddings(token_type_ids))

        full_bbox, position_ids = bbox, pos_ids
        key_padding = attention_mask.bool()
        if images is not None:
            V = cfg.visual_len
            vbox = self.visual_bbox.to(bbox.dtype).expand(B, V, 4)
            vpos = torch.arange(V, device=dev).expand(B, V)
            v = self.visual_proj(self.visual(images))
            v = v + self.position_embeddings(vpos) + self.spatial(vbox)
            x = torch.cat([x, self.visual_LayerNorm(v)], dim=1)
            full_bbox = torch.cat([bbox, vbox], dim=1)
            position_ids = torch.cat([pos_ids, vpos], dim=1)
            key_padding = torch.cat([key_padding, torch.ones(
                B, V, dtype=torch.bool, device=dev)], dim=1)
        return self.encoder(x, key_padding_mask=key_padding,
                            attn_bias=self.attention_bias(position_ids,
                                                          full_bbox),
                            generator=generator)


@torch.no_grad()
def _init_backbone(model: nn.Module, generator: torch.Generator) -> None:
    """The flax Conv and GroupNorm initialisers: kernels lecun-normal (std
    fan_in^-0.5), biases zeros, GroupNorm scales ones."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class LayoutLMv2ForTokenClassification(nn.Module):
    """Float32 logits [B, L, num_labels] for the text positions."""

    def __init__(self, cfg: LayoutLMv2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.layoutlmv2 = LayoutLMv2Model(cfg, device=device)
        self.classifier = head_dense(cfg.hidden_size, cfg.num_labels,
                                     device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights at the flax initialisers' scales from
        `generator`: projections xavier-uniform, embeddings and the bias
        tables normal(0.02), the convs, the visual projection and the
        classifier lecun-normal, norms ones/zeros."""
        init_weights_(self, generator)
        _init_backbone(self, generator)
        for t in self.layoutlmv2.bias_tables():
            t.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, input_ids, bbox, attention_mask=None, images=None,
                token_type_ids=None, generator=None) -> torch.Tensor:
        seq = self.layoutlmv2(input_ids, bbox, attention_mask, images,
                              token_type_ids, generator)
        text = dropout(seq[:, :input_ids.shape[1]], self.cfg.dropout,
                       training_rng(self, generator))
        return self.classifier(text)


class RelationExtractionHead(nn.Module):
    """layoutlmft's RE decoder: each (head, tail) pair of entity-start
    tokens through its own Dense + GELU (tanh, jax.nn.gelu's default) to
    half the width, then a biaffine score per relation, float32."""

    def __init__(self, hidden_size: int, num_relations: int = 2,
                 device=None):
        super().__init__()
        half = hidden_size // 2
        self.ffn_head = head_dense(hidden_size, half, device=device)
        self.ffn_tail = head_dense(hidden_size, half, device=device)
        self.biaffine = nn.Parameter(torch.zeros(
            num_relations, half + 1, half + 1, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The Dense layers lecun-normal, the biaffine tensor
        normal(0.02)."""
        init_weights_(self, generator)
        self.biaffine.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, seq: torch.Tensor,  # [B, T, E]
                head_idx: torch.Tensor,  # [B, P] token indices
                tail_idx: torch.Tensor) -> torch.Tensor:
        """Logits [B, P, num_relations]."""
        def pair_side(idx, ffn):
            x = torch.gather(seq, 1, idx[..., None].expand(
                -1, -1, seq.shape[-1]))
            x = F.gelu(ffn(x), approximate="tanh")
            return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)

        h = pair_side(head_idx, self.ffn_head)
        t = pair_side(tail_idx, self.ffn_tail)
        return torch.einsum("bpi,rij,bpj->bpr", h, self.biaffine, t)
