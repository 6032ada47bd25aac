"""LayoutLMv3: text + 2D layout + image patches (port of
unilm_tpu/models/layoutlmv3.py: `LayoutLMv3Config` :34, `_bucket_take` :96,
`create_position_ids` :125, `visual_bbox_grid` :131, `SpatialEmbedding`
:149, `relative_bucket_planes` :173, `relative_attention_bias` :219,
`LayoutLMv3Model` :263, the heads :410-471 and the configs :474-482).

- word + 1D-position + 2D bbox (x/y corners + h/w) embeddings, the
  conv16 patch embedding with a cls token, the visual position embedding
  and LayerNorms, the visual bbox grid over a 1000-unit page;
- the 1D and 2D bucketed relative attention bias with the segment-aware
  `valid_span` and distance 0 between image and text, added to the logits
  as (rel_pos + rel_2d_pos) / sqrt(d), computed once and shared by every
  layer;
- the post-LN (RoBERTa-style) `Encoder` with the key-padding mask;
- heads: token classification, sequence classification, QA.

With `fused_bias` (the default, as in JAX) the bias is materialized once
head-major ([H, B, T, S], `ops/bucket_bias.py`) through
`bias_grad_collector`, so the tables' gradient is one contraction of the
layers' summed logit gradients, and every layer reads it as a
`HeadMajorBias`: on the card the doc attention kernels (#9 forward, #10
backward, which emits the logit gradient as dbias). Without it the bias is
the [B, H, T, S] `relative_attention_bias` and autograd differentiates the
gather. On the CPU both take the plain attention.

Dtypes follow flax's promotion in the JAX model: the embeddings, the patch
embedding and the embedding LayerNorms are float32 (flax dtype=None over
float32 params), the encoder computes in `cfg.dtype`, the bias is in
`cfg.dtype`, and the classifier computes in float32, so logits are
float32. Parameter names mirror the flax tree, so a JAX checkpoint loads
with `convert.from_jax.load_flax_params`. In training (`model.train()`)
`dropout` draws its masks from the `torch.Generator` the caller passes
(`generator=`), at the JAX sites (:311, :326, :331, the encoder, the
heads :418, :421, :439); a training forward with a rate and no generator
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import PatchEmbed
from unilm_tpu_torch.core.layers import (Dense, Norm, dropout, init_weights_,
                                         training_rng)
from unilm_tpu_torch.core.positional import relative_position_bucket
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.ops.bucket_bias import (bias_grad_collector,
                                             pack_bucket_planes)
from unilm_tpu_torch.ops.doc_attention import HeadMajorBias


@dataclasses.dataclass(frozen=True)
class LayoutLMv3Config:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 514
    pad_token_id: int = 1
    type_vocab_size: int = 1
    coordinate_size: int = 128
    shape_size: int = 128
    max_2d_positions: int = 1024
    rel_pos_bins: int = 32
    max_rel_pos: int = 128
    rel_2d_pos_bins: int = 64
    max_rel_2d_pos: int = 256
    input_size: int = 224
    patch_size: int = 16
    num_labels: int = 2
    dropout: float = 0.0
    layernorm_eps: float = 1e-5
    visual_embed: bool = True
    has_relative_attention_bias: bool = True
    has_spatial_attention_bias: bool = True
    dtype: Any = torch.float32
    use_flash: bool = True
    fused_bias: bool = True
    remat: bool = False
    remat_policy: str = "full"

    @property
    def visual_grid(self):
        g = self.input_size // self.patch_size
        return (g, g)

    @property
    def visual_len(self) -> int:
        g = self.visual_grid
        return g[0] * g[1] + 1

    @property
    def head_scale(self) -> float:
        """1 / sqrt(head_dim), the bias's scale (modeling:318-321)."""
        return float(self.hidden_size // self.num_heads) ** -0.5

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            dropout=self.dropout, normalize_before=False,
            layernorm_eps=self.layernorm_eps, dtype=self.dtype,
            use_flash=self.use_flash, remat=self.remat,
            remat_policy=self.remat_policy)


def embed_table(num: int, dim: int, device) -> nn.Embedding:
    """An embedding table that `init_weights_` draws normal(0.02), the
    Document AI models' flax `embedding_init`."""
    emb = nn.Embedding(num, dim, device=device)
    emb.init_std = 0.02
    return emb


def float32_norm(cfg: LayoutLMv3Config, device) -> Norm:
    """A flax LayerNorm left at dtype=None: float32 params and output."""
    return Norm(TransformerConfig(embed_dim=cfg.hidden_size,
                                  layernorm_eps=cfg.layernorm_eps),
                device=device, dtype=torch.float32)


def create_position_ids(input_ids: torch.Tensor,
                        padding_idx: int) -> torch.Tensor:
    """fairseq make_positions: pads stay at padding_idx (modeling:134-146)."""
    mask = (input_ids != padding_idx).to(input_ids.dtype)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def visual_bbox_grid(grid=(14, 14), max_len: int = 1000) -> np.ndarray:
    """[1 + g*g, 4] page-normalized patch boxes (+cls box) (modeling:760-781)."""
    gy, gx = grid
    xs = (np.arange(0, max_len * (gx + 1), max_len) // gx).astype(np.int64)
    ys = (np.arange(0, max_len * (gy + 1), max_len) // gy).astype(np.int64)
    boxes = np.stack([np.tile(xs[:-1], (gy, 1)), np.tile(ys[:-1], (gx, 1)).T,
                      np.tile(xs[1:], (gy, 1)), np.tile(ys[1:], (gx, 1)).T],
                     axis=-1).reshape(-1, 4)
    cls_box = np.array([[1, 1, max_len - 1, max_len - 1]], np.int64)
    return np.concatenate([cls_box, boxes], axis=0)


class SpatialEmbedding(nn.Module):
    """x/y corner + h/w embeddings concatenated (modeling:104-123)."""

    def __init__(self, cfg: LayoutLMv3Config, device=None):
        super().__init__()
        n = cfg.max_2d_positions
        c = cfg.coordinate_size
        self.x_position_embeddings = embed_table(n, c, device)
        self.y_position_embeddings = embed_table(n, c, device)
        self.h_position_embeddings = embed_table(n, cfg.shape_size, device)
        self.w_position_embeddings = embed_table(n, cfg.shape_size, device)

    def forward(self, bbox: torch.Tensor) -> torch.Tensor:
        x, y = self.x_position_embeddings, self.y_position_embeddings
        h = self.h_position_embeddings(
            torch.clamp(bbox[..., 3] - bbox[..., 1], 0, 1023))
        w = self.w_position_embeddings(
            torch.clamp(bbox[..., 2] - bbox[..., 0], 0, 1023))
        return torch.cat([x(bbox[..., 0]), y(bbox[..., 1]), x(bbox[..., 2]),
                          y(bbox[..., 3]), h, w], dim=-1)


def relative_bucket_planes(cfg: LayoutLMv3Config,
                           position_ids: torch.Tensor,  # [B, T]
                           full_bbox: torch.Tensor,  # [B, T, 4], 0..1000
                           valid_span: Optional[torch.Tensor] = None,  # [B, L, L]
                           visual_len: int = 0,
                           want_1d: bool = True, want_2d: bool = True):
    """Int bucket planes [(B, T, T)] for the (1D, x, y) relative bias
    (modeling_layoutlmv3.py:507-577). With `valid_span` (same-segment
    mask over the L text tokens) a text pair across segments takes the
    farthest bucket of its direction; the trailing `visual_len` tokens are
    at 1D distance 0 from the text."""
    planes = []
    if want_1d:
        rel = position_ids[:, None, :] - position_ids[:, :, None]  # [B, T, T]
        if valid_span is not None:
            T = position_ids.shape[1]
            L = T - visual_len
            big = T
            tt = rel[:, :L, :L]
            vs = valid_span.bool()
            tt = torch.where((tt > 0) & ~vs, big, tt)
            tt = torch.where((tt < 0) & ~vs, -big, tt)
            rel = rel.clone()
            rel[:, :L, :L] = tt
            if visual_len:
                rel[:, L:, :L] = 0
                rel[:, :L, L:] = 0
        planes.append(relative_position_bucket(rel, True, cfg.rel_pos_bins,
                                               cfg.max_rel_pos))
    if want_2d:
        for c in (full_bbox[..., 0], full_bbox[..., 3]):
            planes.append(relative_position_bucket(
                c[:, None, :] - c[:, :, None], True, cfg.rel_2d_pos_bins,
                cfg.max_rel_2d_pos))
    return planes


def _bucket_take(table: torch.Tensor, buckets: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Per-head lookup of an [nb, H] table at [B, T, S] buckets ->
    [H, B, T, S] float32 (the table rounded to `dtype` first, as the JAX
    one-hot product does)."""
    return table.t().to(dtype)[:, buckets.long()].float()


def relative_attention_bias(cfg: LayoutLMv3Config, t1, tx, ty,
                            position_ids, full_bbox, valid_span=None,
                            visual_len: int = 0) -> Optional[torch.Tensor]:
    """The (rel_pos + rel_2d_pos) / sqrt(d) bias [B, H, T, S] in cfg.dtype
    (contiguous), materialized from the tables: the path without
    `fused_bias`, and the oracle of the fused one."""
    planes = relative_bucket_planes(cfg, position_ids, full_bbox, valid_span,
                                    visual_len, want_1d=t1 is not None,
                                    want_2d=tx is not None)
    bias = None
    i = 0
    if t1 is not None:
        bias = _bucket_take(t1, planes[0], cfg.dtype)
        i = 1
    if tx is not None:
        b2d = (_bucket_take(tx, planes[i], cfg.dtype)
               + _bucket_take(ty, planes[i + 1], cfg.dtype))
        bias = b2d if bias is None else bias + b2d
    if bias is None:
        return None
    bias = bias / float(cfg.hidden_size // cfg.num_heads) ** 0.5
    return bias.permute(1, 0, 2, 3).to(cfg.dtype).contiguous()


class LayoutLMv3Model(nn.Module):
    """Embeddings, the shared relative bias and the post-LN encoder;
    returns the hidden states [B, L (+ visual_len), E]."""

    def __init__(self, cfg: LayoutLMv3Config, device=None):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.hidden_size, cfg.num_heads
        self.word_embeddings = embed_table(cfg.vocab_size, E, device)
        self.token_type_embeddings = embed_table(cfg.type_vocab_size, E,
                                                 device)
        self.position_embeddings = embed_table(cfg.max_positions, E, device)
        self.spatial = SpatialEmbedding(cfg, device=device)
        self.emb_LayerNorm = float32_norm(cfg, device)
        if cfg.visual_embed:
            self.patch_embed = PatchEmbed(cfg.patch_size, E,
                                          dtype=torch.float32, device=device)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, E, device=device))
            self.pos_embed = nn.Parameter(
                torch.zeros(1, cfg.visual_len, E, device=device))
            self.visual_norm = float32_norm(cfg, device)
            self.LayerNorm = float32_norm(cfg, device)
            self.register_buffer("visual_bbox", torch.from_numpy(
                visual_bbox_grid(cfg.visual_grid)).to(device),
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
        """(rel_pos_bias, rel_pos_x_bias, rel_pos_y_bias), None where the
        config has no such bias."""
        return tuple(getattr(self, n, None) for n in
                     ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias"))

    def forward(self, input_ids: torch.Tensor,  # [B, L]
                bbox: torch.Tensor,  # [B, L, 4] in 0..1000
                attention_mask: Optional[torch.Tensor] = None,  # [B, L] 1=valid
                images: Optional[torch.Tensor] = None,  # [B, H, W, 3] NHWC
                valid_span: Optional[torch.Tensor] = None,  # [B, L, L]
                generator: Optional[torch.Generator] = None,
                ) -> torch.Tensor:
        """`generator`: the dropout masks of a training forward (needed
        when cfg.dropout > 0), in JAX's order: the text embedding's
        (:311), the visual stream's (:326), the joint sequence's (:331),
        then the encoder's (the residual branches and the FFN's output;
        LayoutLMv3's dropout is residual only, :86, so the attention
        keeps its kernels)."""
        cfg = self.cfg
        rng = training_rng(self, generator)
        B, L = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, L, dtype=torch.bool, device=dev)
        x = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids))
             + self.position_embeddings(
                 create_position_ids(input_ids, cfg.pad_token_id))
             + self.spatial(bbox))
        x = dropout(self.emb_LayerNorm(x), cfg.dropout, rng)

        full_bbox = bbox
        position_ids = torch.arange(L, device=dev).expand(B, L)
        key_padding = attention_mask.bool()
        vlen = 0
        if cfg.visual_embed and images is not None:
            v = self.patch_embed(images)
            v = torch.cat([self.cls_token.expand(B, 1, -1), v], dim=1)
            v = dropout(v + self.pos_embed, cfg.dropout, rng)
            v = self.visual_norm(v)
            x = dropout(self.LayerNorm(torch.cat([x, v], dim=1)),
                        cfg.dropout, rng)
            vlen = cfg.visual_len
            full_bbox = torch.cat(
                [bbox, self.visual_bbox.to(bbox.dtype).expand(B, -1, -1)],
                dim=1)
            position_ids = torch.cat(
                [position_ids, torch.arange(vlen, device=dev).expand(B, vlen)],
                dim=1)
            key_padding = torch.cat(
                [key_padding, torch.ones(B, vlen, dtype=torch.bool,
                                         device=dev)], dim=1)

        t1, tx, ty = self.bias_tables()
        if cfg.fused_bias and (t1 is not None or tx is not None):
            planes = relative_bucket_planes(
                cfg, position_ids, full_bbox, valid_span, vlen,
                want_1d=t1 is not None, want_2d=tx is not None)
            tables = [t for t in (t1, tx, ty) if t is not None]
            bias = HeadMajorBias(bias_grad_collector(
                tables, pack_bucket_planes(*planes), cfg.head_scale,
                cfg.dtype))
        else:
            bias = relative_attention_bias(cfg, t1, tx, ty, position_ids,
                                           full_bbox, valid_span, vlen)
        return self.encoder(x, key_padding_mask=key_padding, attn_bias=bias,
                            generator=generator)


class _Head(Dense):
    """A head's Dense; it takes the dropout generator as ClassificationHead
    does, and has no dropout of its own."""

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(x)


def _head(cfg: LayoutLMv3Config, n: int, device) -> Dense:
    """A flax nn.Dense left at dtype=None: float32 compute, lecun-normal
    init (std fan_in^-0.5)."""
    d = _Head(cfg.hidden_size, n, bias=True, dtype=torch.float32,
              param_dtype=torch.float32, device=device)
    d.init_std = cfg.hidden_size ** -0.5
    return d


class ClassificationHead(nn.Module):
    """dropout -> dense -> tanh -> dropout -> out_proj (modeling:990-1013),
    float32; the dropouts draw from `rng` (none: eval)."""

    def __init__(self, cfg: LayoutLMv3Config, num_labels: int, device=None):
        super().__init__()
        E = cfg.hidden_size
        self.rate = cfg.dropout
        self.dense = _head(cfg, E, device)
        self.out_proj = _head(cfg, num_labels, device)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.tanh(self.dense(dropout(x, self.rate, rng)))
        return self.out_proj(dropout(x, self.rate, rng))


@torch.no_grad()
def _init_layoutlmv3(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the flax initialisers' scales from `generator`:
    encoder projections xavier-uniform, embeddings and the bias tables
    normal(0.02), the patch projection and the heads lecun-normal (std
    fan_in^-0.5), the cls token and pos_embed zeros, norms ones/zeros."""
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, LayoutLMv3Model):
            for t in m.bias_tables():
                if t is not None:
                    t.normal_(0.0, 0.02, generator=generator)
            if hasattr(m, "patch_embed"):
                w = m.patch_embed.proj.weight
                w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
                m.patch_embed.proj.bias.zero_()
                m.cls_token.zero_()
                m.pos_embed.zero_()


class _LayoutLMv3Head(nn.Module):
    def init_weights(self, generator: torch.Generator):
        """Random weights (`_init_layoutlmv3`)."""
        _init_layoutlmv3(self, generator)
        return self


class LayoutLMv3ForTokenClassification(_LayoutLMv3Head):
    """FUNSD/CORD token classification (modeling:1015-1099): float32 logits
    [B, L, num_labels] for the text positions only; a linear classifier up
    to 12 layers, the dense-tanh head beyond, as the JAX module."""

    def __init__(self, cfg: LayoutLMv3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.layoutlmv3 = LayoutLMv3Model(cfg, device=device)
        self.classifier = (_head(cfg, cfg.num_labels, device)
                           if cfg.num_layers <= 12 else
                           ClassificationHead(cfg, cfg.num_labels, device))

    def forward(self, input_ids, bbox, attention_mask=None, images=None,
                valid_span=None, generator=None) -> torch.Tensor:
        seq = self.layoutlmv3(input_ids, bbox, attention_mask, images,
                              valid_span, generator)
        rng = training_rng(self, generator)
        text = dropout(seq[:, :input_ids.shape[1]], self.cfg.dropout, rng)
        return self.classifier(text, rng)


class LayoutLMv3ForSequenceClassification(_LayoutLMv3Head):
    """Document classification on the first token (modeling:1196)."""

    def __init__(self, cfg: LayoutLMv3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.layoutlmv3 = LayoutLMv3Model(cfg, device=device)
        self.classifier = ClassificationHead(cfg, cfg.num_labels, device)

    def forward(self, input_ids, bbox, attention_mask=None, images=None,
                valid_span=None, generator=None) -> torch.Tensor:
        seq = self.layoutlmv3(input_ids, bbox, attention_mask, images,
                              valid_span, generator)
        return self.classifier(seq[:, 0], training_rng(self, generator))


class LayoutLMv3ForQuestionAnswering(_LayoutLMv3Head):
    """Extractive QA (modeling:1101): (start, end) logits over the text."""

    def __init__(self, cfg: LayoutLMv3Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.layoutlmv3 = LayoutLMv3Model(cfg, device=device)
        self.qa_outputs = _head(cfg, 2, device)

    def forward(self, input_ids, bbox, attention_mask=None, images=None,
                valid_span=None, generator=None):
        seq = self.layoutlmv3(input_ids, bbox, attention_mask, images,
                              valid_span, generator)
        logits = self.qa_outputs(seq[:, :input_ids.shape[1]])
        return logits[..., 0], logits[..., 1]


def layoutlmv3_base(**kw) -> LayoutLMv3Config:
    return LayoutLMv3Config(**kw)


def layoutlmv3_large(**kw) -> LayoutLMv3Config:
    return LayoutLMv3Config(hidden_size=1024, num_layers=24, num_heads=16,
                            ffn_dim=4096, coordinate_size=171, shape_size=170,
                            **kw)
