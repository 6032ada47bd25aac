"""Kosmos-2 / Kosmos-2.5 UniGPT with both image towers (port of
unilm_tpu/models/kosmos.py: `sinusoidal_table` :46, `ClipVisionConfig` /
`ClipVisionEncoder` :66-114, `Pix2StructVisionConfig` /
`Pix2StructVisionEncoder` :116-164,
`LatentQueryResampler` :167-197, `splice_image_features` :288,
`StepCounter` :303, `UniGPT` :314 with `encode_image` (JAX's
`get_image_representation` :384-393 and `encode_image` :515 in one),
`quantize_lm_head` :522, `stack_unigpt_params` :540,
`make_unigpt_generate_fns` :551, `kosmos2` :581, `kosmos2_5` :590; the
train forward `UniGPT.__call__` :444 is `UniGPT.forward`; the audio tower
`aud_model` / `aud_connector` :367-381 with `encode_audio`, JAX's
`get_audio_representation` :395-403 and `encode_audio` :518 in one).

An image tower (open_clip's ViT-L/14 for Kosmos-2, Pix2Struct for
Kosmos-2.5) and the latent-query resampler feed the decoder:
`encode_image` gives the features that `prefill` splices into the
embedding, and `forward` takes raw images (CLIP: [B, H, W, 3]) or
flattened patches (Pix2Struct). As in JAX, the towers and the resampler
keep float32 params whatever `param_dtype` says, and the modules flax
leaves at dtype=None (CLIP's `ln_pre` and `ln_post`; Pix2Struct's patch
projection, row and column embedders and final RMSNorm; the resampler's
`dense`) compute in float32, so each tower's residual stream is float32
around its bf16 layers.

With `audio_tower="wavlm"` a WavLM tower (models/wavlm.py, `cfg.wavlm` or
its base config; float32, as JAX's) and its own resampler feed the same
splice: `encode_audio` L2-normalises the tower's frames and resamples
them to `audio_latent_query_num` latents, which `forward` (`aud_inputs`,
raw audio [B, samples]) and `prefill` (`aud_features`) place at
`aud_gpt_input_mask` after the image features (JAX :413-415).

Under `quant_lm_head` the logits come from `lm_head_q`, an int8
`QuantDense` [V, E] built from the head in use (`quantize_lm_head` on a
flax tree, `quantize_lm_head_state_dict` on a state dict). JAX gives it
`use_kernel=False` because XLA fuses the convert into the dot on a TPU;
here it launches the int8 matmul kernel (#14) on a CUDA tensor, since the
plain version would make a float32 copy of the [V, E] head every step.

The generation cache is a nested dict with the JAX collection's names:
{"decoder": {"kv_pool_key", "kv_pool_value", ["kv_pool_scale",]
 "cache_index"}, "step_counter": {"pos"}}; counters are Python ints, the
pools are updated in place (core/transformer.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.attention import MultiheadAttention
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, Norm, init_weights_
from unilm_tpu_torch.core.transformer import (Decoder, Encoder,
                                              stack_layer_params)
from unilm_tpu_torch.ops.quant import QuantDense, quantize_int8


def sinusoidal_table(num_positions: int, dim: int,
                     padding_idx: int = 1) -> np.ndarray:
    """fairseq SinusoidalPositionalEmbedding.get_embedding: half sin, half
    cos, row padding_idx zeroed; callers index at pad+1+step."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freq = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(num_positions, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    table[padding_idx] = 0.0
    return table.astype(np.float32)


def splice_image_features(token_embedding: torch.Tensor,
                          img_features: Optional[torch.Tensor],
                          img_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The k-th True position of row b receives img_features[b, k]
    (static-shape `emb[img_gpt_input_mask] = img_features`)."""
    if img_features is None or img_mask is None:
        return token_embedding
    idx = torch.cumsum(img_mask.to(torch.int64), dim=1) - 1
    idx = idx.clamp(0, img_features.shape[1] - 1)
    placed = torch.gather(
        img_features, 1,
        idx[..., None].expand(-1, -1, img_features.shape[-1]))
    return torch.where(img_mask[..., None],
                       placed.to(token_embedding.dtype), token_embedding)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """open_clip ViT-L/14 (the Kosmos-2 tower)."""

    img_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    layernorm_eps: float = 1e-5
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, ffn_dim=self.ffn_dim,
            num_layers=self.num_layers, num_heads=self.num_heads,
            normalize_before=True, activation="quick_gelu",
            layernorm_eps=self.layernorm_eps, dtype=self.dtype,
            use_flash=self.use_flash)


class ClipVisionEncoder(nn.Module):
    """CLIP visual tower without its projection head: a bias-free patch
    conv (`conv1`, OIHW) + `class_embedding` + `positional_embedding`,
    `ln_pre`, pre-LN quick_gelu blocks, `ln_post` over every token.

    Input [B, H, W, 3] float images (H = W = img_size); output [B, 1 +
    (H/p)^2, E] float32: `ln_pre` and `ln_post` output float32, so the
    residual stream is float32 while the conv, the projections and the
    attention compute in cfg.dtype."""

    def __init__(self, cfg: ClipVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.transformer()
        E, p = cfg.embed_dim, cfg.patch_size
        n = (cfg.img_size // p) ** 2 + 1
        self.conv1 = nn.Conv2d(3, E, p, stride=p, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(E, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(n, E, device=device))
        self.ln_pre = Norm(tcfg, device=device, dtype=torch.float32)
        self.transformer = Encoder(tcfg, final_layer_norm=False,
                                   device=device)
        self.ln_post = Norm(tcfg, device=device, dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """conv1 normal(fan_in^-0.5) (flax Conv's lecun scale), the class
        and position embeddings normal(E^-0.5), as flax's initialisers."""
        E = self.cfg.embed_dim
        w = self.conv1.weight
        w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)
        self.class_embedding.normal_(0.0, E ** -0.5, generator=generator)
        self.positional_embedding.normal_(0.0, E ** -0.5, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = F.conv2d(images.permute(0, 3, 1, 2).to(dt),
                     self.conv1.weight.to(dt), stride=self.cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, E], row-major patches
        B, _, E = x.shape
        cls = self.class_embedding.to(x.dtype).expand(B, 1, E)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x)


@dataclasses.dataclass(frozen=True)
class Pix2StructVisionConfig:
    """HF Pix2StructVisionModel (the Kosmos-2.5 tower over up to 4096
    variable-resolution patches)."""

    hidden_size: int = 1536
    num_layers: int = 18
    num_heads: int = 24
    d_ff: int = 3968
    d_kv: int = 64
    patch_dim: int = 768  # 16*16*3 flattened patch
    max_rows: int = 4096
    layernorm_eps: float = 1e-6
    dtype: Any = torch.float32
    use_flash: bool = True

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.hidden_size, ffn_dim=self.d_ff,
            num_layers=self.num_layers, num_heads=self.num_heads,
            head_dim=self.d_kv, normalize_before=True,
            activation="geglu_new", norm_type="rmsnorm", use_bias=False,
            attn_scale=1.0, layernorm_eps=self.layernorm_eps,
            dtype=self.dtype, use_flash=self.use_flash)


class Pix2StructVisionEncoder(nn.Module):
    """T5-style vision encoder over pre-extracted flattened patches.

    Input [B, N, 2 + patch_dim]: columns 0/1 are the (row+1, col+1) ids,
    the rest the flattened patch; all-zero rows are padding. RMSNorm, gated
    gelu_new FFN, no biases, UNSCALED attention (attn_scale 1.0, T5's
    convention), d_kv-sized heads. Returns (features [B, N, hidden] float32,
    mask [B, N] bool); padded rows are zero before and after the encoder,
    whose attention masks them as keys."""

    def __init__(self, cfg: Pix2StructVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.transformer()
        E = cfg.hidden_size
        self.patch_projection = Dense(cfg.patch_dim, E, bias=True,
                                      dtype=torch.float32,
                                      param_dtype=torch.float32,
                                      device=device)
        self.row_embedder = _embedding(cfg.max_rows, E, E ** -0.5,
                                       torch.float32, device)
        self.column_embedder = _embedding(cfg.max_rows, E, E ** -0.5,
                                          torch.float32, device)
        self.encoder = Encoder(tcfg, final_layer_norm=False, device=device)
        self.layernorm = Norm(tcfg, device=device, dtype=torch.float32)

    def forward(self, flattened_patches: torch.Tensor):
        mask = flattened_patches.abs().sum(-1) > 0  # [B, N]
        rows = flattened_patches[..., 0].to(torch.int64)
        cols = flattened_patches[..., 1].to(torch.int64)
        x = self.patch_projection(flattened_patches[..., 2:])
        x = x + self.row_embedder(rows) + self.column_embedder(cols)
        x = x * mask[..., None].to(x.dtype)
        x = self.encoder(x, key_padding_mask=mask)
        x = self.layernorm(x)
        return x * mask[..., None].to(x.dtype), mask


class LatentQueryResampler(nn.Module):
    """XConnector: dense projection (float32) + `num_latents` latent
    queries (float32 params) cross-attending over [features ++ latents]."""

    def __init__(self, input_dim: int, output_dim: int, num_latents: int,
                 num_heads: int, dtype=torch.float32, use_flash: bool = True,
                 device=None):
        super().__init__()
        self.dense = Dense(input_dim, output_dim, bias=True,
                           dtype=torch.float32, param_dtype=torch.float32,
                           device=device)
        self.latent_query = nn.Parameter(
            torch.zeros(num_latents, output_dim, device=device))
        acfg = TransformerConfig(embed_dim=output_dim, num_heads=num_heads,
                                 dtype=dtype, use_flash=use_flash)
        self.x_attn = MultiheadAttention(acfg, self_attention=False,
                                         device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        B = features.shape[0]
        x = self.dense(features)
        latent = self.latent_query.to(x.dtype)[None].expand(B, -1, -1)
        kv = torch.cat([x, latent], dim=1)
        return self.x_attn.forward_train(latent, kv)


@dataclasses.dataclass(frozen=True)
class UniGPTConfig:
    vocab_size: int = 65037
    embed_dim: int = 2048
    num_layers: int = 24
    num_heads: int = 32
    ffn_dim: int = 8192
    max_positions: int = 6144
    padding_idx: int = 1
    subln: bool = True
    xpos_rel_pos: bool = True
    scale_length: int = 2048
    learned_pos: bool = False  # False = fairseq sinusoidal
    use_positional: bool = True
    scale_embedding: bool = True
    share_input_output_embed: bool = True
    segment_emb: bool = False
    prefix_lm_prefill: bool = False
    activation: str = "gelu"
    dropout: float = 0.0
    moe_freq: int = 0
    moe_experts: int = 0
    moe_top: int = 2
    moe_capacity_factor: float = 1.0
    moe_eval_capacity_factor: float = 2.0
    moe_gate_dim: int = 0
    moe_second_expert_policy: str = "random"
    remat: bool = False
    remat_policy: str = "full"
    image_tower: Optional[str] = None  # 'clip' | 'pix2struct' | None
    latent_query_num: int = 64
    clip: ClipVisionConfig = ClipVisionConfig()
    pix2struct: Pix2StructVisionConfig = Pix2StructVisionConfig()
    audio_tower: Optional[str] = None
    audio_latent_query_num: int = 64
    wavlm: Any = None
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    use_flash: bool = True
    quant_weights: bool = False
    scan_layers: bool = False
    kv_cache_dtype: str = "model"
    quant_lm_head: bool = False

    def decoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, embed_dim=self.embed_dim,
            ffn_dim=self.ffn_dim, num_layers=self.num_layers,
            num_heads=self.num_heads, subln=self.subln,
            xpos_rel_pos=self.xpos_rel_pos, scale_length=self.scale_length,
            activation=self.activation, dropout=self.dropout,
            moe_freq=self.moe_freq, moe_experts=self.moe_experts,
            moe_top=self.moe_top,
            moe_capacity_factor=self.moe_capacity_factor,
            moe_eval_capacity_factor=self.moe_eval_capacity_factor,
            moe_gate_dim=self.moe_gate_dim,
            moe_second_expert_policy=self.moe_second_expert_policy,
            remat=self.remat, remat_policy=self.remat_policy,
            dtype=self.dtype, param_dtype=self.param_dtype,
            use_flash=self.use_flash, quant_weights=self.quant_weights,
            scan_layers=self.scan_layers, kv_cache_dtype=self.kv_cache_dtype,
        )


def kosmos2(**kw) -> UniGPTConfig:
    """Kosmos-2 1.6B: the open_clip ViT-L/14 tower, 64 latent queries and
    the 24-layer E=2048 UniGPT decoder (32 heads, FFN 8192, vocab 65037,
    subln + xPos). The tower inherits the compute dtype."""
    kw.setdefault("image_tower", "clip")
    kw.setdefault("latent_query_num", 64)
    if "dtype" in kw and "clip" not in kw:
        kw["clip"] = ClipVisionConfig(dtype=kw["dtype"])
    return UniGPTConfig(**kw)


def kosmos2_5(**kw) -> UniGPTConfig:
    """Kosmos-2.5 1.3B: Pix2Struct-large tower, 2048 latent queries,
    24 layers, E=1536, 16 heads, FFN 6144, vocab 108481."""
    kw.setdefault("image_tower", "pix2struct")
    kw.setdefault("latent_query_num", 2048)
    kw.setdefault("vocab_size", 108481)
    kw.setdefault("embed_dim", 1536)
    kw.setdefault("num_heads", 16)
    kw.setdefault("ffn_dim", 6144)
    kw.setdefault("segment_emb", True)
    # the vision tower inherits the compute dtype (the TTFT path runs it in
    # bf16, like the reference's .half())
    if "dtype" in kw and "pix2struct" not in kw:
        kw["pix2struct"] = Pix2StructVisionConfig(dtype=kw["dtype"])
    return UniGPTConfig(**kw)


def _embedding(num, dim, init_std, dtype, device):
    emb = nn.Embedding(num, dim, device=device, dtype=dtype)
    emb.init_std = init_std
    return emb


class UniGPT(nn.Module):
    """GPT decoder with the multimodal embedding splice, an image tower
    (CLIP or Pix2Struct) and the resampler."""

    def __init__(self, cfg: UniGPTConfig, device=None):
        super().__init__()
        if cfg.image_tower not in (None, "clip", "pix2struct"):
            raise ValueError(f"unknown image tower {cfg.image_tower!r}")
        if cfg.audio_tower not in (None, "wavlm"):
            raise ValueError(f"unknown audio tower {cfg.audio_tower!r}")
        self.cfg = cfg
        tcfg = cfg.decoder_cfg()
        self.dtype = tcfg.dtype
        E = cfg.embed_dim
        self.embed_tokens = _embedding(cfg.vocab_size, E, E ** -0.5,
                                       cfg.param_dtype, device)
        self.decoder = Decoder(tcfg, device=device)
        if not cfg.share_input_output_embed:
            # the JAX head leaves param_dtype at its float32 default
            self.output_projection = Dense(
                E, cfg.vocab_size, bias=False, dtype=tcfg.dtype,
                param_dtype=torch.float32, device=device)
            self.output_projection.init_std = E ** -0.5
        if cfg.quant_lm_head:
            self.lm_head_q = QuantDense(E, cfg.vocab_size, bias=False,
                                        dtype=tcfg.dtype, device=device)
        if cfg.use_positional and cfg.learned_pos:
            self.embed_positions = _embedding(
                cfg.max_positions + cfg.padding_idx + 1, E, E ** -0.5,
                cfg.param_dtype, device)
        if cfg.use_positional and not cfg.learned_pos:
            table = sinusoidal_table(cfg.max_positions + cfg.padding_idx + 1,
                                     E, cfg.padding_idx)
            self.register_buffer("pos_table",
                                 torch.from_numpy(table).to(device),
                                 persistent=False)
        if cfg.segment_emb:
            # flax nn.Embed defaults: float32 params, std ~ 1/sqrt(E)
            self.segment_emb = _embedding(2, E, E ** -0.5, torch.float32,
                                          device)
        if cfg.image_tower == "clip":
            self.img_model = ClipVisionEncoder(cfg.clip, device=device)
            conn_in = cfg.clip.embed_dim
        elif cfg.image_tower == "pix2struct":
            self.img_model = Pix2StructVisionEncoder(cfg.pix2struct,
                                                     device=device)
            conn_in = cfg.pix2struct.hidden_size
        if cfg.image_tower:
            self.img_connector = LatentQueryResampler(
                conn_in, E, cfg.latent_query_num, cfg.num_heads,
                dtype=cfg.dtype, use_flash=cfg.use_flash, device=device)
        if cfg.audio_tower:
            from unilm_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

            wcfg = (cfg.wavlm if cfg.wavlm is not None
                    else WavLMConfig(dtype=cfg.dtype))
            self.aud_model = WavLMModel(
                wcfg, device=torch.device("cpu") if device is None else device)
            self.aud_connector = LatentQueryResampler(
                wcfg.hidden_size, E, cfg.audio_latent_query_num,
                cfg.num_heads, dtype=cfg.dtype, use_flash=cfg.use_flash,
                device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UniGPT":
        """Random weights at the JAX initialisers' scales from `generator`
        (which must live on the parameters' device); the latent queries
        normal(1.0), as flax's."""
        init_weights_(self, generator)
        if isinstance(getattr(self, "img_model", None), ClipVisionEncoder):
            self.img_model.init_weights(generator)
        if hasattr(self, "img_connector"):
            self.img_connector.latent_query.normal_(0.0, 1.0,
                                                    generator=generator)
        if hasattr(self, "aud_model"):
            self.aud_model.rel_attn_embed.normal_(0.0, 0.02,
                                                  generator=generator)
            self.aud_connector.latent_query.normal_(0.0, 1.0,
                                                    generator=generator)
        return self

    # ------------------------------------------------------------------ #
    def encode_image(self, img_inputs: torch.Tensor) -> torch.Tensor:
        """Tower -> L2 normalize (+1e-6, in the tower's float32) ->
        latent-query resample: [B, latent_query_num, E] in the compute
        dtype. `img_inputs`: images [B, H, W, 3] (CLIP) or flattened
        patches (Pix2Struct)."""
        if not hasattr(self, "img_model"):
            raise ValueError("this UniGPT has no image tower "
                             "(image_tower=None)")
        feats = self.img_model(img_inputs)
        if self.cfg.image_tower == "pix2struct":
            feats = feats[0]
        feats = feats / (torch.linalg.vector_norm(feats, dim=-1,
                                                  keepdim=True) + 1e-6)
        return self.img_connector(feats)

    def encode_audio(self, aud_inputs: torch.Tensor) -> torch.Tensor:
        """Raw audio [B, samples] -> WavLM tower -> L2 normalize (+1e-6,
        float32) -> latent-query resample: [B, audio_latent_query_num, E]
        in the compute dtype."""
        if not hasattr(self, "aud_model"):
            raise ValueError("this UniGPT has no audio tower "
                             "(audio_tower=None)")
        feats = self.aud_model(aud_inputs)
        feats = feats / (torch.linalg.vector_norm(feats, dim=-1,
                                                  keepdim=True) + 1e-6)
        return self.aud_connector(feats)

    # ------------------------------------------------------------------ #
    def _positions(self, T: int, start: int, device) -> torch.Tensor:
        return start + torch.arange(T, device=device) + self.cfg.padding_idx + 1

    def _embed(self, tokens, img_features, img_mask, segment_tokens,
               positions, aud_features=None, aud_mask=None):
        cfg = self.cfg
        emb = self.embed_tokens(tokens).to(self.dtype)
        emb = splice_image_features(emb, img_features, img_mask)
        # the audio splice: the images' scatter contract (gpt.py:264-265)
        emb = splice_image_features(emb, aud_features, aud_mask)
        x = emb * (cfg.embed_dim ** 0.5 if cfg.scale_embedding else 1.0)
        if cfg.use_positional:
            if cfg.learned_pos:
                pos = self.embed_positions(positions)
            else:
                pos = self.pos_table[positions]
            if cfg.segment_emb and segment_tokens is not None:
                pos = pos + self.segment_emb(segment_tokens)
            if pos.ndim == 2:
                pos = pos[None]
            x = x + pos.to(x.dtype)
        return x

    def forward(self, src_tokens: torch.Tensor,
                img_inputs: Optional[torch.Tensor] = None,
                img_gpt_input_mask: Optional[torch.Tensor] = None,
                segment_tokens: Optional[torch.Tensor] = None,
                return_features: bool = False,
                aud_inputs: Optional[torch.Tensor] = None,
                aud_gpt_input_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Train forward over [B, T] tokens: logits [B, T, V], or the
        pre-logit decoder output [B, T, E] with return_features=True (for
        the chunked-vocabulary loss, ops/fused_ce.py). Every pad token is a
        masked key (`src_tokens != padding_idx`), as in JAX. `img_inputs`
        (images or flattened patches, as `encode_image` takes) go through
        the tower and the resampler and are spliced at
        `img_gpt_input_mask`, raw audio `aud_inputs` [B, samples] through
        the audio tower at `aud_gpt_input_mask`. `generator`: the
        decoder's dropout masks in training (cfg.dropout, JAX's
        `decoder_cfg` :272; UniGPT has no embedding dropout)."""
        img_feats = (self.encode_image(img_inputs)
                     if img_inputs is not None else None)
        aud_feats = (self.encode_audio(aud_inputs)
                     if aud_inputs is not None else None)
        T = src_tokens.shape[1]
        x = self._embed(src_tokens, img_feats, img_gpt_input_mask,
                        segment_tokens, self._positions(T, 0,
                                                        src_tokens.device),
                        aud_feats, aud_gpt_input_mask)
        pad_mask = src_tokens != self.cfg.padding_idx
        x = self.decoder(x, mode="train", self_key_padding_mask=pad_mask,
                         causal=True, generator=generator)
        if return_features:
            return x
        return self.output_layer(x)

    def output_layer(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.quant_lm_head:
            return self.lm_head_q(x)
        if self.cfg.share_input_output_embed:
            return F.linear(x, self.embed_tokens.weight.to(x.dtype))
        return self.output_projection(x)

    @torch.no_grad()
    def prefill(self, src_tokens: torch.Tensor, cache_size: int,
                img_features: Optional[torch.Tensor] = None,
                img_gpt_input_mask: Optional[torch.Tensor] = None,
                segment_tokens: Optional[torch.Tensor] = None,
                last_logit_only: bool = False,
                aud_features: Optional[torch.Tensor] = None,
                aud_gpt_input_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Prompt pass: (logits [B, T or 1, V], fresh cache); the image and
        audio features (`encode_image` / `encode_audio`) are spliced at
        their masks."""
        T = src_tokens.shape[1]
        x = self._embed(src_tokens, img_features, img_gpt_input_mask,
                        segment_tokens,
                        self._positions(T, 0, src_tokens.device),
                        aud_features, aud_gpt_input_mask)
        x, dec = self.decoder(x, mode="prefill", cache_size=cache_size,
                              causal=not self.cfg.prefix_lm_prefill)
        if last_logit_only:
            # generation reads only the final position's logits
            x = x[:, -1:]
        return self.output_layer(x), {"decoder": dec,
                                      "step_counter": {"pos": T}}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict,
                    cache_size: int) -> Tuple[torch.Tensor, Dict]:
        """One decode step: (logits [B, T, V], cache). The cache's pools
        are updated in place; its counters advance by T."""
        start = cache["step_counter"]["pos"]
        T = tokens.shape[1]
        x = self._embed(tokens, None, None, None,
                        self._positions(T, start, tokens.device))
        x, dec = self.decoder(x, mode="decode", cache_size=cache_size,
                              cache=cache["decoder"], causal=True)
        return self.output_layer(x), {"decoder": dec,
                                      "step_counter": {"pos": start + T}}


def quantize_lm_head(params: dict) -> dict:
    """Flax-layout tree -> the tree plus `lm_head_q` {kernel_i8 [E, V],
    scale [V]}: the int8 head of UniGPTConfig(quant_lm_head=True), built
    from the head the model uses (the untied `output_projection` if the
    tree has one, else the tied embedding's transpose) with per-vocab
    scales. The embedding stays for the lookup. Leaves are numpy arrays,
    bit-equal to JAX's."""
    from unilm_tpu_torch.convert.from_jax import to_tensor

    out = dict(params)
    if "output_projection" in out:
        w = to_tensor(out["output_projection"]["kernel"])  # [E, V]
    else:
        w = to_tensor(out["embed_tokens"]["embedding"]).t()  # [E, V]
    wi, scale = quantize_int8(w, axis=0)
    out["lm_head_q"] = {"kernel_i8": wi.numpy(), "scale": scale.numpy()}
    return out


def quantize_lm_head_state_dict(sd: Dict[str, torch.Tensor]) -> dict:
    """`quantize_lm_head` on a UniGPT state dict: adds `lm_head_q.weight_i8`
    [V, E] int8 and `lm_head_q.scale` [V] f32 from `output_projection.weight`
    if present, else `embed_tokens.weight` (the same values as the tree
    version, transposed). Runs on the tensors' device."""
    out = dict(sd)
    w = sd.get("output_projection.weight", sd["embed_tokens.weight"])
    out["lm_head_q.weight_i8"], out["lm_head_q.scale"] = quantize_int8(
        w, axis=1)
    return out


def stack_unigpt_params(params: dict, num_layers: int) -> dict:
    """Looped UniGPT param tree (decoder/layers_i) -> scanned form
    (decoder/layers stacked on axis 0). Other entries pass through."""
    out = dict(params)
    out["decoder"] = stack_layer_params(dict(params["decoder"]), num_layers)
    return out


def make_unigpt_generate_fns(model: UniGPT, cache_size: int):
    """(prefill, step) closures for runtime.generate. `aux` carries
    (img_features, img_gpt_input_mask, segment_tokens) or None."""

    def prefill(tokens, aux):
        img_features = img_mask = segs = None
        if aux is not None:
            img_features, img_mask, segs = aux
        return model.prefill(tokens, cache_size, img_features, img_mask, segs,
                             last_logit_only=True)

    def step(tokens, cache, aux):
        return model.decode_step(tokens, cache, cache_size)

    return prefill, step
