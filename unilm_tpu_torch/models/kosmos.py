"""Kosmos-2 / Kosmos-2.5 UniGPT, text path (port of
unilm_tpu/models/kosmos.py: `sinusoidal_table` :46, `splice_image_features`
:288, `StepCounter` :303, `UniGPT` :314, `stack_unigpt_params` :540,
`make_unigpt_generate_fns` :551, `kosmos2_5` :590; the train forward
`UniGPT.__call__` :444 is `UniGPT.forward`).

The image and audio towers are not ported yet (ROADMAP Queue 1 slice 5):
`prefill` takes precomputed image features and splices them into the
embedding as the JAX model does, but a config that asks for a tower does
not construct, and `forward` refuses raw images or audio.

The generation cache is a nested dict with the JAX collection's names:
{"decoder": {"kv_pool_key", "kv_pool_value", "cache_index"},
 "step_counter": {"pos"}}; counters are Python ints, the pools are
updated in place (core/transformer.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import Dense, init_weights_
from unilm_tpu_torch.core.transformer import Decoder, stack_layer_params


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
    clip: Any = None  # tower configs: not ported yet (Queue 1 slice 5)
    pix2struct: Any = None
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
    return UniGPTConfig(**kw)


def _embedding(num, dim, init_std, dtype, device):
    emb = nn.Embedding(num, dim, device=device, dtype=dtype)
    emb.init_std = init_std
    return emb


class UniGPT(nn.Module):
    """GPT decoder with the multimodal embedding splice, text path."""

    def __init__(self, cfg: UniGPTConfig, device=None):
        super().__init__()
        if cfg.image_tower or cfg.audio_tower:
            raise NotImplementedError(
                "UniGPT image/audio towers are not ported yet: ROADMAP "
                "Queue 1 slice 5 (pass image_tower=None and precomputed "
                "img_features to prefill)")
        if cfg.quant_lm_head:
            raise NotImplementedError(
                "int8 LM head (QuantDense) is not ported yet: ROADMAP "
                "Queue 1, remainder of slices 0-2")
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

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UniGPT":
        """Random weights at the JAX initialisers' scales from `generator`
        (which must live on the parameters' device)."""
        init_weights_(self, generator)
        return self

    # ------------------------------------------------------------------ #
    def _positions(self, T: int, start: int, device) -> torch.Tensor:
        return start + torch.arange(T, device=device) + self.cfg.padding_idx + 1

    def _embed(self, tokens, img_features, img_mask, segment_tokens,
               positions):
        cfg = self.cfg
        emb = self.embed_tokens(tokens).to(self.dtype)
        emb = splice_image_features(emb, img_features, img_mask)
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
                aud_gpt_input_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Train forward over [B, T] tokens: logits [B, T, V], or the
        pre-logit decoder output [B, T, E] with return_features=True (for
        the chunked-vocabulary loss, ops/fused_ce.py). Every pad token is a
        masked key (`src_tokens != padding_idx`), as in JAX."""
        if img_inputs is not None or aud_inputs is not None:
            raise NotImplementedError(
                "UniGPT image/audio towers are not ported yet: ROADMAP "
                "Queue 1 slice 5")
        T = src_tokens.shape[1]
        x = self._embed(src_tokens, None, None, segment_tokens,
                        self._positions(T, 0, src_tokens.device))
        pad_mask = src_tokens != self.cfg.padding_idx
        x = self.decoder(x, mode="train", self_key_padding_mask=pad_mask,
                         causal=True)
        if return_features:
            return x
        return self.output_layer(x)

    def output_layer(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.share_input_output_embed:
            return F.linear(x, self.embed_tokens.weight.to(x.dtype))
        return self.output_projection(x)

    @torch.no_grad()
    def prefill(self, src_tokens: torch.Tensor, cache_size: int,
                img_features: Optional[torch.Tensor] = None,
                img_gpt_input_mask: Optional[torch.Tensor] = None,
                segment_tokens: Optional[torch.Tensor] = None,
                last_logit_only: bool = False) -> Tuple[torch.Tensor, Dict]:
        """Prompt pass: (logits [B, T or 1, V], fresh cache)."""
        T = src_tokens.shape[1]
        x = self._embed(src_tokens, img_features, img_gpt_input_mask,
                        segment_tokens,
                        self._positions(T, 0, src_tokens.device))
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
