"""DeltaLM: an encoder-decoder with an interleaved decoder (port of
unilm_tpu/models/deltalm.py: `DeltaLMConfig` :43, `DeltaLMDecoderLayer` :66,
`DeltaLMDecoder` :115, `DeltaLM` :131, `make_generate_fns` :192,
`interleave_decoder_init` :214, `deltalm_base` :251 and `deltalm_large`
:256).

A post-LN encoder-decoder whose decoder layer runs

    self-attn -> FFN_1 (`ffn_1` + `ffn_layer_norm`)
              -> cross-attn -> FFN_2 (`ffn` + `final_layer_norm`)

so that an L-layer pretrained encoder seeds both halves of an L/2-layer
decoder (`interleave_decoder_init`, on flax-layout trees). Learned
positions, no embedding scale, embedding LayerNorms (base), shared and
tied embeddings.

As in JAX, the decoder layers attend through `MultiheadAttention`'s own
cache (`cached_key` / `cached_value` [B, cache_size, H, D] and
`cache_index` per layer; the cross K/V [B, S, H, D] written by the
prefill), not the core stack's page pool: the cache is {"decoder":
{"layers_i": {"self_attn": {...}, "encoder_attn": {...}}}} with the JAX
collection's names, its tensors written in place. JAX sets
`use_flash=False` (:58), so every attention is the plain one, on the card
too: this model's path launches no kernel. `make_generate_fns` is
models/translation.py's (the same protocol; aux = `model.encode(src)`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from unilm_tpu_torch.core.attention import MultiheadAttention
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import PositionalEmbedding, TextEmbedding
from unilm_tpu_torch.core.layers import (FeedForward, dropout, layer_seeds,
                                         make_norm, seeded_generator)
from unilm_tpu_torch.core.transformer import Encoder
from unilm_tpu_torch.models.translation import (  # noqa: F401
    init_seq2seq_, make_generate_fns)
from unilm_tpu_torch.ops.attention import attention
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DeltaLMConfig:
    vocab_size: int = 64000
    embed_dim: int = 768
    enc_layers: int = 12
    dec_layers: int = 6
    num_heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 512
    dropout: float = 0.1
    pad_id: int = 1
    layernorm_embedding: bool = True  # base: True, large: False
    dtype: Any = torch.float32

    def tcfg(self, layers: int) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.embed_dim, num_heads=self.num_heads,
            ffn_dim=self.ffn_dim, num_layers=layers, dropout=self.dropout,
            activation="gelu", normalize_before=False,  # post-LN (base arch)
            dtype=self.dtype, use_flash=False)


class CachedAttention(MultiheadAttention):
    """`MultiheadAttention` with the JAX module's own generation cache
    (JAX core/attention.py :146-190): self-attention writes its new rows
    at `cache_index` and attends causally over the first cache_index + T
    slots; cross-attention projects the encoder output once at prefill."""

    def forward(self, x, key=None, *, mode: str, cache: Optional[Dict],
                cache_size: int = 0, key_padding_mask=None,
                causal: bool = False, rng=None):
        """Returns (out, cache) in prefill / decode, out in train mode."""
        if mode == "train":
            return self.forward_train(x, key, causal=causal,
                                      key_padding_mask=key_padding_mask,
                                      rng=rng)
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.head_dim
        B, T = x.shape[0], x.shape[1]
        q = self.q_proj(x).view(B, T, H, D)
        if not self.self_attention:
            if mode == "prefill":
                S = key.shape[1]
                cache = {"cross_key": self.k_proj(key).view(B, S, H, D),
                         "cross_value": self.v_proj(key).view(B, S, H, D)}
            out = attention(q, cache["cross_key"], cache["cross_value"],
                            key_padding_mask=key_padding_mask,
                            scale=self.scale, use_flash=cfg.use_flash)
            return self.output(out), cache
        k_new = self.k_proj(x).view(B, T, H, D)
        v_new = self.v_proj(x).view(B, T, H, D)
        if mode == "prefill":
            z = lambda: torch.zeros(B, cache_size, H, D, dtype=cfg.dtype,
                                    device=x.device)
            cache, start = {"cached_key": z(), "cached_value": z()}, 0
        else:
            start = int(cache["cache_index"])
        ck, cv = cache["cached_key"], cache["cached_value"]
        ck[:, start:start + T] = k_new.to(ck.dtype)
        cv[:, start:start + T] = v_new.to(cv.dtype)
        out = attention(q, ck, cv, scale=self.scale, causal=causal,
                        q_offset=start, kv_len=start + T,
                        use_flash=cfg.use_flash)
        return self.output(out), {"cached_key": ck, "cached_value": cv,
                                  "cache_index": start + T}


class DeltaLMDecoderLayer(nn.Module):
    """The interleaved layer (deltalm.py:140-377's order), post-LN."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.self_attn = CachedAttention(cfg, device=device)
        self.self_attn_layer_norm = make_norm(cfg, device=device)
        self.ffn_1 = FeedForward(cfg, device=device)
        self.ffn_layer_norm = make_norm(cfg, device=device)
        self.encoder_attn = CachedAttention(cfg, self_attention=False,
                                            device=device)
        self.encoder_attn_layer_norm = make_norm(cfg, device=device)
        self.ffn = FeedForward(cfg, device=device)
        self.final_layer_norm = make_norm(cfg, device=device)

    def _block(self, norm, fn, h, rng):
        residual = h
        if self.cfg.normalize_before:
            h = norm(h)
        h = residual + dropout(fn(h), self.cfg.dropout, rng)
        return h if self.cfg.normalize_before else norm(h)

    def forward(self, x, encoder_out, *, encoder_padding_mask=None,
                causal=True, mode="train", cache_size=0, cache=None,
                seed=None):
        """Returns x in train mode, (x, the layer's cache) otherwise."""
        rng = seeded_generator(seed, x.device)
        cache = cache or {}
        new = {}

        def attn(name, **kw):
            def fn(h):
                out = getattr(self, name)(h, mode=mode, cache=cache.get(name),
                                          cache_size=cache_size, rng=rng,
                                          **kw)
                if mode == "train":
                    return out
                out, new[name] = out
                return out
            return fn

        x = self._block(self.self_attn_layer_norm,
                        attn("self_attn", causal=causal), x, rng)
        x = self._block(self.ffn_layer_norm, lambda h: self.ffn_1(h, rng), x,
                        rng)
        x = self._block(self.encoder_attn_layer_norm,
                        attn("encoder_attn", key=encoder_out,
                             key_padding_mask=encoder_padding_mask), x, rng)
        x = self._block(self.final_layer_norm, lambda h: self.ffn(h, rng), x,
                        rng)
        return x if mode == "train" else (x, new)


class DeltaLMDecoder(nn.Module):
    """The stack of interleaved layers (post-LN: no final LayerNorm)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList([DeltaLMDecoderLayer(cfg, device=device)
                                     for _ in range(cfg.num_layers)])

    def forward(self, x, encoder_out, *, encoder_padding_mask=None,
                causal=True, mode="train", cache_size=0, cache=None,
                generator=None):
        cfg = self.cfg
        seeds = [None] * cfg.num_layers
        if self.training and cfg.dropout and mode == "train":
            if generator is None:
                raise ValueError("a training forward with dropout needs a "
                                 "torch.Generator (`generator=`)")
            seeds = layer_seeds(generator, cfg.num_layers)
        x = x.to(cfg.dtype)
        new = {}
        for i, layer in enumerate(self.layers):
            out = layer(x, encoder_out,
                        encoder_padding_mask=encoder_padding_mask,
                        causal=causal, mode=mode, cache_size=cache_size,
                        cache=None if cache is None else cache[f"layers_{i}"],
                        seed=seeds[i])
            if mode == "train":
                x = out
            else:
                x, new[f"layers_{i}"] = out
        return x if mode == "train" else (x, new)


class DeltaLM(nn.Module):
    """Encoder-decoder with shared embeddings and the tied output
    projection; the interface of models/translation.py's model."""

    def __init__(self, cfg: DeltaLMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        E, dt = cfg.embed_dim, cfg.dtype
        self.embed = TextEmbedding(cfg.vocab_size, E, dt, device=dev)
        self.enc_pos = PositionalEmbedding(cfg.max_positions, E, dtype=dt,
                                           device=dev)
        self.dec_pos = PositionalEmbedding(cfg.max_positions, E, dtype=dt,
                                           device=dev)
        if cfg.layernorm_embedding:
            # flax nn.LayerNorm(dtype=cfg.dtype): epsilon 1e-6
            ncfg = TransformerConfig(embed_dim=E, layernorm_eps=1e-6,
                                     dtype=dt)
            self.enc_emb_ln = make_norm(ncfg, device=dev)
            self.dec_emb_ln = make_norm(ncfg, device=dev)
        self.encoder = Encoder(cfg.tcfg(cfg.enc_layers), device=dev)
        self.decoder = DeltaLMDecoder(cfg.tcfg(cfg.dec_layers), device=dev)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DeltaLM":
        init_seq2seq_(self, generator)
        return self

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.linear(
            x, self.embed.embed.weight.to(x.dtype))

    def encode(self, src_tokens: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        S = src_tokens.shape[1]
        # no_scale_embedding=True (deltalm.py:396): no sqrt(d) factor
        x = self.embed(src_tokens) + self.enc_pos(
            torch.arange(S, device=src_tokens.device))
        if cfg.layernorm_embedding:
            x = self.enc_emb_ln(x)
        pad_mask = src_tokens != cfg.pad_id
        enc = self.encoder(x, key_padding_mask=pad_mask, generator=generator)
        return enc, pad_mask

    def _decode(self, prev_tokens, enc, enc_mask, mode, cache_size,
                positions=None, cache=None, generator=None):
        T = prev_tokens.shape[1]
        if positions is None:
            positions = torch.arange(T, device=prev_tokens.device)
        x = self.embed(prev_tokens) + self.dec_pos(positions)
        if self.cfg.layernorm_embedding:
            x = self.dec_emb_ln(x)
        out = self.decoder(x, enc, encoder_padding_mask=enc_mask, causal=True,
                           mode=mode, cache_size=cache_size, cache=cache,
                           generator=generator)
        if mode == "train":
            return self.attend(out)
        out, dec = out
        return self.attend(out), {"decoder": dec}

    def forward(self, src_tokens, prev_tgt_tokens, generator=None):
        enc, mask = self.encode(src_tokens, generator)
        return self._decode(prev_tgt_tokens, enc, mask, "train", 0,
                            generator=generator)

    @torch.no_grad()
    def prefill(self, prev_tokens, encoder_out: Tuple, cache_size: int):
        enc, mask = encoder_out
        return self._decode(prev_tokens, enc, mask, "prefill", cache_size)

    @torch.no_grad()
    def decode_step(self, prev_tokens, encoder_out: Tuple, cache: Dict,
                    cache_size: int):
        enc, mask = encoder_out
        start = cache["decoder"]["layers_0"]["self_attn"]["cache_index"]
        pos = start + torch.arange(prev_tokens.shape[1],
                                   device=prev_tokens.device)
        return self._decode(prev_tokens, None, mask, "decode", cache_size,
                            positions=pos, cache=cache["decoder"])


def interleave_decoder_init(params: Dict, encoder_params: Dict) -> Dict:
    """A DeltaLM flax-layout tree initialised from a pretrained L-layer
    encoder stack's tree (the paper's §3.2; deltalm.py:38-84's key
    mapping): the encoder copies every layer it has of the L; decoder
    layer k takes encoder layer 2k's self-attention and FFN (-> self_attn,
    ffn_1 and their norms) and layer 2k+1's (-> encoder_attn, ffn and
    theirs). Embeddings keep their current values. Leaves are copied."""
    out = copy.deepcopy(params)
    n_enc = len([k for k in encoder_params if k.startswith("layers_")])
    for i in range(n_enc):
        if f"layers_{i}" in out["encoder"]:
            out["encoder"][f"layers_{i}"] = copy.deepcopy(
                encoder_params[f"layers_{i}"])
    n_dec = len([k for k in out["decoder"] if k.startswith("layers_")])
    for k in range(n_dec):
        lo = encoder_params.get(f"layers_{2 * k}")
        hi = encoder_params.get(f"layers_{2 * k + 1}")
        dst = out["decoder"][f"layers_{k}"]
        if lo is not None:
            dst["self_attn"] = copy.deepcopy(lo["self_attn"])
            dst["self_attn_layer_norm"] = copy.deepcopy(
                lo["self_attn_layer_norm"])
            dst["ffn_1"] = copy.deepcopy(lo["ffn"])
            dst["ffn_layer_norm"] = copy.deepcopy(lo["final_layer_norm"])
        if hi is not None:
            dst["encoder_attn"] = copy.deepcopy(hi["self_attn"])
            dst["encoder_attn_layer_norm"] = copy.deepcopy(
                hi["self_attn_layer_norm"])
            dst["ffn"] = copy.deepcopy(hi["ffn"])
            dst["final_layer_norm"] = copy.deepcopy(hi["final_layer_norm"])
    return out


def deltalm_base(**kw) -> DeltaLMConfig:
    """deltalm.py:379-399 base_architecture."""
    return DeltaLMConfig(**kw)


def deltalm_large(**kw) -> DeltaLMConfig:
    """deltalm.py:401-415 large_architecture."""
    kw.setdefault("embed_dim", 1024)
    kw.setdefault("ffn_dim", 4096)
    kw.setdefault("enc_layers", 24)
    kw.setdefault("dec_layers", 12)
    kw.setdefault("num_heads", 16)
    kw.setdefault("layernorm_embedding", False)
    return DeltaLMConfig(**kw)
