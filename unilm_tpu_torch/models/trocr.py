"""TrOCR: a ViT/DeiT encoder, a text decoder with cross-attention, beam
search (port of unilm_tpu/models/trocr.py: `TrOCRConfig` :29,
`ViTEncoder` :87, `TrOCRDecoder` :114, `TrOCRModel` :192,
`quantize_trocr_decoder` :226, `stack_trocr_params` :245,
`make_generate_fns` :257, `trocr_base` / `trocr_large` / `trocr_small`
:281-304).

The encoder patchifies the NHWC image, prepends the cls token (and
DeiT's distillation token), adds learned absolute positions and runs a
pre-LN `Encoder` with its final LayerNorm. The decoder embeds the tokens
(fairseq's learned positions at `pos_offset` 2, the optional
`layernorm_embedding`, which like the flax module's computes in float32)
and runs `Decoder(has_cross_attention=True)` over the encoder's output.
The port has one decoder stack, the scanned one, so the config has no
`scan_layers`: a looped or a stacked flax tree loads into it through
convert/from_jax.py, and JAX shows loop == scan
(tests/test_scan_stack.py).

The generation cache is a nested dict with the JAX collection's names:
{"text_decoder": {"pos", "decoder": {"kv_pool_key", "kv_pool_value",
"cache_index", "cross_key", "cross_value"}}}; `pos` and `cache_index`
are Python ints. Prefill fills the cross K/V once; decode steps read them
and take no encoder output, as the JAX step passes None.

Under `quant_weights` the decoder's layer projections and the
`output_projection` head are int8 `QuantDense`s (`quantize_trocr_decoder`
on a flax tree, `quantize_trocr_decoder_state_dict` on a state dict; the
encoder stays in full precision). The JAX head takes `use_kernel=False`
for a TPU reason; here every QuantDense launches the int8 matmul kernel
(#14) on a CUDA tensor, as models/kosmos.py's int8 head does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.embedding import PatchEmbed
from unilm_tpu_torch.core.layers import (Dense, Norm, dropout, init_weights_,
                                         training_rng)
from unilm_tpu_torch.core.transformer import (Decoder, Encoder,
                                              stack_layer_params)
from unilm_tpu_torch.ops.quant import (PROJECTIONS, QuantDense,
                                       quantize_dense_tree, quantize_int8)


@dataclasses.dataclass(frozen=True)
class TrOCRConfig:
    # encoder (ViT/DeiT)
    img_size: int = 384
    patch_size: int = 16
    enc_dim: int = 768
    enc_layers: int = 12
    enc_heads: int = 12
    enc_ffn: int = 3072
    distilled: bool = True  # DeiT distillation token
    enc_eps: float = 1e-6
    # decoder
    vocab_size: int = 50265
    dec_dim: int = 1024
    dec_layers: int = 12
    dec_heads: int = 16
    dec_ffn: int = 4096
    max_positions: int = 512
    pos_offset: int = 2  # fairseq padding_idx + 1
    scale_embedding: bool = False
    layernorm_embedding: bool = True
    normalize_before: bool = False  # trocr-base's decoder is post-LN
    share_input_output_embed: bool = False
    dec_eps: float = 1e-5
    activation: str = "gelu"
    dropout: float = 0.0
    enc_to_dec_proj: bool = False  # HF VisionEncoderDecoder's width bridge
    dtype: Any = torch.float32
    use_flash: bool = True
    quant_weights: bool = False  # int8 decoder projections + head

    def encoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            embed_dim=self.enc_dim, ffn_dim=self.enc_ffn,
            num_layers=self.enc_layers, num_heads=self.enc_heads,
            normalize_before=True, layernorm_eps=self.enc_eps,
            dtype=self.dtype, use_flash=self.use_flash, dropout=self.dropout)

    def decoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, embed_dim=self.dec_dim,
            ffn_dim=self.dec_ffn, num_layers=self.dec_layers,
            num_heads=self.dec_heads, normalize_before=self.normalize_before,
            layernorm_eps=self.dec_eps, activation=self.activation,
            is_encoder_decoder=True, dtype=self.dtype,
            use_flash=self.use_flash, dropout=self.dropout,
            quant_weights=self.quant_weights)

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


class ViTEncoder(nn.Module):
    """DeiT-style ViT: patchify, cls (+ distillation) token, learned
    absolute positions, pre-LN blocks, final LayerNorm. Images [B, H, W, 3]
    -> [B, prefix + patches, enc_dim]."""

    def __init__(self, cfg: TrOCRConfig, device=None):
        super().__init__()
        tcfg = cfg.encoder_cfg()
        E = cfg.enc_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, E, 3, tcfg.dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, E, device=device))
        if cfg.distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, E,
                                                       device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.num_patches + cfg.num_prefix_tokens, E, device=device))
        self.encoder = Encoder(tcfg, device=device)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed(images)
        B, _, E = x.shape
        toks = [self.cls_token.to(x.dtype).expand(B, 1, E)]
        if hasattr(self, "dist_token"):
            toks.append(self.dist_token.to(x.dtype).expand(B, 1, E))
        x = torch.cat(toks + [x], dim=1) + self.pos_embed.to(x.dtype)
        x = dropout(x, self.encoder.cfg.dropout,
                    training_rng(self, generator))
        return self.encoder(x, generator=generator)


class TrOCRDecoder(nn.Module):
    """Token + position embedding, `layernorm_embedding`, the
    cross-attention decoder stack and the output head."""

    def __init__(self, cfg: TrOCRConfig, device=None):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.decoder_cfg()
        self.dtype = tcfg.dtype
        E = cfg.dec_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=device)
        self.embed_tokens.init_std = E ** -0.5
        self.embed_positions = nn.Parameter(torch.zeros(
            cfg.max_positions + cfg.pos_offset, E, device=device))
        if cfg.layernorm_embedding:
            # flax LayerNorm at dtype=None: float32 out of float32 params
            self.layernorm_embedding = Norm(tcfg, device=device,
                                            dtype=torch.float32)
        enc_width = E if cfg.enc_to_dec_proj else cfg.enc_dim
        self.decoder = Decoder(tcfg, has_cross_attention=True,
                               encoder_dim=enc_width, device=device)
        if cfg.share_input_output_embed:
            return
        if cfg.quant_weights:
            self.output_projection = QuantDense(E, cfg.vocab_size, bias=False,
                                                dtype=tcfg.dtype,
                                                device=device)
        else:
            self.output_projection = Dense(E, cfg.vocab_size, bias=False,
                                           dtype=tcfg.dtype,
                                           param_dtype=torch.float32,
                                           device=device)
            self.output_projection.init_std = E ** -0.5  # lecun-normal

    def embed(self, tokens: torch.Tensor, start: int) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed_tokens(tokens).to(self.dtype)
        if cfg.scale_embedding:
            x = x * (cfg.dec_dim ** 0.5)
        pos = start + cfg.pos_offset + torch.arange(tokens.shape[1],
                                                    device=tokens.device)
        x = x + self.embed_positions[pos].to(x.dtype)
        if hasattr(self, "layernorm_embedding"):
            x = self.layernorm_embedding(x)
        return x

    def output_layer(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.share_input_output_embed:
            return F.linear(x, self.embed_tokens.weight.to(x.dtype))
        return self.output_projection(x)

    def forward(self, tokens: torch.Tensor,
                encoder_out: Optional[torch.Tensor], *, mode: str = "train",
                cache_size: int = 0, cache: Optional[Dict] = None,
                return_features: bool = False,
                generator: Optional[torch.Generator] = None):
        """mode "train": logits [B, T, V] (the decoder output [B, T, E]
        with return_features); in training `generator` draws the
        embedding's dropout (JAX :161), then the stack's. mode "prefill" |
        "decode": (logits, cache); decode reads `cache` and ignores
        `encoder_out`."""
        start = 0 if mode != "decode" else cache["pos"]
        x = self.embed(tokens, start)
        if mode == "train":
            x = dropout(x, self.cfg.dropout, training_rng(self, generator))
            x = self.decoder(x, mode="train", encoder_out=encoder_out,
                             generator=generator)
            return x if return_features else self.output_layer(x)
        x, dec = self.decoder(
            x, mode=mode, cache_size=cache_size,
            cache=None if cache is None else cache["decoder"],
            encoder_out=encoder_out if mode == "prefill" else None)
        return self.output_layer(x), {"pos": start + tokens.shape[1],
                                      "decoder": dec}


class TrOCRModel(nn.Module):
    """The encoder-decoder: `encode`, `prefill`, `decode_step`, and the
    teacher-forced `forward`."""

    def __init__(self, cfg: TrOCRConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vit = ViTEncoder(cfg, device=device)
        self.text_decoder = TrOCRDecoder(cfg, device=device)
        if cfg.enc_to_dec_proj:
            # flax Dense at dtype=None: float32
            self.enc_to_dec_proj = Dense(cfg.enc_dim, cfg.dec_dim, bias=True,
                                         dtype=torch.float32,
                                         param_dtype=torch.float32,
                                         device=device)
            self.enc_to_dec_proj.init_std = cfg.enc_dim ** -0.5

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TrOCRModel":
        """Random weights at the JAX initialisers' scales from `generator`
        (on the parameters' device): projections xavier-uniform, the
        patch projection and the heads lecun-normal, the embeddings and
        embed_positions normal(dec_dim^-0.5), norms ones/zeros; cls, dist
        and pos_embed stay zero, as flax's."""
        init_weights_(self, generator)
        w = self.vit.patch_embed.proj.weight
        w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)
        self.vit.patch_embed.proj.bias.zero_()
        self.text_decoder.embed_positions.normal_(
            0.0, self.cfg.dec_dim ** -0.5, generator=generator)
        return self

    def encode(self, images: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Images [B, H, W, 3] -> encoder output [B, S, E] (through
        enc_to_dec_proj where the config has one); `generator`: the
        encoder's dropout in training (JAX :110)."""
        enc = self.vit(images, generator)
        if hasattr(self, "enc_to_dec_proj"):
            enc = self.enc_to_dec_proj(enc)
        return enc

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, encoder_out: torch.Tensor,
                cache_size: int) -> Tuple[torch.Tensor, Dict]:
        """Prompt pass: (logits [B, P, V], a fresh cache holding the cross
        K/V of `encoder_out`)."""
        logits, td = self.text_decoder(tokens, encoder_out, mode="prefill",
                                       cache_size=cache_size)
        return logits, {"text_decoder": td}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict,
                    cache_size: int) -> Tuple[torch.Tensor, Dict]:
        """One step: (logits [B, T, V], cache); the pools are written in
        place, the counters advance by T. B may be beams x the cross
        cache's batch."""
        logits, td = self.text_decoder(tokens, None, mode="decode",
                                       cache_size=cache_size,
                                       cache=cache["text_decoder"])
        return logits, {"text_decoder": td}

    def forward(self, images: torch.Tensor, prev_tokens: torch.Tensor,
                return_features: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits; in training (`model.train()` with a
        dropout rate) `generator` draws every mask, the encoder's first."""
        return self.text_decoder(prev_tokens, self.encode(images, generator),
                                 return_features=return_features,
                                 generator=generator)


def _is_trocr_quantized(path) -> bool:
    """The JAX predicate of `quantize_trocr_decoder` (:235-240) on a path
    ending in the kernel's name: the text decoder's head, and its layer
    projections."""
    path = tuple(path)
    if "text_decoder" not in path:
        return False
    if path[-2] == "output_projection":
        return True
    return path[-2] in PROJECTIONS and any(s.startswith("layers")
                                           for s in path)


def quantize_trocr_decoder(params: dict) -> dict:
    """Flax-layout tree -> the tree of TrOCRConfig(quant_weights=True):
    every text-decoder projection and the output head int8 per output
    channel (`kernel_i8` + `scale`); the encoder, the embeddings and the
    norms stay. Looped or stacked trees; numpy leaves, bit-equal to
    JAX's."""
    return quantize_dense_tree(params, predicate=_is_trocr_quantized)


def quantize_trocr_decoder_state_dict(sd: Dict[str, torch.Tensor]) -> dict:
    """`quantize_trocr_decoder` on a TrOCRModel state dict: each selected
    `weight` [N, K] becomes `weight_i8` int8 + `scale` [N] f32, its bias
    kept as f32 (QuantDense's buffers). Runs on the tensors' device."""
    out = dict(sd)
    for name, t in sd.items():
        parts = name.split(".")
        if parts[-1] != "weight" or not _is_trocr_quantized(
                tuple(parts[:-1]) + ("kernel",)):
            continue
        prefix = name[: -len("weight")]
        del out[name]
        out[prefix + "weight_i8"], out[prefix + "scale"] = quantize_int8(
            t, axis=1)
        if prefix + "bias" in sd:
            out[prefix + "bias"] = sd[prefix + "bias"].float()
    return out


def stack_trocr_params(params: dict, num_layers: int) -> dict:
    """Looped TrOCR tree -> the stacked form (text_decoder/decoder/layers
    on axis 0); the encoder keeps its loop. Numpy leaves."""
    out = dict(params)
    td = dict(out["text_decoder"])
    td["decoder"] = stack_layer_params(dict(td["decoder"]), num_layers)
    out["text_decoder"] = td
    return out


def make_generate_fns(model: TrOCRModel, cache_size: int):
    """(prefill, step) closures for runtime.generate: `aux` is the encoder
    output, read by the prefill only (the step reads the cross cache)."""

    def prefill(tokens, aux):
        return model.prefill(tokens, aux, cache_size)

    def step(tokens, cache, aux):
        return model.decode_step(tokens, cache, cache_size)

    return prefill, step


def trocr_base(**kw) -> TrOCRConfig:
    """trocr_base: a DeiT-base encoder at 384, a RoBERTa-large-width
    post-LN decoder."""
    return TrOCRConfig(**kw)


def trocr_large(**kw) -> TrOCRConfig:
    kw.setdefault("enc_dim", 1024)
    kw.setdefault("enc_layers", 24)
    kw.setdefault("enc_heads", 16)
    kw.setdefault("enc_ffn", 4096)
    kw.setdefault("distilled", False)
    return TrOCRConfig(**kw)


def trocr_small(**kw) -> TrOCRConfig:
    kw.setdefault("enc_dim", 384)
    kw.setdefault("enc_heads", 6)
    kw.setdefault("dec_dim", 256)
    kw.setdefault("dec_layers", 6)
    kw.setdefault("dec_heads", 8)
    kw.setdefault("dec_ffn", 1024)
    kw.setdefault("vocab_size", 64044)
    return TrOCRConfig(**kw)
