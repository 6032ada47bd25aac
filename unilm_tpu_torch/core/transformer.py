"""The decoder stack (port of unilm_tpu/core/transformer.py
`_decoder_layer_body` :156, `DecoderLayer` :247, `_ScanDecoderLayer` :281,
`_scan_pool_geometry` :330, `_ScanSelfAttention` :346,
`_ScanDecoderLayerKV` :599, `Decoder` :767-948 and `stack_layer_params`
:659).

One layer class serves every mode: `mode="train"` is the full-sequence
forward of the looped and the scanned JAX stacks (the same math), with
autograd through the flash kernels on a CUDA tensor and optional per-layer
activation checkpointing (`cfg.remat`, remat_policy "full");
`mode="prefill" | "decode"` is the scanned generation path. A looped
(`layers_i`) or a stacked (`layers`) flax tree loads into the one
`nn.ModuleList` (convert/from_jax.py).

The JAX generation stack is one `nn.scan` over axis-0-stacked layer params
with the KV page pool threaded through the scan carry. Here the scan is a
Python loop over the layers; every layer reads and writes ONE shared pool
pair at its page offset (`li * pages_per_layer`). The pools are torch
tensors updated IN PLACE: prefill allocates them, every decode step
scatters its rows into them and the returned cache holds the same tensors.

Pool layout [B, L*PP, page, H*D] (batch-leading, H*D flat), as in JAX, so
the cache leaves compare tensor for tensor: `kv_pool_key`,
`kv_pool_value`, `cache_index`.

Cross-attention, relative-position buckets, MoE, drop-path, dropout, the
"dots" remat policy and the int8 KV pool raise NotImplementedError naming
their ROADMAP entry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from unilm_tpu_torch.core.attention import (
    MultiheadAttention, apply_xpos, xpos_inputs)
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import FeedForward, make_norm
from unilm_tpu_torch.ops.attention import attention
from unilm_tpu_torch.ops.paged_attention import run_decode_append_attention


def _scan_pool_geometry(cache_size: int) -> Tuple[int, int, int]:
    """(page, chunk, pages_per_layer); PP is chunk-aligned so every layer's
    run starts on a slab boundary. Long caches use 64x8 (512-token) slabs,
    short ones 16x2."""
    if cache_size >= 1024:
        page, chunk = 64, 8
    else:
        page, chunk = 16, 2
    pp = -(-cache_size // page)
    pp = -(-pp // chunk) * chunk
    return page, chunk, pp


class ScanSelfAttention(MultiheadAttention):
    """MultiheadAttention plus the generation modes over the shared KV page
    pool (the JAX `_ScanSelfAttention`); `mode="train"` is the parent's
    full-sequence forward."""

    def forward(self, x, k_pool=None, v_pool=None, li: int = 0,
                start: int = 0, *, mode: str, causal: bool, page: int = 0,
                chunk: int = 0, pages_per_layer: int = 0, xpos=None,
                key_padding_mask=None, attn_bias=None):
        """`xpos` = (q tables, k tables, qscale) from `xpos_inputs`, shared
        by every layer of one forward."""
        if mode == "train":
            return self.forward_train(x, causal=causal,
                                      key_padding_mask=key_padding_mask,
                                      attn_bias=attn_bias, xpos=xpos)
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.head_dim
        B, T = x.shape[0], x.shape[1]
        PP = pages_per_layer

        q, k_new, v_new = self.project(x)
        if xpos is not None:
            q, k_new = apply_xpos(q, k_new, xpos)
        scale = self.scale

        if mode == "prefill":
            # the pool is empty (start == 0): attend over the fresh K/V, then
            # scatter the rows into the pool
            if attn_bias is not None:
                attn_bias = attn_bias[..., :T]
            out = attention(q, k_new, v_new, bias=attn_bias,
                            key_padding_mask=key_padding_mask, scale=scale,
                            causal=causal, use_flash=cfg.use_flash)
            self._scatter_rows(k_pool, v_pool, k_new, v_new, li, start, page,
                               PP)
        elif (T == 1 and attn_bias is None and key_padding_mask is None
              and x.is_cuda and cfg.use_flash):
            # one-token step: the decode kernel appends the row and reads
            # only the slabs that hold this layer's tokens
            LPP = k_pool.shape[1]
            kp3 = k_pool.view(B * LPP, page, H * D)
            vp3 = v_pool.view(B * LPP, page, H * D)
            bases = (torch.arange(B, dtype=torch.int32, device=x.device) * LPP
                     + li * PP)
            lengths = torch.full((B,), start, dtype=torch.int32,
                                 device=x.device)
            out, _, _ = run_decode_append_attention(
                q, k_new, v_new, kp3, vp3, bases, lengths, max_pages=PP,
                scale=scale, chunk=chunk)
        else:
            # generic path (CPU, use_flash=False, decode bias/mask, T > 1):
            # scatter the rows, gather this layer's run, masked attention
            self._scatter_rows(k_pool, v_pool, k_new, v_new, li, start, page,
                               PP)
            kk = k_pool[:, li * PP:(li + 1) * PP].reshape(B, PP * page, H, D)
            vv = v_pool[:, li * PP:(li + 1) * PP].reshape(B, PP * page, H, D)
            if attn_bias is not None:
                padn = PP * page - attn_bias.shape[-1]
                if padn > 0:
                    attn_bias = torch.nn.functional.pad(attn_bias, (0, padn))
                else:
                    attn_bias = attn_bias[..., :PP * page]
            if (key_padding_mask is not None
                    and key_padding_mask.shape[-1] != PP * page):
                key_padding_mask = torch.nn.functional.pad(
                    key_padding_mask,
                    (0, PP * page - key_padding_mask.shape[-1]), value=False)
            out = attention(q, kk, vv, bias=attn_bias,
                            key_padding_mask=key_padding_mask, scale=scale,
                            causal=causal, q_offset=start, kv_len=start + T,
                            use_flash=cfg.use_flash)

        return self.output(out)

    @staticmethod
    def _scatter_rows(k_pool, v_pool, k_new, v_new, li, start, page, PP):
        B, T = k_new.shape[0], k_new.shape[1]
        pos = start + torch.arange(T, device=k_pool.device)
        pids = li * PP + torch.div(pos, page, rounding_mode="floor")
        offs = torch.remainder(pos, page)
        k_pool[:, pids, offs] = k_new.reshape(B, T, -1).to(k_pool.dtype)
        v_pool[:, pids, offs] = v_new.reshape(B, T, -1).to(v_pool.dtype)


class DecoderLayer(nn.Module):
    """One decoder layer (self-attention + FFN), the param subtree of the
    JAX `DecoderLayer` / `_ScanDecoderLayer` / `_ScanDecoderLayerKV`; the
    attention keywords pick the mode."""

    def __init__(self, cfg: TransformerConfig, alpha: float = 1.0,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.alpha = alpha
        self.self_attn_layer_norm = make_norm(cfg, device=device)
        self.self_attn = ScanSelfAttention(cfg, device=device)
        self.final_layer_norm = make_norm(cfg, device=device)
        ffn_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
        self.ffn = FeedForward(cfg, init_scale=ffn_scale, device=device)

    def _residual(self, residual, x):
        return residual * self.alpha + x if self.alpha != 1.0 else residual + x

    def forward(self, x, *pool, **attn_kw):
        pre = self.cfg.normalize_before
        residual = x
        if pre:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, *pool, **attn_kw)
        x = self._residual(residual, x)
        if not pre:
            x = self.self_attn_layer_norm(x)
        residual = x
        if pre:
            x = self.final_layer_norm(x)
        x = self.ffn(x)
        x = self._residual(residual, x)
        if not pre:
            x = self.final_layer_norm(x)
        return x


class Decoder(nn.Module):
    """Causal decoder stack over pre-embedded inputs.

    `forward(x, mode="train")` returns x: the full-sequence forward that
    autograd differentiates. `forward(x, mode="prefill" | "decode",
    cache_size, cache)` returns (x, cache): prefill allocates the pools;
    decode reads `cache` and writes the step's rows into its pools in
    place. `cache` is a dict with the JAX leaf names: kv_pool_key,
    kv_pool_value [B, L*PP, page, H*D] and cache_index (an int: tokens
    already in the pool)."""

    def __init__(self, cfg: TransformerConfig, has_cross_attention=False,
                 device=None):
        super().__init__()
        if has_cross_attention:
            raise NotImplementedError(
                "decoder cross-attention (TrOCR) is not ported yet: ROADMAP "
                "Queue 1 slice 8")
        if cfg.moe_freq or cfg.drop_path_rate or cfg.rel_pos_buckets:
            raise NotImplementedError(
                "MoE / drop-path / T5 relative-bias decoders are not ported "
                "yet: ROADMAP Queue 1 slices 9-10")
        if cfg.kv_cache_dtype != "model":
            raise NotImplementedError(
                "int8 KV pool (quantize_kv_rows + scale sidecar) is not "
                "ported yet: ROADMAP Queue 1, remainder of slices 0-2")
        self.cfg = cfg
        alpha = cfg.deepnorm_alpha if cfg.deepnorm else 1.0
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, alpha, device=device)
             for _ in range(cfg.num_layers)])
        if cfg.normalize_before:
            self.layer_norm = make_norm(cfg, device=device)

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache_size: int = 0, cache: Optional[Dict] = None,
                causal: bool = True,
                self_key_padding_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None):
        if mode == "train":
            return self._forward_train(x, causal, self_key_padding_mask,
                                       attn_bias)
        if mode not in ("prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        if cache_size <= 0:
            raise ValueError("prefill/decode need cache_size")
        L, B, T = cfg.num_layers, x.shape[0], x.shape[1]
        H, D = cfg.num_heads, cfg.head_dim
        page, chunk, pp = _scan_pool_geometry(cache_size)
        x = x.to(cfg.dtype)
        if mode == "prefill":
            shape = (B, L * pp, page, H * D)
            kp = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
            vp = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
            start = 0
        else:
            kp, vp = cache["kv_pool_key"], cache["kv_pool_value"]
            start = int(cache["cache_index"])
        xpos = (xpos_inputs(cfg, start, T, x.device) if cfg.xpos_rel_pos
                else None)
        for li, layer in enumerate(self.layers):
            x = layer(x, kp, vp, li, start, mode=mode, causal=causal,
                      page=page, chunk=chunk, pages_per_layer=pp, xpos=xpos,
                      key_padding_mask=self_key_padding_mask,
                      attn_bias=attn_bias)
        if cfg.normalize_before:
            x = self.layer_norm(x)
        return x, {"kv_pool_key": kp, "kv_pool_value": vp,
                   "cache_index": start + T}

    def _forward_train(self, x, causal, key_padding_mask, attn_bias):
        """The looped stack's train mode (:914-949); the scanned stack
        (:826-848) computes the same. With cfg.remat each layer is
        recomputed in the backward (torch.utils.checkpoint, the "full"
        policy: nothing but the layer input is kept)."""
        cfg = self.cfg
        if cfg.dropout or cfg.attention_dropout or cfg.activation_dropout:
            raise NotImplementedError(
                "dropout in the train-mode forward is not ported yet: "
                "ROADMAP Queue 1, remainder of slices 3-4 (dropout)")
        if cfg.remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} (a jax.checkpoint "
                "policy that saves the matmul outputs) is not ported yet: "
                "ROADMAP Queue 1, remainder of slices 3-4 (dots remat)")
        x = x.to(cfg.dtype)
        xpos = (xpos_inputs(cfg, 0, x.shape[1], x.device)
                if cfg.xpos_rel_pos else None)
        kw = dict(mode="train", causal=causal, xpos=xpos,
                  key_padding_mask=key_padding_mask, attn_bias=attn_bias)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False, **kw)
            else:
                x = layer(x, **kw)
        if cfg.normalize_before:
            x = self.layer_norm(x)
        return x


def stack_layer_params(params: dict, num_layers: int, prefix: str = "layers_",
                       out_key: str = "layers") -> dict:
    """{layers_0: t0, ...} -> {layers: leaves stacked on axis 0}, for nested
    dicts of numpy arrays (a flax tree after `jax.device_get`). Non-layer
    keys pass through."""
    rest = {k: v for k, v in params.items() if not k.startswith(prefix)}
    trees = [params[f"{prefix}{i}"] for i in range(num_layers)]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs, 0)

    rest[out_key] = stack(*trees)
    return rest
