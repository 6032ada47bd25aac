"""The decoder stack's generation path (port of unilm_tpu/core/transformer.py
`_scan_pool_geometry` :330, `_ScanSelfAttention` :346, `_ScanDecoderLayerKV`
:599, the scanned prefill/decode branch of `Decoder` :850-912 and
`stack_layer_params` :659).

The JAX stack is one `nn.scan` over axis-0-stacked layer params with the KV
page pool threaded through the scan carry. Here the scan is a Python loop
over `nn.ModuleList` layers; every layer reads and writes ONE shared pool
pair at its page offset (`li * pages_per_layer`). The pools are torch
tensors updated IN PLACE: prefill allocates them, every decode step
scatters its rows into them and the returned cache holds the same tensors.

Pool layout [B, L*PP, page, H*D] (batch-leading, H*D flat), as in JAX, so
the cache leaves compare tensor for tensor: `kv_pool_key`,
`kv_pool_value`, `cache_index`.

Only the prefill/decode modes of the scanned stack are ported; the
train-mode forward, the looped stack, cross-attention, relative-position
buckets and the int8 KV pool raise NotImplementedError naming their
ROADMAP entry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unilm_tpu_torch.core import positional
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import FeedForward, make_dense, make_norm
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


class ScanSelfAttention(nn.Module):
    """Self-attention over the shared KV page pool; the same param names as
    the JAX module (q/k/v/out_proj + inner_attn_ln)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, D, E = cfg.num_heads, cfg.head_dim, cfg.embed_dim
        vo_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
        self.q_proj = make_dense(cfg, E, H * D, init_scale=2 ** -0.5,
                                 device=device)
        self.k_proj = make_dense(cfg, E, H * D, init_scale=2 ** -0.5,
                                 device=device)
        self.v_proj = make_dense(cfg, E, H * D,
                                 init_scale=2 ** -0.5 * vo_scale, device=device)
        if cfg.subln:
            self.inner_attn_ln = make_norm(cfg, H * D, device=device)
        self.out_proj = make_dense(cfg, H * D, E, init_scale=vo_scale,
                                   device=device)

    def forward(self, x, k_pool, v_pool, li: int, start: int, *, mode: str,
                causal: bool, page: int, chunk: int, pages_per_layer: int,
                xpos=None, key_padding_mask=None, attn_bias=None):
        """`xpos` = (q tables, k tables, qscale) from `xpos_inputs`, shared
        by every layer of one forward."""
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.head_dim
        B, T = x.shape[0], x.shape[1]
        PP = pages_per_layer

        q = self.q_proj(x).view(B, T, H, D)
        k_new = self.k_proj(x).view(B, T, H, D)
        v_new = self.v_proj(x).view(B, T, H, D)

        if xpos is not None:
            (sq, cq), (sk, ck), qscale = xpos
            q = positional.apply_rotary(q, sq, cq)
            k_new = positional.apply_rotary(k_new, sk, ck)
            q = (q * qscale).to(q.dtype)

        scale = cfg.attn_scale if cfg.attn_scale is not None else D ** -0.5

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

        out = out.reshape(B, T, H * D)
        if cfg.subln:
            out = self.inner_attn_ln(out)
        return self.out_proj(out)

    @staticmethod
    def _scatter_rows(k_pool, v_pool, k_new, v_new, li, start, page, PP):
        B, T = k_new.shape[0], k_new.shape[1]
        pos = start + torch.arange(T, device=k_pool.device)
        pids = li * PP + torch.div(pos, page, rounding_mode="floor")
        offs = torch.remainder(pos, page)
        k_pool[:, pids, offs] = k_new.reshape(B, T, -1).to(k_pool.dtype)
        v_pool[:, pids, offs] = v_new.reshape(B, T, -1).to(v_pool.dtype)


def xpos_inputs(cfg: TransformerConfig, start: int, T: int, device):
    """xPos rotary tables for positions start..start+T-1, laid out to
    broadcast against [B, T, H, D]: ((sin, cos) for q with the decay scale,
    (sin, cos) for k with its inverse, length-extrapolation qscale)."""
    pos = start + torch.arange(T, device=device)
    sin, cos, xsc = positional.xpos_sin_cos_scale(
        pos, 0.0, cfg.head_dim, cfg.xpos_scale_base)
    q_tab = [t[:, None] for t in positional.rotary_tables(sin, cos, xsc)]
    k_tab = [t[:, None] for t in positional.rotary_tables(sin, cos, 1.0 / xsc)]
    qscale = positional.length_extrapolation_qscale(
        pos, start + T, cfg.scale_length)
    return q_tab, k_tab, qscale[:, None, None]


class ScanDecoderLayer(nn.Module):
    """One decoder layer of the generation path (self-attention + FFN), the
    param subtree of the JAX `_ScanDecoderLayerKV`."""

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

    def forward(self, x, k_pool, v_pool, li, start, **attn_kw):
        pre = self.cfg.normalize_before
        residual = x
        if pre:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, k_pool, v_pool, li, start, **attn_kw)
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
    """Causal decoder stack over pre-embedded inputs, generation modes.

    `forward(x, mode="prefill" | "decode", cache_size, cache)` returns
    (x, cache). Prefill allocates the pools; decode reads `cache` and writes
    the step's rows into its pools in place. `cache` is a dict with the JAX
    leaf names: kv_pool_key, kv_pool_value [B, L*PP, page, H*D] and
    cache_index (an int: tokens already in the pool)."""

    def __init__(self, cfg: TransformerConfig, has_cross_attention=False,
                 device=None):
        super().__init__()
        if has_cross_attention:
            raise NotImplementedError(
                "decoder cross-attention (TrOCR) is not ported yet: ROADMAP "
                "Queue 1 slice 8")
        if not cfg.scan_layers:
            raise NotImplementedError(
                "the looped decoder stack is not ported yet (use "
                "scan_layers=True): ROADMAP Queue 1, remainder of slices 0-2")
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
            [ScanDecoderLayer(cfg, alpha, device=device)
             for _ in range(cfg.num_layers)])
        if cfg.normalize_before:
            self.layer_norm = make_norm(cfg, device=device)

    def forward(self, x: torch.Tensor, *, mode: str, cache_size: int,
                cache: Optional[Dict] = None, causal: bool = True,
                self_key_padding_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None):
        cfg = self.cfg
        if mode not in ("prefill", "decode"):
            raise NotImplementedError(
                f"mode {mode!r}: only prefill/decode are ported; the "
                "train-mode forward is ROADMAP Queue 1, remainder of "
                "slices 0-2")
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
