"""The encoder and decoder stacks (port of unilm_tpu/core/transformer.py
`EncoderLayer` :60-153, `_decoder_layer_body` :156, `DecoderLayer` :247,
`_ScanDecoderLayer` :281, `_scan_pool_geometry` :330, `_ScanSelfAttention`
:346, `_ScanCrossAttention` :529, `_ScanDecoderLayerKV` :599, `Encoder`
:681-764, `Decoder` :767-948 and `stack_layer_params` :659).

`Encoder` is the bidirectional stack over pre-embedded inputs (BEiT, the
Pix2Struct tower): pre- or post-LN, LayerScale, the deepnorm `alpha`, one
shared bias or a per-layer list of biases, a key-padding
mask, the optional final LayerNorm and `return_all_hiddens`. It keeps the
input's dtype for the residual stream, as flax's promotion does (a float32
input stays float32 around bf16 layers). Drop-path trains on keep flags
drawn before the forward (`Encoder.draw_drop_path`); `cfg.remat` recomputes
each layer in the backward (`remat_policy` "full" or "dots", `remat`).
Under `cfg.multiway` (BEiT-3, VLMo; JAX
:86-95, :123-140, :753-759) the layer norms, the attention's projections
and the FFN (`ffn_A` / `ffn_B`) are A/B expert pairs and `forward` takes
`multiway_split_mask` (core/multiway.py's `split`: None, a position or a
bool mask); with None only the A experts compute and the B parameters
carry no work, as in JAX. With cfg.rel_pos_buckets the stack owns T5's
bucketed bias (core/positional.py `RelativePositionBias`, JAX :705-714):
`relative_position`, bidirectional, used where the caller passes no bias
(BEATs).

MoE (JAX `_build_ffn` :51-56): in both stacks every `cfg.moe_freq`-th
layer's FFN is a `core/moe.py` `MoELayer` named `moe` (a multiway layer
that is an MoE layer keeps one MoE, not an `ffn_A` / `ffn_B` pair, JAX
:123). A training forward with a generator routes non-deterministically
(train capacity, the random second-expert policy) from the layer's
generator; without one, and in prefill and decode, routing is
deterministic (eval capacity), as the flax layer's `deterministic` flag.
Each MoE layer keeps its GShard loss and overflow fraction for
runtime/train.py `apply_with_moe_aux` (JAX sows them).

One layer class serves every mode: `mode="train"` is the full-sequence
forward of the looped and the scanned JAX stacks (the same math), with
autograd through the flash kernels on a CUDA tensor, optional per-layer
activation checkpointing (`cfg.remat`, `remat`) and, in training, dropout;
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
`kv_pool_value`, `cache_index`. Under `cfg.kv_cache_dtype == "int8"` the
pools hold int8 rows quantized per token (`quantize_kv_rows`) and
`kv_pool_scale` [B, L*PP/chunk, 8, chunk*page] f32 holds each slab's K
scales in row 0 and V scales in row 1 (JAX :855-906, :500-526). Prefill
attends over the fresh, unquantized K/V; the one-token decode on a CUDA
tensor launches the int8 run kernel (#13's int8 launcher) for every pool
geometry, the short one included (JAX sends chunk*page < 128 to XLA for a
TPU tile reason); the generic path dequantizes the layer's slabs in
cfg.dtype.

`Decoder(has_cross_attention=True)` (TrOCR) gives each layer an
`encoder_attn` block and its `encoder_attn_layer_norm`, in JAX's order
for pre- and post-LN (`_decoder_layer_body` :208-229). In train mode it is
`MultiheadAttention.forward_train` over `encoder_out`; in generation
`ScanCrossAttention` (JAX `_ScanCrossAttention` :529-596): prefill
projects `encoder_out` once per layer into the cache leaves `cross_key` /
`cross_value` [B, L, S, H, D] in the model dtype (:875-891), decode reads
layer li's slice. The leaves are views of [L, B, S, H, D] storage, so a
layer's slice is one contiguous [B, S, H, D] block that the attention
kernel reads in place. Beam search neither tiles nor reorders them
(runtime/generate.py `_is_shared_cross_leaf`): with a query batch B that
is G times the leaves' Bkv, the G beams of a sequence fold into the query
length, [Bkv, G*T, H, D] over the shared keys (:570-585), which is exact
for non-causal attention.

Dropout (JAX :110, :201, :223; core/layers.py FeedForward :172, :176;
ops/attention.py :65-67) runs in a training forward (`module.training`)
of either stack with a rate in the config: the residual dropout after
each attention block, the FFN's activation and output dropouts, and the
attention probabilities' (which takes the plain attention path, as JAX's
XLA path). The stack's `generator` gives one seed per layer
(core/layers.py `layer_seeds`) and each layer draws its masks, in JAX's
order, from a generator seeded with it, so a recompute under `remat`
draws them again; a training forward with a rate and no generator raises.

Drop-path runs in both stacks (the decoder's on its two or three
branches, JAX :160-179, :914-920), on keep flags drawn before the forward
(`draw_drop_path`). xPos with cross-attention (JAX asserts, :542-544)
raises NotImplementedError.

With cfg.rel_pos_buckets the decoder owns a unidirectional T5 bias
`self_attn_relative_position` (JAX :794-811): train mode adds its [1, H,
T, T] rows to `attn_bias`; prefill and decode take the rows of the
queries step..step+T-1 against `cache_size` keys, `step` being the cache
leaf that counts the tokens already seen (0 at prefill). A decode step
with a bias takes the generic path, as JAX's does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from unilm_tpu_torch.core.attention import (
    MultiheadAttention, apply_xpos, xpos_inputs)
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import (DropPath, FeedForward, LayerScale,
                                         dropout, layer_seeds, make_norm,
                                         seeded_generator)
from unilm_tpu_torch.core.moe import MoELayer, is_moe_layer
from unilm_tpu_torch.core.multiway import MultiwayNorm, apply_split
from unilm_tpu_torch.core.positional import RelativePositionBias
from unilm_tpu_torch.ops.attention import attention
from unilm_tpu_torch.ops.paged_attention import (quantize_kv_rows,
                                                 run_decode_append_attention)


# the products "dots" keeps: matmuls without batch dims (every projection;
# a 3-D nn.Linear input reaches aten as a 2-D mm / addmm), not the batched
# bmm / baddbmm of the plain attention's scores
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) under torch.utils.checkpoint with the JAX
    policy's counterpart (`_remat_policy` :30-39): "full" keeps nothing
    but the inputs; "dots" (`dots_with_no_batch_dims_saveable`) keeps the
    outputs of aten.mm / addmm and recomputes the rest, the hand-written
    kernels too (ctypes launches are no aten op, as a `pallas_call` is no
    dot for JAX's policy). A recompute replays the forward's ops in order,
    as selective checkpointing requires."""
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots), **kwargs)
    raise ValueError(f"unknown remat_policy {policy!r}")


def _dropout_seeds(module: nn.Module, cfg, generator, n: int) -> list:
    """One seed per layer for a training forward of a stack with a
    dropout rate in `cfg`, or with MoE layers and a generator (their
    non-deterministic routing), drawn from `generator`; else n Nones."""
    rates = cfg.dropout or cfg.attention_dropout or cfg.activation_dropout
    moe = cfg.moe_freq > 0 and generator is not None
    if not (module.training and (rates or moe)):
        return [None] * n
    if generator is None:
        raise ValueError(
            "a training forward with dropout needs a torch.Generator "
            "(`generator=`); call .eval() to evaluate")
    return layer_seeds(generator, n)


def _rel_bias(cfg: TransformerConfig, bidirectional: bool,
              device) -> RelativePositionBias:
    return RelativePositionBias(cfg.rel_pos_buckets, cfg.max_rel_pos,
                                cfg.num_heads, bidirectional, cfg.dtype,
                                device=device)


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

    def forward(self, x, k_pool=None, v_pool=None, scale_pool=None,
                li: int = 0, start: int = 0, *, mode: str, causal: bool,
                page: int = 0, chunk: int = 0, pages_per_layer: int = 0,
                xpos=None, key_padding_mask=None, attn_bias=None, rng=None):
        """`xpos` = (q tables, k tables, qscale) from `xpos_inputs`, shared
        by every layer of one forward. `scale_pool`: the int8 pools'
        sidecar, None for pools in the model dtype. `rng`: the layer's
        dropout generator (train mode)."""
        if mode == "train":
            return self.forward_train(x, None, causal=causal,
                                      key_padding_mask=key_padding_mask,
                                      attn_bias=attn_bias, xpos=xpos, rng=rng)
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
            self._scatter_rows(k_pool, v_pool, scale_pool, k_new, v_new, li,
                               start, page, chunk, PP)
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
            sp3 = (None if scale_pool is None else
                   scale_pool.view(B * LPP // chunk, 8, chunk * page))
            out = run_decode_append_attention(
                q, k_new, v_new, kp3, vp3, bases, lengths, max_pages=PP,
                scale=scale, chunk=chunk, scale_pool=sp3)[0]
        else:
            # generic path (CPU, use_flash=False, decode bias/mask, T > 1):
            # scatter the rows, gather this layer's run, masked attention
            self._scatter_rows(k_pool, v_pool, scale_pool, k_new, v_new, li,
                               start, page, chunk, PP)
            kk = k_pool[:, li * PP:(li + 1) * PP].reshape(B, PP * page, H, D)
            vv = v_pool[:, li * PP:(li + 1) * PP].reshape(B, PP * page, H, D)
            if scale_pool is not None:
                # this layer's per-token scales: rows 0/1 of its slabs
                sl = scale_pool[:, li * PP // chunk:(li + 1) * PP // chunk]
                dt = cfg.dtype
                kk = kk.to(dt) * sl[:, :, 0].reshape(B, PP * page, 1, 1).to(dt)
                vv = vv.to(dt) * sl[:, :, 1].reshape(B, PP * page, 1, 1).to(dt)
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
    def _scatter_rows(k_pool, v_pool, scale_pool, k_new, v_new, li, start,
                      page, chunk, PP):
        B, T = k_new.shape[0], k_new.shape[1]
        pos = start + torch.arange(T, device=k_pool.device)
        pids = li * PP + torch.div(pos, page, rounding_mode="floor")
        offs = torch.remainder(pos, page)
        if scale_pool is None:
            k_pool[:, pids, offs] = k_new.reshape(B, T, -1).to(k_pool.dtype)
            v_pool[:, pids, offs] = v_new.reshape(B, T, -1).to(v_pool.dtype)
            return
        ki, vi, ks, vs = quantize_kv_rows(k_new.reshape(B * T, -1),
                                          v_new.reshape(B * T, -1))
        k_pool[:, pids, offs] = ki.reshape(B, T, -1)
        v_pool[:, pids, offs] = vi.reshape(B, T, -1)
        slab = torch.div(pids, chunk, rounding_mode="floor")
        pos_in = torch.remainder(pids, chunk) * page + offs
        scale_pool[:, slab, 0, pos_in] = ks.reshape(B, T)
        scale_pool[:, slab, 1, pos_in] = vs.reshape(B, T)


class ScanCrossAttention(MultiheadAttention):
    """Cross-attention over an encoder's output with the JAX module's
    parameters. `mode="train"` is the parent's `forward_train`; prefill
    and decode are the JAX `_ScanCrossAttention`'s (see the module
    docstring)."""

    def __init__(self, cfg: TransformerConfig, kv_dim: Optional[int] = None,
                 device=None):
        if cfg.xpos_rel_pos:
            raise NotImplementedError(
                "xPos with cross-attention is not ported (the JAX scanned "
                "stack asserts against it; no model of the repo combines "
                "them): ROADMAP Queue 1 slice 8")
        super().__init__(cfg, self_attention=False, kv_dim=kv_dim,
                         device=device)

    def forward(self, x, encoder_out=None, cross=None, li: int = 0, *,
                mode: str, key_padding_mask=None, rng=None):
        """`cross` = (cross_key, cross_value) [Bkv, L, S, H, D]: prefill
        writes layer li's slice from `encoder_out` [Bkv, S, E_enc], decode
        only reads it. `key_padding_mask` [Bkv, S] bool, True = valid.
        `rng`: the layer's dropout generator (train mode)."""
        if mode == "train":
            return self.forward_train(x, encoder_out,
                                      key_padding_mask=key_padding_mask,
                                      rng=rng)
        H, D = self.cfg.num_heads, self.cfg.head_dim
        B, T = x.shape[0], x.shape[1]
        q = self.q_proj(x).view(B, T, H, D)
        ck, cv = cross
        if mode == "prefill":
            Bkv, S = encoder_out.shape[0], encoder_out.shape[1]
            ck[:, li] = self.k_proj(encoder_out).view(Bkv, S, H, D)
            cv[:, li] = self.v_proj(encoder_out).view(Bkv, S, H, D)
        k, v = ck[:, li], cv[:, li]
        Bkv = k.shape[0]
        if B % Bkv:
            raise ValueError(f"query batch {B} is not a multiple of the "
                             f"cross cache's batch {Bkv}")
        if key_padding_mask is not None and key_padding_mask.shape[0] != Bkv:
            # a mask tiled to beams (runtime/generate.py tiles `aux`): the
            # rows of a sentence's beams are equal, keep its first
            key_padding_mask = key_padding_mask[::B // Bkv]
        # beams of a sequence attend over the same keys: fold them into the
        # query length (a view of the [B, T, H, D] projection)
        out = attention(q.reshape(Bkv, B // Bkv * T, H, D), k, v,
                        key_padding_mask=key_padding_mask, scale=self.scale,
                        causal=False, use_flash=self.cfg.use_flash)
        return self.output(out.reshape(B, T, H, D))


class DecoderLayer(nn.Module):
    """One decoder layer (self-attention, with `has_cross_attention` the
    cross-attention over an encoder of width `encoder_dim`, then the FFN,
    or the MoE FFN `moe` in an MoE layer), the param subtree of the JAX
    `DecoderLayer` / `_ScanDecoderLayer` / `_ScanDecoderLayerKV`; the
    attention keywords pick the mode, `cross_kw` goes to
    `ScanCrossAttention`. `seed` (train mode): the layer's dropout seed,
    from which it draws its masks in JAX's order (self-attention
    probabilities, its residual branch, cross-attention probabilities, its
    branch, the FFN's activation and output) and the MoE routing's
    uniform. `drop_path_keep` [branches, B]: the keep flags of the layer's
    drop-path on each branch (self-attention, cross-attention, FFN), as
    `Decoder.draw_drop_path` draws them."""

    def __init__(self, cfg: TransformerConfig, alpha: float = 1.0,
                 has_cross_attention: bool = False,
                 encoder_dim: Optional[int] = None, device=None,
                 layer_idx: int = 0, drop_path: float = 0.0):
        super().__init__()
        self.cfg = cfg
        self.alpha = alpha
        self.drop_path = DropPath(drop_path)
        self.self_attn_layer_norm = make_norm(cfg, device=device)
        self.self_attn = ScanSelfAttention(cfg, device=device)
        if has_cross_attention:
            self.encoder_attn_layer_norm = make_norm(cfg, device=device)
            self.encoder_attn = ScanCrossAttention(cfg, encoder_dim,
                                                   device=device)
        self.final_layer_norm = make_norm(cfg, device=device)
        if is_moe_layer(cfg, layer_idx):
            self.moe = MoELayer(cfg, device=device)
        else:
            ffn_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
            self.ffn = FeedForward(cfg, init_scale=ffn_scale, device=device)

    def _residual(self, residual, x):
        return residual * self.alpha + x if self.alpha != 1.0 else residual + x

    def forward(self, x, *pool, cross_kw: Optional[Dict] = None,
                seed: Optional[int] = None,
                drop_path_keep: Optional[torch.Tensor] = None, **attn_kw):
        pre, rate = self.cfg.normalize_before, self.cfg.dropout
        rng = seeded_generator(seed, x.device)
        keep = (iter([None] * 3) if drop_path_keep is None
                else iter(drop_path_keep))
        residual = x
        if pre:
            x = self.self_attn_layer_norm(x)
        x = dropout(self.self_attn(x, *pool, rng=rng, **attn_kw), rate, rng)
        x = self._residual(residual, self.drop_path(x, next(keep)))
        if not pre:
            x = self.self_attn_layer_norm(x)
        if cross_kw is not None:
            residual = x
            if pre:
                x = self.encoder_attn_layer_norm(x)
            x = self.encoder_attn(x, mode=attn_kw["mode"], rng=rng,
                                  **cross_kw)
            x = self._residual(residual,
                               self.drop_path(dropout(x, rate, rng),
                                              next(keep)))
            if not pre:
                x = self.encoder_attn_layer_norm(x)
        residual = x
        if pre:
            x = self.final_layer_norm(x)
        x = self.moe(x, rng) if hasattr(self, "moe") else self.ffn(x, rng)
        x = self._residual(residual, self.drop_path(x, next(keep)))
        if not pre:
            x = self.final_layer_norm(x)
        return x


class EncoderLayer(nn.Module):
    """One encoder layer (the JAX `EncoderLayer`): self-attention + FFN,
    each with an optional LayerScale (`gamma_1`, `gamma_2`) and drop-path
    on the branch before the residual `residual * alpha + x`. The one
    DropPath runs on both branches, each call with its own keep flags
    (`drop_path_keep` [2, B]), as the JAX layer's one module draws a fresh
    key per call. Under cfg.multiway the two norms are `MultiwayNorm`s and
    the FFN is the pair `ffn_A` / `ffn_B`. `seed`: the layer's dropout
    seed in a training forward; its masks come in JAX's order (the
    attention probabilities, the attention branch, the FFN's activation
    and output; ffn_A's before ffn_B's). An MoE layer (`layer_idx`) has
    the MoE FFN `moe`, under cfg.multiway too."""

    def __init__(self, cfg: TransformerConfig, drop_path: float = 0.0,
                 layer_scale_init: float = 0.0, alpha: float = 1.0,
                 device=None, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.alpha = alpha
        norm = ((lambda: MultiwayNorm(cfg, device=device)) if cfg.multiway
                else (lambda: make_norm(cfg, device=device)))
        self.self_attn_layer_norm = norm()
        self.self_attn = MultiheadAttention(cfg, device=device)
        self.final_layer_norm = norm()
        ffn_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
        if is_moe_layer(cfg, layer_idx):
            self.moe = MoELayer(cfg, device=device)
        elif cfg.multiway:
            self.ffn_A = FeedForward(cfg, init_scale=ffn_scale, device=device)
            self.ffn_B = FeedForward(cfg, init_scale=ffn_scale, device=device)
        else:
            self.ffn = FeedForward(cfg, init_scale=ffn_scale, device=device)
        if layer_scale_init > 0:
            self.gamma_1 = LayerScale(cfg.embed_dim, layer_scale_init,
                                      device=device)
            self.gamma_2 = LayerScale(cfg.embed_dim, layer_scale_init,
                                      device=device)
        self.drop_path = DropPath(drop_path)

    def _branch(self, residual, x, gamma, keep):
        if gamma is not None:
            x = gamma(x)
        return residual * self.alpha + self.drop_path(x, keep)

    def forward(self, x, key_padding_mask=None, attn_bias=None,
                drop_path_keep=None, split=None, seed=None):
        """`split`: the multiway modality split (core/multiway.py), read
        only under cfg.multiway."""
        pre = self.cfg.normalize_before
        rng = seeded_generator(seed, x.device)
        keep = ((None, None) if drop_path_keep is None
                else (drop_path_keep[0], drop_path_keep[1]))
        if self.cfg.multiway:
            norm1 = lambda y: self.self_attn_layer_norm(y, split)
            norm2 = lambda y: self.final_layer_norm(y, split)
        else:
            norm1, norm2 = self.self_attn_layer_norm, self.final_layer_norm
        if hasattr(self, "moe"):
            ffn = lambda y: self.moe(y, rng)
        elif self.cfg.multiway:
            ffn = lambda y: apply_split(lambda z: self.ffn_A(z, rng),
                                        lambda z: self.ffn_B(z, rng), y,
                                        split)
        else:
            ffn = lambda y: self.ffn(y, rng)
        residual = x
        if pre:
            x = norm1(x)
        x = self.self_attn.forward_train(x, key_padding_mask=key_padding_mask,
                                         attn_bias=attn_bias, split=split,
                                         rng=rng)
        x = dropout(x, self.cfg.dropout, rng)
        x = self._branch(residual, x, getattr(self, "gamma_1", None), keep[0])
        if not pre:
            x = norm1(x)
        residual = x
        if pre:
            x = norm2(x)
        x = self._branch(residual, ffn(x), getattr(self, "gamma_2", None),
                         keep[1])
        if not pre:
            x = norm2(x)
        return x


class Encoder(nn.Module):
    """Bidirectional stack over pre-embedded inputs [B, T, E] (the JAX
    `Encoder`). `layer_scale_init` (a call argument in flax, where it
    decides which params exist) is a constructor argument here. Layer i's
    drop-path rate is linspace(0, cfg.drop_path_rate, L)[i], so layer 0's
    is 0; with cfg.remat each layer is recomputed in the backward under
    cfg.remat_policy (`remat`: "full" keeps nothing but the layer input,
    "dots" the projections' outputs), as the JAX `nn.remat` around each
    layer."""

    def __init__(self, cfg: TransformerConfig, final_layer_norm: bool = True,
                 layer_scale_init: float = 0.0, device=None):
        super().__init__()
        self.cfg = cfg
        alpha = cfg.deepnorm_alpha if cfg.deepnorm else 1.0
        self.drop_path_rates = [float(r) for r in np.linspace(
            0, cfg.drop_path_rate, cfg.num_layers)]
        # the keep probabilities on the module's device, so that drawing
        # the flags copies nothing from the host
        self.register_buffer("keep_prob", 1.0 - torch.tensor(
            self.drop_path_rates, device=device), persistent=False)
        self.layers = nn.ModuleList(
            [EncoderLayer(cfg, rate, layer_scale_init, alpha, device=device,
                          layer_idx=i)
             for i, rate in enumerate(self.drop_path_rates)])
        if cfg.rel_pos_buckets:
            self.relative_position = _rel_bias(cfg, True, device)
        if cfg.normalize_before and final_layer_norm:
            # JAX's final multiway norm is a LayerNorm whatever norm_type
            self.layer_norm = (
                MultiwayNorm(cfg.replace(norm_type="layernorm"),
                             device=device) if cfg.multiway else
                               make_norm(cfg, device=device))

    def draw_drop_path(self, batch: int, generator: torch.Generator
                       ) -> Optional[torch.Tensor]:
        """Every drop-path keep flag of one training forward, [L, 2, B]
        bool (layer, branch, sample), keep ~ Bernoulli(1 - rate_i), drawn
        from `generator` (on the module's device); None outside training
        or when no layer drops."""
        if not self.training or not any(self.drop_path_rates):
            return None
        u = torch.rand(len(self.drop_path_rates), 2, batch,
                       generator=generator, device=generator.device)
        return u < self.keep_prob[:, None, None]

    def forward(self, x: torch.Tensor, *,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_bias=None, return_all_hiddens: bool = False,
                drop_path_keep: Optional[torch.Tensor] = None,
                multiway_split_mask=None,
                generator: Optional[torch.Generator] = None):
        """`attn_bias`: None, one [B|1, H|1, T, T] tensor for every layer,
        or a per-layer sequence. `drop_path_keep`: `draw_drop_path`'s
        flags, needed in training when a layer drops.
        `multiway_split_mask`: the modality split of a multiway stack (a
        position, or a bool [T] / [B, T] mask, True = B). `generator`: the
        dropout seeds of a training forward (needed when cfg has a rate).
        Returns x, or (x, per-layer outputs) with return_all_hiddens."""
        cfg = self.cfg
        use_remat = cfg.remat and torch.is_grad_enabled()
        seeds = _dropout_seeds(self, cfg, generator, len(self.layers))
        if attn_bias is None and cfg.rel_pos_buckets:
            attn_bias = self.relative_position(x.shape[1], x.shape[1])
        hiddens = []
        for i, layer in enumerate(self.layers):
            bias_i = (attn_bias[i] if isinstance(attn_bias, (list, tuple))
                      else attn_bias)
            keep_i = None if drop_path_keep is None else drop_path_keep[i]
            args = (x, key_padding_mask, bias_i, keep_i, multiway_split_mask,
                    seeds[i])
            x = (remat(cfg.remat_policy, layer, *args) if use_remat
                 else layer(*args))
            if return_all_hiddens:
                hiddens.append(x)
        if hasattr(self, "layer_norm"):
            x = (self.layer_norm(x, multiway_split_mask) if cfg.multiway
                 else self.layer_norm(x))
        if return_all_hiddens:
            return x, hiddens
        return x


class Decoder(nn.Module):
    """Causal decoder stack over pre-embedded inputs, with
    `has_cross_attention` over an encoder's output of width `encoder_dim`
    (default embed_dim).

    `forward(x, mode="train")` returns x: the full-sequence forward that
    autograd differentiates. `forward(x, mode="prefill" | "decode",
    cache_size, cache)` returns (x, cache): prefill allocates the pools;
    decode reads `cache` and writes the step's rows into its pools in
    place. `cache` is a dict with the JAX leaf names: kv_pool_key,
    kv_pool_value [B, L*PP, page, H*D] (int8 under kv_cache_dtype "int8",
    with kv_pool_scale [B, L*PP/chunk, 8, chunk*page] f32), cache_index
    (an int: tokens already in the pool), with cfg.rel_pos_buckets `step`
    (an int: the T5 bias's query offset) and, with cross-attention,
    cross_key / cross_value [Bkv, L, S, H, D] (written by prefill only;
    decode may run B = G * Bkv beam rows over them).

    Layer i's drop-path rate is linspace(0, cfg.drop_path_rate, L)[i], as
    in the `Encoder`; a training forward takes the keep flags from
    `drop_path_keep` or draws them from its generator first
    (`draw_drop_path`)."""

    def __init__(self, cfg: TransformerConfig, has_cross_attention=False,
                 encoder_dim: Optional[int] = None, device=None):
        super().__init__()
        if cfg.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype {cfg.kv_cache_dtype!r}: "
                             "'model' or 'int8'")
        self.cfg = cfg
        self.has_cross_attention = has_cross_attention
        alpha = cfg.deepnorm_alpha if cfg.deepnorm else 1.0
        self.drop_path_rates = [float(r) for r in np.linspace(
            0, cfg.drop_path_rate, cfg.num_layers)]
        self.register_buffer("keep_prob", 1.0 - torch.tensor(
            self.drop_path_rates, device=device), persistent=False)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, alpha, has_cross_attention, encoder_dim,
                          device=device, layer_idx=i, drop_path=rate)
             for i, rate in enumerate(self.drop_path_rates)])
        if cfg.normalize_before:
            self.layer_norm = make_norm(cfg, device=device)
        if cfg.rel_pos_buckets:
            self.self_attn_relative_position = _rel_bias(cfg, False, device)

    def draw_drop_path(self, batch: int, generator: torch.Generator
                       ) -> Optional[torch.Tensor]:
        """Every drop-path keep flag of one training forward, [L, branches,
        B] bool (layer; self-attention, cross-attention if any, FFN;
        sample), keep ~ Bernoulli(1 - rate_i), drawn from `generator`; None
        outside training or when no layer drops."""
        if not self.training or not any(self.drop_path_rates):
            return None
        nb = 3 if self.has_cross_attention else 2
        u = torch.rand(len(self.drop_path_rates), nb, batch,
                       generator=generator, device=generator.device)
        return u < self.keep_prob[:, None, None]

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache_size: int = 0, cache: Optional[Dict] = None,
                causal: bool = True,
                self_key_padding_mask: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None,
                encoder_out: Optional[torch.Tensor] = None,
                encoder_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                drop_path_keep: Optional[torch.Tensor] = None):
        """`encoder_out` [Bkv, S, E_enc] is read in train mode and by
        prefill (decode reads the cross cache instead); with
        `encoder_padding_mask` [Bkv, S] (True = valid) every layer's
        cross-attention masks its keys. `generator`: the dropout seeds,
        drop-path flags and MoE routing draws of a training forward in
        train mode (needed when cfg has a dropout or drop-path rate;
        prefill and decode never drop and route deterministically).
        `drop_path_keep`: `draw_drop_path`'s flags, drawn from `generator`
        when not given."""
        if self.has_cross_attention and mode != "decode" and (
                encoder_out is None):
            raise ValueError(f"mode {mode!r} of a cross-attention decoder "
                             "needs encoder_out")
        rel = getattr(self, "self_attn_relative_position", None)
        if mode == "train":
            if rel is not None:
                rows = rel(x.shape[1], x.shape[1])
                attn_bias = rows if attn_bias is None else attn_bias + rows
            cross_kw = (dict(encoder_out=encoder_out,
                             key_padding_mask=encoder_padding_mask)
                        if self.has_cross_attention else None)
            return self._forward_train(x, causal, self_key_padding_mask,
                                       attn_bias, cross_kw, generator,
                                       drop_path_keep)
        if mode not in ("prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        if cache_size <= 0:
            raise ValueError("prefill/decode need cache_size")
        L, B, T = cfg.num_layers, x.shape[0], x.shape[1]
        H, D = cfg.num_heads, cfg.head_dim
        page, chunk, pp = _scan_pool_geometry(cache_size)
        x = x.to(cfg.dtype)
        kv_int8 = cfg.kv_cache_dtype == "int8"
        if mode == "prefill":
            shape = (B, L * pp, page, H * D)
            pool_dt = torch.int8 if kv_int8 else cfg.dtype
            kp = torch.zeros(shape, dtype=pool_dt, device=x.device)
            vp = torch.zeros(shape, dtype=pool_dt, device=x.device)
            sp = (torch.zeros((B, L * pp // chunk, 8, chunk * page),
                              dtype=torch.float32, device=x.device)
                  if kv_int8 else None)
            start = 0
        else:
            kp, vp = cache["kv_pool_key"], cache["kv_pool_value"]
            sp = cache["kv_pool_scale"] if kv_int8 else None
            start = int(cache["cache_index"])
        cross = None
        if self.has_cross_attention and mode == "prefill":
            # [L, B, S, H, D] storage seen as [B, L, S, H, D]: each layer's
            # slice is contiguous; every layer writes its own
            Bkv, S = encoder_out.shape[0], encoder_out.shape[1]
            cross = tuple(torch.empty(
                (L, Bkv, S, H, D), dtype=cfg.dtype,
                device=x.device).transpose(0, 1) for _ in range(2))
        elif self.has_cross_attention:
            cross = (cache["cross_key"], cache["cross_value"])
        xpos = (xpos_inputs(cfg, start, T, x.device) if cfg.xpos_rel_pos
                else None)
        step = None
        if rel is not None:
            step = 0 if mode == "prefill" else int(cache["step"])
            rows = rel(T, cache_size, step)
            attn_bias = rows if attn_bias is None else attn_bias + rows
        for li, layer in enumerate(self.layers):
            cross_kw = (None if cross is None else dict(
                encoder_out=encoder_out, cross=cross, li=li,
                key_padding_mask=encoder_padding_mask))
            x = layer(x, kp, vp, sp, li, start, mode=mode, causal=causal,
                      page=page, chunk=chunk, pages_per_layer=pp, xpos=xpos,
                      key_padding_mask=self_key_padding_mask,
                      attn_bias=attn_bias, cross_kw=cross_kw)
        if cfg.normalize_before:
            x = self.layer_norm(x)
        cache = {"kv_pool_key": kp, "kv_pool_value": vp}
        if kv_int8:
            cache["kv_pool_scale"] = sp
        cache["cache_index"] = start + T
        if step is not None:
            cache["step"] = step + T
        if cross is not None:
            cache["cross_key"], cache["cross_value"] = cross
        return x, cache

    def _forward_train(self, x, causal, key_padding_mask, attn_bias,
                       cross_kw, generator, drop_path_keep):
        """The looped stack's train mode (:914-949); the scanned stack
        (:826-848) computes the same. With cfg.remat each layer is
        recomputed in the backward under cfg.remat_policy (`remat`)."""
        cfg = self.cfg
        if drop_path_keep is None and generator is not None:
            drop_path_keep = self.draw_drop_path(x.shape[0], generator)
        seeds = _dropout_seeds(self, cfg, generator, len(self.layers))
        x = x.to(cfg.dtype)
        xpos = None
        if cfg.xpos_rel_pos:
            # a sequence shard (cfg.seq_axis) rotates at global positions
            T, start, k_len = x.shape[1], 0, None
            if cfg.seq_axis is not None:
                import torch.distributed as dist

                start = dist.get_rank(cfg.seq_axis) * T
                k_len = dist.get_world_size(cfg.seq_axis) * T
            xpos = xpos_inputs(cfg, start, T, x.device, k_len)
        kw = dict(mode="train", causal=causal, xpos=xpos,
                  key_padding_mask=key_padding_mask, attn_bias=attn_bias,
                  cross_kw=cross_kw)
        for i, (layer, seed) in enumerate(zip(self.layers, seeds)):
            keep = None if drop_path_keep is None else drop_path_keep[i]
            if cfg.remat and torch.is_grad_enabled():
                x = remat(cfg.remat_policy, layer, x, seed=seed,
                          drop_path_keep=keep, **kw)
            else:
                x = layer(x, seed=seed, drop_path_keep=keep, **kw)
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
