"""Batched serving engine: continuous batching over a paged KV cache (port
of unilm_tpu/runtime/serving.py: `_per_batch_xpos` :63,
`PagedSelfAttention` :79, `PagedDecoderLayer` / `_ScanPagedLayer` /
`PagedDecoderStack` :251-382, `PagedGPT` :385, `batched_sample` :451,
`ServingConfig` :493, `SamplingParams` :520, `_Slot` :529,
`ServingEngine` :543).

- `PagedGPT`: UniGPT's text path in serving mode, with UniGPT's parameter
  names (embed_tokens, decoder.layers.{i}.self_attn.q_proj, ...), so a
  UniGPT state_dict, or a looped or stacked flax tree through
  convert/from_jax.py, loads unchanged. The stack is one `nn.ModuleList`
  over ONE flat pool pair [L*P, page, H*D] (plus the int8 scale sidecar
  [L*P/chunk, 8, chunk*page]) updated IN PLACE; layer li owns pages
  [li*P, (li+1)*P), and the layer offset li*P is added to the block
  tables, the run bases and the trash page. The JAX looped stack and its
  nn.scan twin are the same module list here.
- Dispatch of a layer's attention, as in JAX: a one-token step on CUDA
  tensors with `use_kernel` goes to the contiguous-run kernel
  (ops/paged_attention.run_decode_append_attention, bf16 or int8 pools)
  when the engine passes run bases, else, for bf16 pools, to the
  block-table append kernel (paged_decode_append_attention). Everything
  else (CPU tensors, `use_kernel=False`, chunked prefill, speculative
  verify, an int8 step without runs) scatters the rows into the pool,
  invalid positions to the layer's trash page, and attends over the
  gathered pages in plain torch. On the CPU the JAX engine takes that
  path too.
- `ServingEngine`: the host scheduler, ported nearly line for line:
  reserve-at-admission with a contiguous-first allocator, chunked
  prefill, a page-granular prefix cache with eviction, per-slot sampling
  and prompt-lookup speculative decoding. A jitted call with donated pools
  becomes a plain call on pools updated in place.

- MoE layers (every `moe_freq`-th, core/moe.py) route deterministically,
  their experts and router in full precision under int8 weights.
- `ServingEngine(mesh=...)`: tensor-parallel serving over a DeviceMesh
  (parallel/mesh.py) whose `tensor` axis splits the heads. The parameters
  are placed by parallel/sharding.py's rules (`shard_parameters`: q/k/v
  and fc1 keep their block of output features, out_proj and fc2 their
  block of input features, and each computes its part of the product;
  the data and fsdp axes keep whole parameters), the KV pools hold each
  rank's heads
  ([L*P, page, H*D / tp], JAX's P(None, None, "tensor")), each rank
  attends over its heads and an all-gather over the tensor group rebuilds
  the heads before out_proj; the int8 scale sidecar (per-token scales of
  the whole row) is replicated. As in JAX it takes the plain path
  (`use_kernel` is `mesh is None`) and refuses int8 weights, the scanned
  stack and heads that do not divide over the axis. Every rank runs the
  same scheduler on the same requests and so emits the same tokens.

Differences from the JAX engine: sampling draws from a `torch.Generator`
seeded from (seed, step), so sampled streams are reproducible but not the
JAX streams (greedy streams are identical); int8 pools are dequantized
after the page gather, not before (the same values, without a
dequantized copy of the whole pool).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core import positional
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import FeedForward, make_dense, make_norm
from unilm_tpu_torch.core.moe import MoELayer, is_moe_layer
from unilm_tpu_torch.models.kosmos import UniGPTConfig, sinusoidal_table
from unilm_tpu_torch.ops.paged_attention import (
    paged_decode_append_attention, quantize_kv_rows,
    run_decode_append_attention)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.paged_kv import paged_attention


# --------------------------------------------------------------------------- #
# Serving-mode modules
# --------------------------------------------------------------------------- #


def _per_batch_xpos_tables(pos: torch.Tensor, head_dim: int, scale_base: int):
    """xPos rotary tables at per-slot absolute positions pos [B, T]:
    ((sin, cos) for q, (sin, cos) for k with the inverse decay scale),
    float32 [B, T, 1, D] to broadcast against [B, T, H, D]."""
    B, T = pos.shape
    sin, cos, scale = positional.xpos_sin_cos_scale(
        pos.reshape(-1), 0.0, head_dim, scale_base)
    shape = (B, T, 1, head_dim)
    q_tab = [t.reshape(shape)
             for t in positional.rotary_tables(sin, cos, scale)]
    k_tab = [t.reshape(shape)
             for t in positional.rotary_tables(sin, cos, 1.0 / scale)]
    return q_tab, k_tab


def _per_batch_xpos(x: torch.Tensor, pos: torch.Tensor, scale_base: int,
                    invert: bool = False) -> torch.Tensor:
    """Apply xPos at per-batch absolute positions. x [B, T, H, D],
    pos [B, T]."""
    q_tab, k_tab = _per_batch_xpos_tables(pos, x.shape[-1], scale_base)
    return positional.apply_rotary(x, *(k_tab if invert else q_tab))


class PagedSelfAttention(nn.Module):
    """MultiheadAttention's serving twin: same projections and parameter
    names; KV lives in the shared flat page pool."""

    def __init__(self, cfg: TransformerConfig, use_kernel: bool = True,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.tp_group = None  # the tensor group of a head-sharded pool
        H, D, E = cfg.num_heads, cfg.head_dim, cfg.embed_dim
        vo_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul

        def proj(i, o, s):
            return make_dense(cfg, i, o, init_scale=s, use_kernel=use_kernel,
                              device=device)

        self.q_proj = proj(E, H * D, 2 ** -0.5)
        self.k_proj = proj(E, H * D, 2 ** -0.5)
        self.v_proj = proj(E, H * D, 2 ** -0.5 * vo_scale)
        if cfg.subln:
            self.inner_attn_ln = make_norm(cfg, H * D, device=device)
        self.out_proj = proj(H * D, E, vo_scale)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, E]
        k_pool: torch.Tensor,  # [L*P, page, H*D], updated in place
        v_pool: torch.Tensor,
        block_tables: torch.Tensor,  # [B, MP] int32, layer offset applied
        lengths: torch.Tensor,  # [B] int32 tokens already in the cache
        n_valid: torch.Tensor,  # [B] int32 valid (non-pad) tokens in x
        trash_page: int = 0,  # this layer's trash page id
        bases: Optional[torch.Tensor] = None,  # [B] first page of each run
        chunk_pages: int = 8,
        scale_pool: Optional[torch.Tensor] = None,  # int8 KV sidecar
        xpos=None,  # (q tables, k tables, qscale) from PagedGPT
    ) -> torch.Tensor:
        cfg = self.cfg
        H, D = cfg.num_heads, cfg.head_dim
        B, T = x.shape[0], x.shape[1]
        page = k_pool.shape[1]
        quantized = scale_pool is not None

        q = self.q_proj(x).view(B, T, H, D)
        k = self.k_proj(x).view(B, T, H, D)
        v = self.v_proj(x).view(B, T, H, D)
        if xpos is not None:
            q_tab, k_tab, qscale = xpos
            q = positional.apply_rotary(q, *q_tab)
            k = positional.apply_rotary(k, *k_tab)
            q = (q * qscale).to(q.dtype)
        scale = cfg.attn_scale if cfg.attn_scale is not None else D ** -0.5

        if (T == 1 and self.use_kernel and x.is_cuda
                and (bases is not None or not quantized)):
            if bases is not None:
                # contiguous runs: row append + slab-bounded run kernel
                out = run_decode_append_attention(
                    q, k, v, k_pool, v_pool, bases, lengths,
                    max_pages=block_tables.shape[1], scale=scale,
                    chunk=chunk_pages, scale_pool=scale_pool)[0]
            else:
                out = paged_decode_append_attention(
                    q, k, v, k_pool, v_pool, block_tables, lengths,
                    scale=scale)[0]
            return self._out(out.reshape(B, T, H * D))

        # ---- scatter the new rows into pages (invalid -> trash page)
        HD = H * D
        k_rows, v_rows = k.reshape(B, T, HD), v.reshape(B, T, HD)
        if quantized:
            # per-token scales of the whole row, on every rank alike
            ki, vi, ks, vs = quantize_kv_rows(k_rows.reshape(B * T, HD),
                                              v_rows.reshape(B * T, HD))
            k_rows, v_rows = ki.reshape(B, T, HD), vi.reshape(B, T, HD)
        group = self.tp_group
        if group is not None:
            # this rank's heads of the rows, the pool and the queries
            H //= dist.get_world_size(group)
            h0 = dist.get_rank(group) * H
            q = q[:, :, h0:h0 + H]
            k_rows = k_rows[..., h0 * D:(h0 + H) * D]
            v_rows = v_rows[..., h0 * D:(h0 + H) * D]
            HD = H * D
        tables = block_tables.long()
        pos = lengths.long()[:, None] + torch.arange(T, device=x.device)
        valid = torch.arange(T, device=x.device)[None] < n_valid[:, None]
        slot = torch.clamp(torch.div(pos, page, rounding_mode="floor"), 0,
                           tables.shape[1] - 1)
        page_ids = torch.where(valid, torch.gather(tables, 1, slot),
                               torch.full_like(slot, trash_page))
        offs = torch.remainder(pos, page)
        k_pool[page_ids, offs] = k_rows.to(k_pool.dtype)
        v_pool[page_ids, offs] = v_rows.to(v_pool.dtype)
        if quantized:
            slab_ids = torch.div(page_ids, chunk_pages, rounding_mode="floor")
            slab_pos = torch.remainder(page_ids, chunk_pages) * page + offs
            scale_pool[slab_ids, 0, slab_pos] = ks.reshape(B, T)
            scale_pool[slab_ids, 1, slab_pos] = vs.reshape(B, T)

        def gather(pool, row):
            """This batch's pages [B, MP, page, H*D], dequantized (in the
            compute dtype, as the JAX engine's whole-pool dequant)."""
            g = pool[tables]
            if not quantized:
                return g
            nslab = scale_pool.shape[0]
            sc = scale_pool[:, row].reshape(nslab * chunk_pages, page)
            return g.to(x.dtype) * sc[tables].to(x.dtype)[..., None]

        MP = tables.shape[1]
        if T == 1:
            kk, vv = gather(k_pool, 0), gather(v_pool, 1)
            ident = torch.arange(B * MP, device=x.device).reshape(B, MP)
            out = paged_attention(
                q, kk.reshape(B * MP, page, HD), vv.reshape(B * MP, page, HD),
                ident, lengths.long() + 1, scale=scale,
                use_kernel=(None if self.use_kernel and not quantized
                            else False))
        else:
            # prefill / verify: this batch's pages, causal + ragged mask
            kk = gather(k_pool, 0).reshape(B, MP * page, H, D)
            vv = gather(v_pool, 1).reshape(B, MP * page, H, D)
            j = torch.arange(MP * page, device=x.device)[None, None, :]
            causal_ok = j <= pos[:, :, None]  # [B, T, S]
            in_seq = j < (lengths.long() + n_valid.long())[:, None, None]
            logits = torch.einsum("bthd,bshd->bhts", (q * scale).float(),
                                  kk.float())
            logits = logits.masked_fill(~(causal_ok & in_seq)[:, None], -1e30)
            p = torch.softmax(logits, dim=-1).to(vv.dtype)
            out = torch.einsum("bhts,bshd->bthd", p.float(),
                               vv.float()).to(vv.dtype)
        out = out.reshape(B, T, HD)
        if group is not None:
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, -1)
        return self._out(out)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        if self.cfg.subln:
            out = self.inner_attn_ln(out)
        return self.out_proj(out)


class PagedDecoderLayer(nn.Module):
    """Pre-LN decoder layer over the shared pool; layer `li` owns pages
    [li*P, (li+1)*P). An MoE layer (`layer_idx`, core/moe.py) has the MoE
    FFN `moe`, routed deterministically (eval capacity; one slot an
    expert at a one-token step), its experts and router in full precision
    under int8 weights (JAX :279-286)."""

    def __init__(self, cfg: TransformerConfig, use_kernel: bool = True,
                 device=None, layer_idx: int = 0):
        super().__init__()
        if not cfg.normalize_before:
            raise ValueError("the serving path assumes pre-LN (Magneto/subln)")
        self.self_attn_layer_norm = make_norm(cfg, device=device)
        self.self_attn = PagedSelfAttention(cfg, use_kernel, device=device)
        self.final_layer_norm = make_norm(cfg, device=device)
        if is_moe_layer(cfg, layer_idx):
            self.moe = MoELayer(cfg, device=device)
        else:
            ffn_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
            self.ffn = FeedForward(cfg, init_scale=ffn_scale,
                                   use_kernel=use_kernel, device=device)

    def forward(self, x, k_pool, v_pool, block_tables, lengths, n_valid,
                off: int, bases=None, chunk_pages: int = 8, scale_pool=None,
                xpos=None):
        h = self.self_attn(
            self.self_attn_layer_norm(x), k_pool, v_pool, block_tables + off,
            lengths, n_valid, trash_page=off,
            bases=None if bases is None else bases + off,
            chunk_pages=chunk_pages, scale_pool=scale_pool, xpos=xpos)
        x = x + h
        h = self.final_layer_norm(x)
        return x + (self.moe(h) if hasattr(self, "moe") else self.ffn(h))


class PagedDecoderStack(nn.Module):
    """The serving stack: `layers` (a ModuleList) and the final layer_norm."""

    def __init__(self, cfg: TransformerConfig, use_kernel: bool = True,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [PagedDecoderLayer(cfg, use_kernel, device=device, layer_idx=i)
             for i in range(cfg.num_layers)])
        self.layer_norm = make_norm(cfg, device=device)

    def forward(self, x, k_pool, v_pool, block_tables, lengths, n_valid,
                pages_per_layer: int, bases=None, chunk_pages: int = 8,
                scale_pool=None, xpos=None):
        for li, layer in enumerate(self.layers):
            x = layer(x, k_pool, v_pool, block_tables, lengths, n_valid,
                      li * pages_per_layer, bases=bases,
                      chunk_pages=chunk_pages, scale_pool=scale_pool,
                      xpos=xpos)
        return self.layer_norm(x)


class PagedGPT(nn.Module):
    """UniGPT's text path in serving mode; loads UniGPT parameters by name
    (`segment_emb` and an untied `output_projection`, which the JAX
    PagedGPT does not read either, are left out). `use_kernel=False` keeps
    every device on the plain versions, int8 projections included."""

    def __init__(self, cfg: UniGPTConfig, use_kernel: bool = True,
                 chunk_pages: int = 8, device=None):
        super().__init__()
        self.cfg = cfg
        self.tcfg = cfg.decoder_cfg()
        self.use_kernel = use_kernel
        self.chunk_pages = chunk_pages
        E = cfg.embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=device,
                                         dtype=cfg.param_dtype)
        if cfg.use_positional and cfg.learned_pos:
            self.embed_positions = nn.Embedding(
                cfg.max_positions + cfg.padding_idx + 1, E, device=device)
        elif cfg.use_positional:
            table = sinusoidal_table(cfg.max_positions + cfg.padding_idx + 1,
                                     E, cfg.padding_idx)
            self.register_buffer("pos_table",
                                 torch.from_numpy(table).to(device),
                                 persistent=False)
        self.decoder = PagedDecoderStack(self.tcfg, use_kernel, device=device)

    @torch.no_grad()
    def forward(
        self,
        tokens: torch.Tensor,  # [B, T]
        k_pools: torch.Tensor,  # [L*P, page, H*D] flat pool, P logical pages
        v_pools: torch.Tensor,
        block_tables: torch.Tensor,  # [B, MP] int32 logical page ids
        lengths: torch.Tensor,  # [B] int32
        n_valid: torch.Tensor,  # [B] int32
        last_logit_only: bool = False,
        bases: Optional[torch.Tensor] = None,  # [B] contiguous-run pages
        scale_pool: Optional[torch.Tensor] = None,  # int8 KV scale sidecar
    ):
        """Returns (logits [B, T|1, V], k_pools, v_pools[, scale_pool]); the
        pools are the input tensors, updated in place."""
        cfg, tcfg = self.cfg, self.tcfg
        L = cfg.num_layers
        if k_pools.shape[0] % L:
            raise ValueError(f"pool of {k_pools.shape[0]} pages does not "
                             f"split over {L} layers")
        B, T = tokens.shape
        dtype = tcfg.dtype
        x = self.embed_tokens(tokens.long()).to(dtype)
        x = x * (cfg.embed_dim ** 0.5 if cfg.scale_embedding else 1.0)
        steps = torch.arange(T, device=tokens.device)
        pos = lengths.long()[:, None] + steps[None, :]  # [B, T] absolute
        if cfg.use_positional:
            positions = pos + cfg.padding_idx + 1
            if cfg.learned_pos:
                x = x + self.embed_positions(positions).to(x.dtype)
            else:
                x = x + self.pos_table[positions].to(x.dtype)
        xpos = None
        if tcfg.xpos_rel_pos:
            q_tab, k_tab = _per_batch_xpos_tables(pos, tcfg.head_dim,
                                                  tcfg.xpos_scale_base)
            k_len = (lengths + n_valid).float()
            p = torch.clamp(pos.float(), min=1.0)
            mult = torch.clamp(torch.log(p) / math.log(tcfg.scale_length),
                               min=1.0)
            qscale = torch.where((k_len > tcfg.scale_length)[:, None], mult,
                                 torch.ones_like(mult))
            xpos = (q_tab, k_tab, qscale[:, :, None, None])
        x = self.decoder(x, k_pools, v_pools, block_tables, lengths, n_valid,
                         k_pools.shape[0] // L, bases=bases,
                         chunk_pages=self.chunk_pages, scale_pool=scale_pool,
                         xpos=xpos)
        if last_logit_only:
            x = x[:, -1:]
        logits = F.linear(x, self.embed_tokens.weight.to(x.dtype))
        if scale_pool is not None:
            return logits, k_pools, v_pools, scale_pool
        return logits, k_pools, v_pools


# --------------------------------------------------------------------------- #
# Per-slot sampling
# --------------------------------------------------------------------------- #


def batched_sample(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B] float; <= 0 means greedy
    top_k: torch.Tensor,  # [B] int; 0 disables the top-k cut
    top_p: torch.Tensor,  # [B] float; 0 disables the nucleus cut
    rng: torch.Generator,  # on logits' device
    max_topk: int = 64,
) -> torch.Tensor:
    """Vectorized sampler over heterogeneous per-slot parameters, the JAX
    function's algorithm: candidates are the top-`max_topk` of the
    tempered log-softmax, cut by top-k and by top-p (a token is kept while
    the mass before it is < top_p, so at least one is), then drawn with
    the Gumbel-max trick; greedy slots take the argmax of the raw
    logits. Returns int32 [B]."""
    B, V = logits.shape
    K = min(max_topk, V)
    lf = logits.float()
    lp = torch.log_softmax(lf / torch.clamp(temperature.float(),
                                            min=1e-6)[:, None], dim=-1)
    vals, idx = torch.topk(lp, K, dim=-1)  # sorted descending
    ranks = torch.arange(K, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=K),
                        torch.full_like(top_k, K))[:, None]
    keep = ranks < k_eff
    probs = torch.exp(vals)
    cum = torch.cumsum(probs, dim=-1)
    keep &= torch.where(top_p[:, None] > 0, (cum - probs) < top_p[:, None],
                        torch.ones_like(keep))
    masked = torch.where(keep, vals, torch.full_like(vals, -1e30))
    u = torch.rand(masked.shape, generator=rng, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    choice = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    greedy = torch.argmax(lf, dim=-1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)


# --------------------------------------------------------------------------- #
# Continuous-batching engine (host scheduler)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ServingConfig:
    max_batch: int = 8
    page_size: int = 64
    num_pages: int = 256  # per layer, page 0 reserved as trash
    max_pages_per_seq: int = 16
    max_new_tokens: int = 64
    eos: int = 2
    prefill_bucket: int = 64  # prompt lengths padded up to a multiple of this
    max_topk: int = 64  # static candidate window for sampled requests
    seed: int = 0
    chunk_pages: int = 8  # slab size of the contiguous-run decode kernel;
    # the last chunk_pages-1 pages of each layer's region are kept free
    prefix_caching: bool = True  # page-granular prompt-prefix sharing
    spec_k: int = 0  # speculative decoding: verify up to k prompt-lookup
    # draft tokens per step (0 = off). Greedy slots only; exact-output.
    spec_ngram: int = 3  # n-gram length for prompt-lookup draft matching
    kv_dtype: str = "model"  # "model" (cfg.dtype) or "int8" (per-token
    # symmetric quantization with a scale sidecar)
    weight_dtype: str = "model"  # "model" or "int8": weight-only int8 for
    # every decoder-layer projection (ops/quant.py); embeddings stay full
    # precision (tied lookup + LM head)


@dataclasses.dataclass
class SamplingParams:
    """Per-request decode params. temperature <= 0 selects greedy argmax."""

    temperature: float = 0.0
    top_k: int = 0  # 0 = no top-k cut
    top_p: float = 0.0  # 0 = no nucleus cut


@dataclasses.dataclass
class _Slot:
    req_id: Any
    budget: int
    reserved: int  # pages reserved at admission
    generated: int = 0
    base: int = -1  # first page of a contiguous run, or -1 if scattered
    prompt: Optional[List[int]] = None  # tokens not yet prefilled
    filled: int = 0  # prompt tokens already in the pool
    table_row: Optional[np.ndarray] = None  # held back until prefill done
    sp: Optional[SamplingParams] = None
    full_prompt: Optional[List[int]] = None  # for prefix registration
    history: Optional[List[int]] = None  # prompt + emitted (lookup drafting)


def _state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A torch state_dict as it is, or a flax tree (looped or stacked)
    through the bridge."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        return dict(params)
    from unilm_tpu_torch.convert.from_jax import flax_to_state_dict

    return flax_to_state_dict(params)


class ServingEngine:
    """Continuous-batching server over `PagedGPT` on one device, or
    tensor-parallel over a DeviceMesh `mesh` (see the module docstring).

    `params` is a UniGPT state_dict or a flax param tree (looped or stacked:
    the port's stack is the same module list either way). `device` holds
    the model and the pools: "cuda" by default, which raises on a host
    without a card; the CPU only when asked for (`device="cpu"`).
    `use_kernel=False` runs the plain versions on every device (the JAX
    engine's use_kernel is `mesh is None`)."""

    def __init__(self, cfg: UniGPTConfig, scfg: ServingConfig, params,
                 mesh=None, *, device="cuda", use_kernel: bool = True):
        tp = 1
        if mesh is not None:
            from unilm_tpu_torch.parallel.mesh import axis_size

            if cfg.scan_layers:
                raise ValueError("scan_layers serving is single-device (the "
                                 "JAX engine asserts mesh is None)")
            if scfg.weight_dtype == "int8":
                raise ValueError("int8 weights are a single-device decode "
                                 "optimization; the mesh path shards "
                                 "full-precision weights")
            tp = axis_size(mesh, "tensor")
            if cfg.num_heads % tp:
                raise ValueError(f"heads {cfg.num_heads} not divisible by "
                                 f"tensor axis {tp}")
            use_kernel = False  # JAX: use_kernel = mesh is None
        self.mesh = mesh
        self.device = resolve_device(device)
        sd = _state_dict(params)
        if scfg.weight_dtype == "int8":
            # weight-only int8 for every decoder-layer projection
            # (per-output-channel scales); embeddings and norms stay
            from unilm_tpu_torch.ops.quant import quantize_state_dict

            sd = quantize_state_dict(sd)
            cfg = dataclasses.replace(cfg, quant_weights=True)
        self.cfg, self.scfg = cfg, scfg
        self.use_kernel = use_kernel
        self.model = PagedGPT(cfg, use_kernel=use_kernel,
                              chunk_pages=scfg.chunk_pages, device=self.device)
        own = self.model.state_dict()
        missing = sorted(set(own) - set(sd))
        if missing:
            raise KeyError(f"params lack {missing[:5]}")
        self.model.load_state_dict({k: sd[k] for k in own}, strict=True,
                                   assign=True)
        self.model.to(self.device).eval()
        if mesh is not None:
            from unilm_tpu_torch.parallel.sharding import shard_parameters

            shard_parameters(self.model, mesh, training=False)
            if tp > 1:
                for m in self.model.modules():
                    if isinstance(m, PagedSelfAttention):
                        m.tp_group = mesh.get_group("tensor")
        L, H = cfg.num_layers, cfg.num_heads
        D = cfg.embed_dim // H
        # per-layer page count rounded to a chunk multiple so every layer
        # region starts slab-aligned (global run bases = i*P + local base)
        self.num_pages = -(-scfg.num_pages // scfg.chunk_pages) * scfg.chunk_pages
        self.quantized = scfg.kv_dtype == "int8"
        kv_dt = torch.int8 if self.quantized else cfg.dtype
        # this rank's heads under a tensor-parallel mesh
        shape = (L * self.num_pages, scfg.page_size, H * D // tp)
        pools = [torch.zeros(shape, dtype=kv_dt, device=self.device),
                 torch.zeros(shape, dtype=kv_dt, device=self.device)]
        if self.quantized:
            nslab = L * self.num_pages // scfg.chunk_pages
            pools.append(torch.zeros(
                (nslab, 8, scfg.chunk_pages * scfg.page_size),
                dtype=torch.float32, device=self.device))
        self.pools = tuple(pools)
        self.tables = np.zeros((scfg.max_batch, scfg.max_pages_per_seq), np.int32)
        self.lengths = np.zeros(scfg.max_batch, np.int32)
        self.cur_tok = np.zeros(scfg.max_batch, np.int32)
        self.active = np.zeros(scfg.max_batch, bool)
        self.temps = np.zeros(scfg.max_batch, np.float32)
        self.topks = np.zeros(scfg.max_batch, np.int32)
        self.topps = np.zeros(scfg.max_batch, np.float32)
        self.bases = np.zeros(scfg.max_batch, np.int32)
        # pages [1, num_pages - chunk_pages + 1): the tail stays free so a
        # run's last slab never leaves this layer's pool region
        self.free_pages: List[int] = list(
            range(1, max(2, self.num_pages - scfg.chunk_pages + 1)))
        self.slots: List[Optional[_Slot]] = [None] * scfg.max_batch
        self.queue: deque = deque()
        self.outputs: Dict[Any, List[int]] = {}
        # prefix cache: chain-key (nested tuples of full-page token tuples)
        # -> logical page id; page_rc counts live slots sharing a page
        # (rc==0 entries are retained for reuse and evictable under pool
        # pressure)
        self.prefix_cache: Dict[Any, int] = {}
        self.page_key: Dict[int, Any] = {}
        self.page_depth: Dict[int, int] = {}  # chain depth (eviction order)
        self.page_rc: Dict[int, int] = {}
        self.stats = {"prefill_chunks": 0, "prefix_hit_pages": 0,
                      "evicted_pages": 0, "spec_steps": 0,
                      "spec_accepted": 0}
        self._step_count = 0

    def _next_rng(self) -> torch.Generator:
        # a generator seeded from (seed, step): no state carried between
        # steps, reproducible for a fixed (seed, admission order, steps)
        self._step_count += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(self.scfg.seed * 1_000_003 + self._step_count)
        return g

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ---- device fns ------------------------------------------------------ #
    def _apply(self, tokens, tables, lengths, n_valid, bases=None):
        kp, vp = self.pools[0], self.pools[1]
        sp = self.pools[2] if self.quantized else None
        return self.model(self._t(tokens), kp, vp, self._t(tables),
                          self._t(lengths), self._t(n_valid),
                          bases=None if bases is None else self._t(bases),
                          scale_pool=sp)[0]

    def _sample(self, logits, temps, topks, topps):
        return batched_sample(logits, self._t(temps), self._t(topks),
                              self._t(topps), self._next_rng(),
                              max_topk=self.scfg.max_topk)

    def _decode_fn(self, tokens, tables, lengths, temps, topks, topps,
                   bases=None):
        n_valid = np.ones_like(lengths)
        logits = self._apply(tokens, tables, lengths, n_valid, bases=bases)
        return self._sample(logits[:, -1], temps, topks, topps)

    def _verify_fn(self, tokens, tables, lengths, n_valid, temps, topks,
                   topps):
        """Speculative verify: run T=spec_k+1 positions through the model
        and return the greedy token AT EVERY position, plus the
        position-0 token sampled with each slot's own params."""
        logits = self._apply(tokens, tables, lengths, n_valid)
        g = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        s0 = self._sample(logits[:, 0], temps, topks, topps)
        return g, s0

    def _prefill_fn(self, tokens, table, lengths, n_valid, temps, topks,
                    topps):
        logits = self._apply(tokens, table, lengths, n_valid)
        # first generated token = sampled at the last valid prompt position
        rows = torch.arange(logits.shape[0], device=logits.device)
        last = logits.float()[rows, self._t(n_valid).long() - 1]
        return self._sample(last, temps, topks, topps)

    # ---- scheduler ------------------------------------------------------- #
    def submit(self, req_id, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               sampling: Optional[SamplingParams] = None):
        self.queue.append((req_id, list(prompt), max_new_tokens
                           or self.scfg.max_new_tokens,
                           sampling or SamplingParams()))
        self.outputs[req_id] = []

    def _pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.scfg.page_size)

    def _prefix_keys(self, prompt: List[int]):
        """Chain keys for each FULL page of the prompt."""
        page = self.scfg.page_size
        keys, key = [], ()
        for i in range(len(prompt) // page):
            key = (key, tuple(prompt[i * page:(i + 1) * page]))
            keys.append(key)
        return keys

    def _match_prefix(self, prompt: List[int]) -> List[int]:
        """Longest chain of cached full pages matching the prompt head,
        capped at (len(prompt)-1)//page_size pages so the final prompt
        token is always recomputed."""
        if not self.scfg.prefix_caching:
            return []
        matched = []
        max_full = (len(prompt) - 1) // self.scfg.page_size
        for key in self._prefix_keys(prompt)[:max_full]:
            pid = self.prefix_cache.get(key)
            if pid is None:
                break
            matched.append(pid)
        return matched

    def _evict_retained(self, need: int) -> int:
        """Free up to `need` retained (rc==0) prefix pages. Returns count."""
        freed = 0
        # evict deepest chains first so shorter shared prefixes survive
        for pid, rc in sorted(self.page_rc.items(),
                              key=lambda kv: -self.page_depth.get(kv[0], 0)):
            if freed >= need:
                break
            if rc == 0:
                self.prefix_cache.pop(self.page_key.pop(pid), None)
                self.page_depth.pop(pid, None)
                del self.page_rc[pid]
                self.free_pages.append(pid)
                self.stats["evicted_pages"] += 1
                freed += 1
        return freed

    def _alloc(self, need: int) -> Tuple[List[int], int]:
        """Allocate `need` pages, contiguous-first, runs starting at
        chunk_pages-aligned ids. Returns (pages, base); base=-1 when only a
        scattered set fit."""
        free = sorted(self.free_pages)
        chunk = self.scfg.chunk_pages
        fs = set(free)
        for start in free:
            if start % chunk:
                continue
            if all((start + j) in fs for j in range(need)):
                run = list(range(start, start + need))
                self.free_pages = [p for p in free if p not in set(run)]
                return run, start
        run = free[:need]
        self.free_pages = free[need:]
        return run, -1

    def _try_admit(self) -> bool:
        if not self.queue:
            return False
        free_slots = [i for i in range(self.scfg.max_batch)
                      if self.slots[i] is None]
        if not free_slots:
            return False
        req_id, prompt, budget, sp = self.queue[0]
        need = self._pages_needed(len(prompt) + budget)
        if need > self.scfg.max_pages_per_seq:
            self.queue.popleft()
            raise MemoryError(f"request {req_id!r} exceeds max_pages_per_seq")
        matched = self._match_prefix(prompt)
        # pin the matched pages BEFORE eviction (they may sit at rc==0)
        for pid in matched:
            self.page_rc[pid] += 1
        need_new = need - len(matched)
        if need_new > len(self.free_pages):
            self._evict_retained(need_new - len(self.free_pages))
        if need_new > len(self.free_pages):
            for pid in matched:  # un-pin; request stays queued
                self.page_rc[pid] -= 1
            return False  # backpressure
        self.stats["prefix_hit_pages"] += len(matched)
        self.queue.popleft()
        slot = free_slots[0]
        pages, base = self._alloc(need_new)
        row = np.zeros(self.scfg.max_pages_per_seq, np.int32)
        row[: len(matched)] = matched
        row[len(matched): len(matched) + len(pages)] = pages
        base = -1 if matched else base  # mixed tables use the table kernel
        # the slot's table stays pointed at the trash page until the whole
        # prompt is prefilled
        self.slots[slot] = _Slot(req_id, budget, reserved=need, base=base,
                                 prompt=list(prompt),
                                 filled=len(matched) * self.scfg.page_size,
                                 table_row=row, sp=sp,
                                 full_prompt=list(prompt),
                                 history=(list(prompt)
                                          if self.scfg.spec_k > 0 else None))
        return True

    def _prefill_chunk(self, slot: int) -> None:
        """Advance one prefill_bucket-sized chunk of this slot's prompt."""
        st = self.slots[slot]
        self.stats["prefill_chunks"] += 1
        bucket = self.scfg.prefill_bucket
        chunk = st.prompt[st.filled:st.filled + bucket]
        padded = np.full((1, bucket), self.cfg.padding_idx, np.int32)
        padded[0, : len(chunk)] = chunk
        first = self._prefill_fn(
            padded, st.table_row[None], np.asarray([st.filled], np.int32),
            np.asarray([len(chunk)], np.int32),
            np.asarray([st.sp.temperature], np.float32),
            np.asarray([st.sp.top_k], np.int32),
            np.asarray([st.sp.top_p], np.float32))
        first = first.cpu().numpy()
        st.filled += len(chunk)
        if st.filled >= len(st.prompt):
            # register this prompt's full pages for prefix sharing (only now:
            # their KV just finished landing in the pool)
            if self.scfg.prefix_caching:
                for i, key in enumerate(self._prefix_keys(st.full_prompt)):
                    pid = int(st.table_row[i])
                    if key not in self.prefix_cache:
                        self.prefix_cache[key] = pid
                        self.page_key[pid] = key
                        self.page_depth[pid] = i
                        self.page_rc[pid] = self.page_rc.get(pid, 0) + 1
            # prompt complete: install the table and go live
            self.tables[slot] = st.table_row
            self.bases[slot] = max(st.base, 0)
            self.lengths[slot] = len(st.prompt)
            self.cur_tok[slot] = int(first[0])
            self.active[slot] = True
            self.temps[slot] = st.sp.temperature
            self.topks[slot] = st.sp.top_k
            self.topps[slot] = st.sp.top_p
            st.prompt = None
            if st.history is not None:
                st.history.append(int(first[0]))
            self._record(slot, int(first[0]))

    def _prefilling_slots(self) -> List[int]:
        return [i for i, st in enumerate(self.slots)
                if st is not None and st.prompt is not None]

    def _record(self, slot: int, tok: int):
        s = self.slots[slot]
        self.outputs[s.req_id].append(tok)
        s.generated += 1
        if tok == self.scfg.eos or s.generated >= s.budget:
            # free pages, clear slot; shared prefix pages only drop their
            # refcount (rc==0 pages stay retained for reuse)
            for p in self.tables[slot][: s.reserved]:
                p = int(p)
                if p in self.page_rc:
                    self.page_rc[p] -= 1
                else:
                    self.free_pages.append(p)
            self.tables[slot] = 0
            self.lengths[slot] = 0
            self.active[slot] = False
            self.temps[slot] = 0.0
            self.topks[slot] = 0
            self.topps[slot] = 0.0
            self.bases[slot] = 0
            self.slots[slot] = None

    def _find_draft(self, slot: int) -> List[int]:
        """Prompt-lookup drafting: match the last spec_ngram history tokens
        against earlier history; on a hit, propose the tokens that
        followed."""
        st = self.slots[slot]
        n, k = self.scfg.spec_ngram, self.scfg.spec_k
        h = st.history
        if h is None or len(h) <= n:
            return []
        tail = h[-n:]
        # newest match first (recent repetition predicts best)
        for i in range(len(h) - n - 1, -1, -1):
            if h[i:i + n] == tail:
                d = h[i + n:i + n + k]
                if d:
                    return d
                break
        return []

    def _spec_room(self, slot: int) -> bool:
        """Drafted rows must stay inside the slot's reserved pages."""
        st = self.slots[slot]
        cap = st.reserved * self.scfg.page_size
        return int(self.lengths[slot]) + self.scfg.spec_k + 1 <= cap

    def _spec_step(self, drafts: Dict[int, List[int]]) -> None:
        K = self.scfg.spec_k
        B = self.scfg.max_batch
        tokens = np.full((B, K + 1), self.cfg.padding_idx, np.int32)
        n_valid = np.ones(B, np.int32)
        tokens[:, 0] = self.cur_tok
        for i, d in drafts.items():
            tokens[i, 1:1 + len(d)] = d
            n_valid[i] = 1 + len(d)
        g, s0 = self._verify_fn(tokens, self.tables, self.lengths, n_valid,
                                self.temps, self.topks, self.topps)
        g, s0 = g.cpu().numpy(), s0.cpu().numpy()
        self.stats["spec_steps"] += 1
        for i in range(B):
            if not self.active[i]:
                continue
            if i not in drafts:
                # plain decode step for this slot: the position-0 token
                # sampled with ITS params (argmax iff temperature <= 0)
                tok = int(s0[i])
                self.lengths[i] += 1
                self.cur_tok[i] = tok
                if self.slots[i].history is not None:
                    self.slots[i].history.append(tok)
                self._record(i, tok)
                continue
            d = drafts[i]
            acc = 0
            while acc < len(d) and d[acc] == g[i, acc]:
                acc += 1
            self.stats["spec_accepted"] += acc
            # emit the accepted drafts plus the bonus token
            emitted = list(d[:acc]) + [int(g[i, acc])]
            self.lengths[i] += acc + 1
            self.cur_tok[i] = int(g[i, acc])
            for t in emitted:
                if self.slots[i] is None:
                    break  # EOS/budget hit mid-acceptance
                if self.slots[i].history is not None:
                    self.slots[i].history.append(int(t))
                self._record(i, int(t))

    def step(self):
        """One decode step for every active slot. When every active slot
        holds a contiguous page run, on CUDA with the kernels, the run
        kernel serves it; otherwise the block-table path."""
        if self.scfg.spec_k > 0:
            drafts = {
                i: d for i in range(self.scfg.max_batch)
                if self.active[i] and self.temps[i] <= 0
                and self._spec_room(i) and (d := self._find_draft(i))
            }
            if drafts:
                self._spec_step(drafts)
                return
        contig = (
            self.use_kernel and self.device.type == "cuda"
            and all(self.slots[i].base >= 0
                    for i in range(self.scfg.max_batch) if self.active[i])
        )
        nxt = self._decode_fn(
            self.cur_tok[:, None], self.tables, self.lengths, self.temps,
            self.topks, self.topps, bases=self.bases if contig else None)
        nxt = nxt.cpu().numpy()
        for i in range(self.scfg.max_batch):
            if self.active[i]:
                self.lengths[i] += 1
                self.cur_tok[i] = nxt[i]
                if self.slots[i].history is not None:
                    self.slots[i].history.append(int(nxt[i]))
                self._record(i, int(nxt[i]))

    def run(self) -> Dict[Any, List[int]]:
        while self.queue or self.active.any() or self._prefilling_slots():
            while self._try_admit():
                pass
            pre = self._prefilling_slots()
            if pre:
                self._prefill_chunk(pre[0])
            if self.active.any():
                self.step()
            elif not pre and self.queue:
                raise MemoryError("queued request can never be admitted")
        return self.outputs
