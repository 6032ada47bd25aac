"""Rectified Sparse Attention, ReSA (port of
unilm_tpu/ops/sparse_attention.py): block-sparse decoding where each step
attends only to the top-k KV blocks scored against the query by a
mean-pooled key summary per block, with a dense step at a fixed cadence
(`rectify_schedule`) that bounds the approximation.

In JAX these are XLA einsums with no Pallas kernel, so the port writes
them in plain torch, on the input's device. The top-k is a stable
descending sort, so that tied blocks (the forced sink and local blocks
all score +inf) come in JAX's `lax.top_k` order, lower index first.
Positions (`pos`, `kv_len`, `step`) are Python ints, as the port's cache
counters are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ReSAConfig:
    block_size: int = 64
    topk_blocks: int = 16
    rectify_interval: int = 256  # dense refresh every N decode steps
    sink_blocks: int = 1         # always keep the first block(s) (attn sink)
    local_blocks: int = 2        # always keep the newest block(s)


def block_key_summary(k_cache: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """[B, S, H, D] -> the mean-pooled key of each block, [B, nb, H, D]."""
    B, S, H, D = k_cache.shape
    nb = S // block_size
    return k_cache[:, :nb * block_size].reshape(
        B, nb, block_size, H, D).mean(dim=2)


def update_block_summary(summaries: torch.Tensor, k_cache: torch.Tensor,
                         pos: int, block_size: int) -> torch.Tensor:
    """The summaries with the block holding position `pos` (the key just
    written; `k_cache` is the cache after the append) recomputed over the
    block's valid prefix. A position in the tail that no summary row
    covers (S not a multiple of block_size) changes nothing."""
    nb = summaries.shape[1]
    pos = int(pos)
    bi = pos // block_size
    if bi >= nb:
        return summaries
    start = bi * block_size
    n_valid = min(max(pos + 1 - start, 1), block_size)
    blk = k_cache[:, start:start + block_size]
    mask = (torch.arange(block_size, device=blk.device)
            < n_valid)[None, :, None, None]
    out = summaries.clone()
    out[:, bi] = torch.sum(blk * mask, dim=1) / n_valid
    return out


def select_blocks(q: torch.Tensor, summaries: torch.Tensor, kv_len: int,
                  cfg: ReSAConfig) -> torch.Tensor:
    """The top-k block ids of each row, [B, k]: q [B, 1, H, D] against each
    block's summary, summed over heads, with the sink and local blocks
    forced to the top and blocks past kv_len to the bottom."""
    nb = summaries.shape[1]
    scores = torch.einsum("bhd,bnhd->bn", q[:, 0].float(),
                          summaries.float())
    n_valid_blocks = (int(kv_len) + cfg.block_size - 1) // cfg.block_size
    ids = torch.arange(nb, device=q.device)[None, :]
    valid = ids < n_valid_blocks
    forced = (ids < cfg.sink_blocks) | (
        ids >= n_valid_blocks - cfg.local_blocks)
    scores = torch.where(forced & valid, torch.inf, scores)
    scores = torch.where(valid, scores, -torch.inf)
    order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
    return order[:, :min(cfg.topk_blocks, nb)]


def sparse_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, block_ids: torch.Tensor,
                            kv_len: int, cfg: ReSAConfig,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, H, D] over the selected blocks' keys only (gathered to [B,
    k * block, H, D]); positions at or past kv_len are masked. Returns
    [B, 1, H, D] in q's dtype."""
    B, S, H, D = k_cache.shape
    if scale is None:
        scale = D ** -0.5
    bs = cfg.block_size
    gpos = (block_ids[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :]).reshape(B, -1)
    idx = gpos.clamp(max=S - 1)[:, :, None, None].expand(-1, -1, H, D)
    kg = torch.gather(k_cache, 1, idx)
    vg = torch.gather(v_cache, 1, idx)
    s = torch.einsum("bhd,bshd->bhs", (q[:, 0] * scale).float(), kg.float())
    s = torch.where((gpos < int(kv_len))[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhs,bshd->bhd", p.float(), vg.float())
    return out.to(q.dtype)[:, None]


def rectify_schedule(step: int, cfg: ReSAConfig) -> bool:
    """True on the steps where the dense refresh runs (a fixed cadence)."""
    return int(step) % cfg.rectify_interval == 0


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, H, D] over the cache's first kv_len keys: ReSA's rectify
    step. Returns [B, 1, H, D] in q's dtype."""
    S, D = k_cache.shape[1], k_cache.shape[3]
    sc = scale if scale is not None else D ** -0.5
    s = torch.einsum("bhd,bshd->bhs", (q[:, 0] * sc).float(),
                     k_cache.float())
    live = torch.arange(S, device=q.device)[None, None, :] < int(kv_len)
    p = torch.softmax(torch.where(live, s, NEG_INF), -1).to(v_cache.dtype)
    out = torch.einsum("bhs,bshd->bhd", p.float(), v_cache.float())
    return out.to(q.dtype)[:, None]


def resa_decode_step(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, summaries: torch.Tensor,
                     kv_len: int, step: int, cfg: ReSAConfig,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One ReSA decode step: dense on the rectify steps, block-sparse
    otherwise."""
    if rectify_schedule(step, cfg):
        return dense_decode_attention(q, k_cache, v_cache, kv_len, scale)
    ids = select_blocks(q, summaries, kv_len, cfg)
    return sparse_decode_attention(q, k_cache, v_cache, ids, kv_len, cfg,
                                   scale)
