"""Paged KV cache for serving ragged batches (port of
unilm_tpu/runtime/paged_kv.py: `PagedKVConfig` :27, `PagePool` :37,
`paged_attention` :101).

A shared page pool and per-sequence block tables let many sequences of
different lengths share device memory without a max_len reservation
each. The allocator is host logic (a free list of page ids); the pools
are fixed-shape tensors [num_pages, page_size, H, D] on the pool's device.

`paged_attention` launches the read-only block-table kernel
(ops/paged_attention.paged_decode_attention, csrc/paged_attention.cu) on
CUDA tensors, unless UNILM_TPU_DISABLE_PAGED_KERNEL is set or the caller
passes use_kernel=False; CPU tensors, and use_kernel=False, take the
gather formulation: each sequence's pages gathered into
[B, max_pages*page, H, D] and masked by length. The serving engine
reaches the gather for an int8-KV decode step in which some slot's pages
are scattered (runtime/serving.py), as the JAX engine does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from unilm_tpu_torch.ops.attention import dot_product_attention
from unilm_tpu_torch.ops.paged_attention import paged_decode_attention
from unilm_tpu_torch.runtime.device import resolve_device


@dataclasses.dataclass
class PagedKVConfig:
    num_pages: int
    page_size: int
    num_heads: int
    head_dim: int
    max_pages_per_seq: int
    dtype: torch.dtype = torch.bfloat16


class PagePool:
    """Host-side page allocator (free list) and device-side pools.

    The allocator hands out page ids in the JAX package's order (the free
    list starts as num_pages-1 .. 0 and pops from its end; `free` puts a
    table's pages back in reverse). `k_pool` / `v_pool` are
    [num_pages, page_size, H, D] tensors of cfg.dtype on `device` (the
    card unless the caller asks for the CPU), written IN PLACE by `append`
    (index_put_); the JAX pool rebinds new arrays instead."""

    def __init__(self, cfg: PagedKVConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.k_pool = torch.zeros(
            (cfg.num_pages, cfg.page_size, cfg.num_heads, cfg.head_dim),
            dtype=cfg.dtype, device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self._free = list(range(cfg.num_pages - 1, -1, -1))
        self._tables = {}  # seq_id -> list[int]
        self._lengths = {}  # seq_id -> int

    # ---- allocator ------------------------------------------------------- #
    def create(self, seq_id) -> None:
        self._tables[seq_id] = []
        self._lengths[seq_id] = 0

    def free(self, seq_id) -> None:
        self._free.extend(reversed(self._tables.pop(seq_id)))
        self._lengths.pop(seq_id)

    def _ensure(self, seq_id, new_len: int):
        need = -(-new_len // self.cfg.page_size)
        table = self._tables[seq_id]
        while len(table) < need:
            if not self._free:
                raise MemoryError("KV page pool exhausted")
            table.append(self._free.pop())
        assert len(table) <= self.cfg.max_pages_per_seq, "sequence too long"

    def block_table(self, seq_id) -> np.ndarray:
        t = self._tables[seq_id]
        out = np.zeros(self.cfg.max_pages_per_seq, np.int32)
        out[: len(t)] = t
        return out

    def length(self, seq_id) -> int:
        return self._lengths[seq_id]

    @property
    def pages_in_use(self) -> int:
        return self.cfg.num_pages - len(self._free)

    # ---- device ops ------------------------------------------------------ #
    def append(self, seq_id, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write [T, H, D] new keys/values at the sequence tail."""
        T = k_new.shape[0]
        start = self._lengths[seq_id]
        self._ensure(seq_id, start + T)
        ps = self.cfg.page_size
        pos = np.arange(start, start + T)
        page_ids = np.asarray(self._tables[seq_id], np.int64)[pos // ps]
        idx = (torch.from_numpy(page_ids).to(self.device),
               torch.from_numpy(pos % ps).to(self.device))
        for pool, new in ((self.k_pool, k_new), (self.v_pool, v_new)):
            pool.index_put_(idx, new.to(self.device, self.cfg.dtype))
        self._lengths[seq_id] = start + T


def paged_attention(
    q: torch.Tensor,  # [B, 1, H, D] one decode step per sequence
    k_pool: torch.Tensor,  # [P, page, H, D] or flat [P, page, H*D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    lengths: torch.Tensor,  # [B] valid token counts
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Ragged decode attention over paged KV. `use_kernel=None` takes the
    block-table kernel for CUDA tensors (unless
    UNILM_TPU_DISABLE_PAGED_KERNEL is set) and the gather for CPU ones;
    `use_kernel=True` on CPU tensors raises ValueError. Returns
    [B, 1, H, D]."""
    if use_kernel is None:
        use_kernel = (q.is_cuda
                      and not os.environ.get("UNILM_TPU_DISABLE_PAGED_KERNEL"))
    if use_kernel:
        if not q.is_cuda:
            raise ValueError(
                f"paged_attention(use_kernel=True): the block-table kernel "
                f"takes CUDA tensors, got q on {q.device}")
        return paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale=scale)
    B, _, H, D = q.shape
    page = k_pool.shape[1]
    tables = block_tables.long()
    k = k_pool[tables]  # [B, max_pages, page, ...]
    v = v_pool[tables]
    S = k.shape[1] * page
    k = k.reshape(B, S, H, D)
    v = v.reshape(B, S, H, D)
    mask = (torch.arange(S, device=q.device)[None]
            < lengths[:, None])[:, None, None, :]
    return dot_product_attention(q, k, v, mask=mask, scale=scale)
