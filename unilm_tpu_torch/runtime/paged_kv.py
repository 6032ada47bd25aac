"""Paged KV attention for serving (port of unilm_tpu/runtime/paged_kv.py
`paged_attention` :101).

Only the plain gather formulation is ported: each sequence's pages are
gathered into [B, max_pages*page, H, D] and masked by length. The serving
engine reaches it for an int8-KV decode step in which some slot's pages
are scattered (runtime/serving.py), as the JAX engine does. The
block-table kernel (`_paged_kernel`) and the host-side `PagePool`
allocator are not ported yet (ROADMAP Queue 2 #10).
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.ops.attention import dot_product_attention


def paged_attention(
    q: torch.Tensor,  # [B, 1, H, D] one decode step per sequence
    k_pool: torch.Tensor,  # [P, page, H, D] or flat [P, page, H*D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    lengths: torch.Tensor,  # [B] valid token counts
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Ragged decode attention over paged KV. `use_kernel=None` asks for the
    kernel on CUDA tensors, which is not ported: that raises. Returns
    [B, 1, H, D]."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        raise NotImplementedError(
            "the block-table decode kernel (_paged_kernel, "
            "unilm_tpu/ops/paged_attention.py:44) is not ported yet: ROADMAP "
            "Queue 2 #10")
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
