"""LayoutLMv3's bucketed attention bias: packed bucket planes, the dense
lookup, and the shared-table gradient collector (port of
unilm_tpu/ops/bucket_bias.py: `pack_bucket_planes` :76, `unpack_field` :85,
`materialize_bias` :89 and `bias_grad_collector` :127 with its VJP
`_collector_bwd` :147).

The 1D + 2D relative bias (modeling_layoutlmv3.py:507-577, added to the
logits as (rel_pos + rel_2d_pos) / sqrt(d) at :318-321) is a function of
up to three [B, T, S] planes of bucket ids (< 64 each), packed 6 bits a
field into one int32 plane, and three learned [nb, H] tables.

- `materialize_bias`: the dense bias, scale folded into the tables first
  and the per-table planes summed in the output dtype, as in JAX. JAX
  writes the lookup as a one-hot matrix product because a gather runs on
  the TPU's scalar path; here it is a gather (`table[:, f]`), which the GPU
  runs at memory speed. The bias comes out [H, B|1, T, S], the order the
  doc kernels read through `HeadMajorBias` (whose `bhts()` is the
  [B|1, H, T, S] view, no copy).
- `bias_grad_collector`: every encoder layer adds the same bias, so the
  tables' gradient is one contraction of the layer-summed logit gradient.
  JAX builds it from a stop-gradient dense bias plus a zero tensor whose
  custom VJP does that contraction; torch's autograd already sums a shared
  tensor's gradient over its uses, so here one `torch.autograd.Function`
  does both: its forward is `materialize_bias`, its backward
  `_collector_bwd`'s contraction, a one-hot product taken in chunks of
  `CHUNK` positions (deterministic; no scatter-add, no atomics).
"""

from __future__ import annotations

from typing import Sequence

import torch

FIELD_BITS = 6  # up to 64 buckets per table
FIELD_MASK = (1 << FIELD_BITS) - 1
MAX_TABLES = 3
CHUNK = 1 << 19  # positions per one-hot block of the table contraction


def pack_bucket_planes(*planes: torch.Tensor) -> torch.Tensor:
    """Pack up to 3 int bucket planes (values < 64) into one int32 plane."""
    if not 1 <= len(planes) <= MAX_TABLES:
        raise ValueError(f"pack_bucket_planes takes 1 to {MAX_TABLES} planes, "
                         f"got {len(planes)}")
    out = planes[0].to(torch.int32)
    for t, p in enumerate(planes[1:], start=1):
        out = out | (p.to(torch.int32) << (FIELD_BITS * t))
    return out


def unpack_field(packed: torch.Tensor, t: int) -> torch.Tensor:
    return (packed >> (FIELD_BITS * t)) & FIELD_MASK


def materialize_bias(packed: torch.Tensor, tables: Sequence[torch.Tensor],
                     scale: float, dtype) -> torch.Tensor:
    """Dense bias [H, B|1, T, S] from packed [B|1, T, S] bucket planes and
    [nb, H] tables: sum_t (table_t * scale)[f_t] in `dtype` (the JAX
    function's layout "hbts")."""
    bias = None
    for t, table in enumerate(tables):
        f = unpack_field(packed, t).long()
        g = (table.t() * scale).to(dtype)[:, f]  # [H, B, T, S]
        bias = g if bias is None else bias + g
    return bias


def _collector_bwd(g: torch.Tensor, packed: torch.Tensor, tables,
                   scale: float):
    """The tables' gradients from the summed logit gradient g [H, B, T, S]:
    per table, dtable[n, h] = scale * sum of g[h, p] over the positions p
    whose bucket is n, as a one-hot product in fp32, CHUNK positions at a
    time."""
    H, B = g.shape[0], g.shape[1]
    if packed.shape[0] == 1 and B > 1:
        g = g.float().sum(1, keepdim=True)
    gf = g.reshape(H, -1)
    dtables = []
    for t, table in enumerate(tables):
        nb = table.shape[0]
        f = unpack_field(packed, t).reshape(-1)
        ids = torch.arange(nb, device=f.device, dtype=f.dtype)
        acc = torch.zeros(H, nb, dtype=torch.float32, device=g.device)
        for a in range(0, f.numel(), CHUNK):
            oh = (f[a:a + CHUNK, None] == ids).to(torch.float32)  # [n, nb]
            acc += gf[:, a:a + CHUNK].float() @ oh
        dtables.append((acc.t() * scale).to(table.dtype))
    return dtables


class BiasGradCollector(torch.autograd.Function):
    """`materialize_bias` whose backward is the single table contraction
    (`bias_grad_collector`)."""

    @staticmethod
    def forward(ctx, packed, scale, dtype, *tables):
        ctx.save_for_backward(packed, *tables)
        ctx.scale = scale
        return materialize_bias(packed, tables, scale, dtype)

    @staticmethod
    def backward(ctx, g):
        packed, *tables = ctx.saved_tensors
        dtables = _collector_bwd(g, packed, tables, ctx.scale)
        return (None, None, None, *dtables)


def bias_grad_collector(tables: Sequence[torch.Tensor], packed: torch.Tensor,
                        scale: float, dtype) -> torch.Tensor:
    """The dense [H, B|1, T, S] bias of `materialize_bias`, differentiable
    in `tables` through one one-hot contraction of its (layer-summed)
    gradient."""
    return BiasGradCollector.apply(packed, float(scale), dtype, *tables)
