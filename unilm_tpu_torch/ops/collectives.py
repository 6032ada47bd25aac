"""Differentiable collectives over a process group, for the layers that
split their work over ranks (core/moe.py's expert parallelism, the
tensor-parallel products of core/layers.py `Dense` and core/moe.py
`ExpertDense`, parallel/).

Every function here assumes the SPMD contract of those layers: the ranks
of `group` run the same program on the same rows, so a tensor that every
rank computes whole carries the same gradient on every rank.

- `gather_along(x, dim, group)`: the ranks' tensors concatenated along
  `dim`; the backward keeps this rank's slice of the gradient.
- `copy_to_group(x, group)`: the identity; the backward sums the gradient
  over the group (each rank's part of a product split over the group).
- `tensor_parallel(product, x, bias, kind, group, whole)`: one rank's
  part of a column- or row-parallel projection (Megatron-LM's split):
  "column" runs `product` on the rank's block of output features and,
  with `whole`, all-gathers them; "row" runs it on the rank's block of
  the input features (with `whole`, its slice of a whole input, the
  backward gathering the slices' gradients) and sums the partial
  products over the group (the backward passes the gradient through),
  adding the bias once. A column projection without `whole` feeding a
  row projection without `whole` is Megatron's pair: one all-reduce.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim)[r].contiguous()


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _LocalSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Gather.apply(x, dim, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def tensor_parallel(product, x: torch.Tensor, bias, kind: str, group,
                    whole: bool = True) -> torch.Tensor:
    """`product(x_part, bias_part)` is the projection with this rank's
    block of the weight (and, for "column", of the bias; "row" passes
    None and adds the whole `bias` after the sum). `whole`: the column's
    output / the row's input holds every feature, else this rank's
    block of them."""
    if kind == "column":
        y = product(copy_to_group(x, group), bias)
        return gather_along(y, -1, group) if whole else y
    if kind != "row":
        raise ValueError(f"tensor-parallel kind {kind!r}: column or row")
    if whole:
        x = _LocalSlice.apply(x, -1, group)
    y = _ReduceFromGroup.apply(product(x, None), group)
    return y if bias is None else y + bias
