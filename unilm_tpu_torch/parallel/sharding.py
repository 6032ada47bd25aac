"""Parameter sharding over the mesh (port of unilm_tpu/parallel/sharding.py:
`_rule` :33-112, `infer_param_shardings` :115, `batch_sharding` :121,
`replicated` :129).

`_rule` is JAX's, decision for decision, on the flax path and shape of a
parameter: column-parallel kernels (q/k/v/fc1/fc3) put their OUT dim on
`tensor`, row-parallel kernels (out_proj/fc2) their IN dim; everything
else with two or more dims puts its largest divisible dim on `fsdp`;
stacked expert parameters put their leading expert dim on `expert`;
pipeline-stacked parameters their stage dim on `stage`; vectors stay
replicated. `param_specs` applies it to the port's parameters: each one's
flax path and shape come from its module (a Dense `weight` [out, in] is
the flax `kernel` [in, out], an expert weight [E, out, in] is [E, in,
out], a Conv2d OIHW weight is HWIO, a norm's `weight` is its `scale`, an
embedding's `weight` its `embedding`; `layers.{i}` is `layers_{i}`), and
the decision comes back on torch's dims. `infer_param_shardings` turns
each into DTensor placements (one per mesh dim, `Shard(d)` or
`Replicate()`).

`shard_parameters` applies them. The batch is sharded over data x fsdp
only (`batch_shard`), so the ranks of a `tensor` or `expert` group see the
same rows:

- over data x fsdp, for training, FSDP2 `fully_shard` (`fully_shard_over`,
  HSDP on the 2-D data x fsdp mesh) holds each parameter as a DTensor
  split on the rule's fsdp dim (on its first dim where the rule keeps it
  whole: FSDP2 splits every parameter it holds), gathers a layer's
  parameters where it runs and reduce-scatters their gradients, averaged
  over data x fsdp, in the backward;
- over `tensor` the projections keep their block of the weight and
  compute their part of the product (core/layers.py
  `Dense.split_over_tensor`, Megatron-LM's split, JAX's GSPMD under the
  same rule): a column-parallel q/k/v/fc1/fc3 (out dim on `tensor`)
  projects onto its block of features, a row-parallel out_proj/fc2 (in
  dim) multiplies its block of the input and an all-reduce sums the
  parts. Self-attention in training attends over the rank's block of
  heads (core/attention.py `heads_group`), and the FFN's activation runs
  on its block of features; an all-gather joins the blocks only before a
  norm over every feature (the sub-LN `inner_attn_ln` /
  `ffn_layernorm`), which then runs whole on every rank, as does the
  generation path's attention;
- over `expert` a rank keeps and runs only its experts (core/moe.py
  `MoELayer.shard_experts`), and an all-gather of their outputs over the
  expert group completes the combine.

The returned `GradSync` (for `make_train_step(grad_sync=...)`) takes the
global norm of the shards, each counted once; FSDP2 has already reduced
the gradients. So every layout gives the one-rank numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from unilm_tpu_torch.parallel.mesh import MESH_AXES, axis_size

COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "fc1", "fc3", "query",
                   "key", "value")
ROW_PARALLEL = ("out_proj", "fc2")


def _rule(path: Tuple[str, ...], shape: Tuple[int, ...],
          sizes: Dict[str, int]) -> Tuple[Optional[str], ...]:
    """JAX `_rule` over axis sizes: the mesh axis (or None) of each dim of
    the flax leaf `path` of `shape`."""
    names = list(path)
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    in_expert = any(n == "experts" for n in names)
    size = lambda a: sizes.get(a, 1)
    tp = size("tensor") > 1
    fsdp = size("fsdp") > 1
    ep = size("expert") > 1 and in_expert

    def maybe(axis, dim):
        return axis if shape[dim] % size(axis) == 0 else None

    if any(n == "stages" for n in names) and len(shape) >= 2:
        spec = [None] * len(shape)
        if size("stage") > 1 and shape[0] % size("stage") == 0:
            spec[0] = "stage"
        if fsdp and len(shape) > 2:
            for dim in sorted(range(2, len(shape)), key=lambda d: -shape[d]):
                if shape[dim] % size("fsdp") == 0 and shape[dim] > 1:
                    spec[dim] = "fsdp"
                    break
        return tuple(spec)

    offset = 1 if in_expert else 0
    spec = [None] * len(shape)
    if in_expert and ep and shape[0] % size("expert") == 0:
        spec[0] = "expert"

    if leaf == "kernel" and len(shape) == 2 + offset:
        i, o = offset, offset + 1
        if tp and parent in COLUMN_PARALLEL:
            spec[o] = maybe("tensor", o)
            if fsdp:
                spec[i] = maybe("fsdp", i)
        elif tp and parent in ROW_PARALLEL:
            spec[i] = maybe("tensor", i)
            if fsdp:
                spec[o] = maybe("fsdp", o)
        elif fsdp:
            dim = i if shape[i] >= shape[o] else o
            spec[dim] = maybe("fsdp", dim)
            if spec[dim] is None:
                other = o if dim == i else i
                spec[other] = maybe("fsdp", other)
    elif leaf in ("embedding",) and len(shape) == 2:
        if fsdp:
            spec[0] = maybe("fsdp", 0)
            if spec[0] is None:
                spec[1] = maybe("fsdp", 1)
    elif leaf == "kernel" and len(shape) == 4:
        if fsdp:
            spec[3] = maybe("fsdp", 3)
            if spec[3] is None:
                spec[2] = maybe("fsdp", 2)
    elif (leaf == "bias" and len(shape) == 1 + offset and tp
          and parent in COLUMN_PARALLEL):
        spec[offset] = maybe("tensor", offset)
    if fsdp and len(shape) >= 2 and all(s is None for s in spec):
        for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[dim] % size("fsdp") == 0 and shape[dim] > 1:
                spec[dim] = "fsdp"
                break
    return tuple(spec)


def flax_view(module: nn.Module, pname: str, shape) -> Tuple[str, tuple,
                                                              tuple]:
    """(flax leaf name, flax shape, torch dim of each flax dim or None) of
    parameter `pname` of `module` (convert/from_jax.py in reverse)."""
    from unilm_tpu_torch.core.embedding import (PatchProjection,
                                                PositionalEmbedding)
    from unilm_tpu_torch.core.layers import Dense, Norm
    from unilm_tpu_torch.core.moe import ExpertDense, ExpertNorm

    shape = tuple(shape)
    if pname != "weight":
        return pname, shape, tuple(range(len(shape)))
    if isinstance(module, (nn.Embedding, PositionalEmbedding)):
        return "embedding", shape, (0, 1)
    if (isinstance(module, (Norm, ExpertNorm, nn.LayerNorm, nn.GroupNorm))
            or len(shape) == 1):
        return "scale", shape, tuple(range(len(shape)))
    if isinstance(module, PatchProjection):
        p = module.patch_size
        # [E, p*p*C] is the flax [p, p, C, E] flattened: only E maps
        return "kernel", (p, p, shape[1] // (p * p), shape[0]), (
            None, None, None, 0)
    if isinstance(module, ExpertDense):
        return "kernel", (shape[0], shape[2], shape[1]), (0, 2, 1)
    if isinstance(module, nn.Conv2d) or len(shape) == 4:
        o, i, kh, kw = shape
        return "kernel", (kh, kw, i, o), (2, 3, 1, 0)
    if isinstance(module, (Dense, nn.Linear)) or len(shape) == 2:
        return "kernel", (shape[1], shape[0]), (1, 0)
    return "weight", shape, tuple(range(len(shape)))


def _flax_path(module_name: str) -> Tuple[str, ...]:
    parts = module_name.split(".") if module_name else []
    out = []
    for i, p in enumerate(parts):
        if p.isdigit() and out and out[-1] == "layers":
            out[-1] = f"layers_{p}"
        else:
            out.append(p)
    return tuple(out)


def param_specs(model: nn.Module, sizes: Dict[str, int]
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The mesh axis (or None) of each dim, on torch's layout, of every
    parameter of `model` under axis `sizes`."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            leaf, fshape, to_torch = flax_view(mod, pname, p.shape)
            fspec = _rule(_flax_path(mname) + (leaf,), fshape, sizes)
            spec = [None] * p.dim()
            for fd, axis in enumerate(fspec):
                if axis is not None and to_torch[fd] is not None:
                    spec[to_torch[fd]] = axis
            out[f"{mname}.{pname}" if mname else pname] = tuple(spec)
    return out


def mesh_sizes_of(mesh) -> Dict[str, int]:
    return {a: axis_size(mesh, a) for a in MESH_AXES}


def infer_param_shardings(model: nn.Module, mesh) -> Dict[str, list]:
    """DTensor placements of every parameter of `model` on `mesh` (one a
    mesh dim: `Shard(torch dim)` or `Replicate()`)."""
    from torch.distributed.tensor import Replicate, Shard

    specs = param_specs(model, mesh_sizes_of(mesh))
    names = mesh.mesh_dim_names
    out = {}
    for n, spec in specs.items():
        pl = [Replicate()] * len(names)
        for d, axis in enumerate(spec):
            if axis is not None:
                pl[names.index(axis)] = Shard(d)
        out[n] = pl
    return out


def batch_shard(mesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch sharded over data x fsdp (JAX
    `batch_sharding`): the ranks of the other axes take the same rows."""
    n = axis_size(mesh, "data") * axis_size(mesh, "fsdp")
    if n == 1:
        return batch
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    i = (coord[names.index("data")] * axis_size(mesh, "fsdp")
         + coord[names.index("fsdp")])
    rows = batch.shape[0] // n
    return batch[i * rows:(i + 1) * rows]


class GradSync:
    """The `make_train_step(grad_sync=)` of a model spread over a mesh:
    the gradients of plain parameters averaged over data x fsdp (FSDP2
    already averaged those of its DTensor parameters in the backward), and
    the global norm with each rank's local shard counted once over the
    `copies` ranks that hold the same one."""

    def __init__(self, mesh, copies: List[float]):
        self.mesh = mesh
        self.copies = copies  # one a trainable parameter (train.trainable)
        self.n_batch = axis_size(mesh, "data") * axis_size(mesh, "fsdp")

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        from torch.distributed.tensor import DTensor

        if self.n_batch == 1:
            return
        groups = [self.mesh.get_group(a) for a in ("data", "fsdp")
                  if axis_size(self.mesh, a) > 1]
        for g in grads:
            if isinstance(g, DTensor):
                continue
            for group in groups:
                dist.all_reduce(g, group=group)
            g.div_(self.n_batch)

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        sq = sum((g.to_local() if isinstance(g, DTensor) else g)
                 .float().pow(2).sum() / c
                 for g, c in zip(grads, self.copies))
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(sq)
        return torch.sqrt(sq)


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules FSDP2 gathers one at a time: each element of a
    ModuleList named `layers`, then the model itself."""
    units = [m for n, lst in model.named_modules()
             if isinstance(lst, nn.ModuleList) and n.rsplit(".", 1)[-1]
             == "layers" for m in lst]
    return units + [model]


def fully_shard_over(model: nn.Module, dp_mesh,
                     placement: Dict[int, int]) -> None:
    """FSDP2 `fully_shard` of `fsdp_units(model)` over `dp_mesh` (1-D:
    fsdp; 2-D: data x fsdp, HSDP), each parameter split on the dim
    `placement[id(param)]` (default 0; FSDP2 shards every parameter it
    holds, padding an uneven dim)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def place(p):
        return Shard(placement.get(id(p), 0))

    for unit in fsdp_units(model):
        fully_shard(unit, mesh=dp_mesh, shard_placement_fn=place)


def shard_parameters(model: nn.Module, mesh, training: bool = True
                     ) -> GradSync:
    """Place each parameter of `model` under `infer_param_shardings` (see
    the module docstring): the projections with a dim on `tensor` and the
    MoE experts on `expert` keep this rank's block and compute their part,
    and for training FSDP2 shards every parameter over data x fsdp. A
    model only served (`training=False`) keeps its whole parameters over
    data and fsdp, which change nothing in a forward. The model's weights
    must already be the same on every rank (the same init seed or
    checkpoint). Returns the GradSync for make_train_step."""
    sizes = mesh_sizes_of(mesh)
    specs = param_specs(model, sizes)
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    world = math.prod(sizes.values())
    placement, copies = {}, {}
    for mname, mod in list(model.named_modules()):
        split = None
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mname}.{pname}" if mname else pname
            spec = specs[name]
            blocks = [(d, a) for d, a in enumerate(spec)
                      if a in ("tensor", "expert")]
            if "tensor" in spec and pname == "weight":
                # [.., out, in]: out on tensor is a column split, in a row
                split = ("column" if spec.index("tensor") == p.dim() - 2
                         else "row")
            if blocks:
                idx = [slice(None)] * p.dim()
                for d, axis in blocks:
                    step = p.shape[d] // sizes[axis]
                    i = coord[names.index(axis)]
                    idx[d] = slice(i * step, (i + 1) * step)
                p = nn.Parameter(p.detach()[tuple(idx)].contiguous())
                setattr(mod, pname, p)
            if "fsdp" in spec:
                placement[id(p)] = spec.index("fsdp")
            # the ranks that hold this rank's block of the parameter
            copies[name] = world / math.prod(sizes[a] for _, a in blocks)
        if split is not None:
            if not hasattr(mod, "split_over_tensor"):
                raise NotImplementedError(
                    f"{mname} ({type(mod).__name__}) has parameters on the "
                    "tensor axis but no tensor-parallel product")
            mod.split_over_tensor(split, mesh.get_group("tensor"))
    if sizes["expert"] > 1:
        for m in model.modules():
            if hasattr(m, "shard_experts"):
                m.shard_experts(mesh.get_group("expert"))
    F_ = 1
    if training and sizes["data"] * sizes["fsdp"] > 1:
        fully_shard_over(model, mesh["data", "fsdp"], placement)
        F_ = sizes["fsdp"]
    return GradSync(mesh, [copies[n] / F_ for n, p
                           in model.named_parameters() if p.requires_grad])


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * len(mesh.mesh_dim_names)
