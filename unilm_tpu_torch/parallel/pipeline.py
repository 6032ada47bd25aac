"""Pipeline parallelism: a GPipe schedule over the mesh's `stage` axis
(port of unilm_tpu/parallel/pipeline.py: `pipeline_apply` :40-105,
`PipelineLM` :108-213, `PipelineGPT` :216-408, `stack_stage_params` :411).

Layers are split into S stages, one a rank of the stage group; each rank
holds only its stage's layers. `pipeline_apply` runs M microbatches
through them: stage s takes microbatch m after stage s - 1 has sent it
(`dist.send` / `dist.recv` between neighbouring stage ranks, inside
autograd functions, so the backward sends each microbatch's gradient
back the other way). The schedule is GPipe's S + M - 1 ticks: stage s
runs microbatch m at tick s + m. JAX's SPMD program computes every stage
at every tick and masks the bubble ticks to zero; here a rank waits
through its bubble ticks instead, which gives the same outputs and
gradients. The last stage's outputs are broadcast to every stage rank
(JAX's psum of the masked outputs), so the loss is computed alike on
every rank. The backward is the sequential one: every rank runs its
microbatches' backward in reverse order, autograd's order here.

`PipelineLM` is JAX's v1 workload (uniform dense DecoderLayers, tied
embeddings, its own final LayerNorm `ln_f`); `PipelineGPT` runs UniGPT's
text path (scaled embedding, sinusoidal positions, the subln / xPos
layer stack, the final `layer_norm`, the tied head) and converts UniGPT
parameters in and out (`from_unigpt` / `to_unigpt`); with `fsdp_axis`
each stage's parameters are sharded over that axis by FSDP2 (ZeRO-3;
weight matrices on their out dim, JAX's last flax dim), gathered where a
layer runs, and the microbatch rows are split over it. Both take dense layers only, as JAX
asserts. `grad_sync` (for `make_train_step`) averages the gradients over
the fsdp rows and takes the norm over the stages' parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unilm_tpu_torch.core.attention import xpos_inputs
from unilm_tpu_torch.core.layers import make_norm
from unilm_tpu_torch.core.transformer import DecoderLayer
from unilm_tpu_torch.ops.collectives import copy_to_group


def _peer(group, rank_in_group: int) -> int:
    return dist.get_global_rank(group, rank_in_group)


class _Recv(torch.autograd.Function):
    """Receive a tensor from stage `src`; the backward sends its gradient
    back. `anchor` (a scalar that requires grad) puts the receive in the
    graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, group):
        ctx.src, ctx.group = src, group
        x = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(x, _peer(group, src), group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), _peer(ctx.group, ctx.src), group=ctx.group)
        return None, None, None, None, None


class _Send(torch.autograd.Function):
    """Send a tensor to stage `dst`; returns a scalar token for the loss to
    depend on, whose backward receives the tensor's gradient from `dst`."""

    @staticmethod
    def forward(ctx, x, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.shape, ctx.dtype = x.shape, x.dtype
        dist.send(x.contiguous(), _peer(group, dst), group=group)
        return torch.zeros((), device=x.device, dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype,
                        device=_.device)
        dist.recv(g, _peer(ctx.group, ctx.dst), group=ctx.group)
        return g, None, None


class _Broadcast(torch.autograd.Function):
    """The source stage's tensor on every stage rank; every rank computes
    the same loss from it, so the backward keeps the source's own
    gradient (JAX's psum of the masked outputs)."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.is_src = dist.get_rank(group) == src
        x = x.contiguous().clone()
        dist.broadcast(x, _peer(group, src), group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   microbatches: torch.Tensor, *, group,
                   remat: bool = False) -> torch.Tensor:
    """Run `stage_fn` (this rank's stage) over microbatches [M, mb, ...]
    along the stage group's ranks in order; returns the last stage's
    outputs [M, mb, ...] on every stage rank. Differentiable; `remat`
    recomputes each stage call in the backward (GPipe's per-microbatch
    checkpointing)."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    M = microbatches.shape[0]
    if remat:
        fn = lambda h: checkpoint(stage_fn, h, use_reentrant=False)
    else:
        fn = stage_fn
    anchor = microbatches.new_zeros((), dtype=torch.float32,
                                    requires_grad=True)
    outs, tokens = [], []
    for m in range(M):  # stage s runs microbatch m at tick s + m
        inject = microbatches[m]
        if s == 0:
            h = inject
        else:
            h = _Recv.apply(anchor, inject.shape, inject.dtype, s - 1, group)
            # stage 0's input enters every stage's graph (JAX's where), so
            # the embedding's gradient collective runs on every rank
            h = h + 0.0 * inject
        h = fn(h)
        if s < S - 1:
            tokens.append(_Send.apply(h, s + 1, group))
        outs.append(h)
    out = torch.stack(outs) if s == S - 1 else microbatches.new_zeros(
        (M,) + tuple(outs[0].shape), dtype=outs[0].dtype)
    if tokens:
        # the sends' gradients: received in the backward, nothing added
        out = out + 0.0 * torch.stack(tokens).sum().to(out.dtype)
    return _Broadcast.apply(out, S - 1, group)


def stack_stage_params(params_per_layer: List[Dict[str, torch.Tensor]],
                       num_stages: int) -> Dict[str, torch.Tensor]:
    """[L] per-layer state dicts -> one dict whose tensors carry leading
    [num_stages, L / num_stages] dims (JAX's stage-stacked tree)."""
    L = len(params_per_layer)
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible into {num_stages} "
                         "stages")
    per = L // num_stages
    return {k: torch.stack([p[k] for p in params_per_layer]).reshape(
        (num_stages, per) + tuple(params_per_layer[0][k].shape))
        for k in params_per_layer[0]}


class _Stage(nn.Module):
    """This rank's layers (`layers`, L / S DecoderLayers)."""

    def __init__(self, cfg, per: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, layer_idx=0, device=device)
             for _ in range(per)])

    def forward(self, h, xpos):
        for layer in self.layers:
            h = layer(h, mode="train", causal=True, xpos=xpos)
        return h


class _Pipelined(nn.Module):
    """Shared machinery of PipelineLM / PipelineGPT."""

    def _setup(self, tcfg, num_stages, mesh, num_microbatches, axis_name,
               remat, fsdp_axis, device):
        if tcfg.num_layers % num_stages:
            raise ValueError(f"{tcfg.num_layers} layers not divisible into "
                             f"{num_stages} stages")
        if tcfg.moe_freq:
            raise ValueError("pipeline parallelism takes dense layers only "
                             "(moe_freq == 0), as the JAX module asserts")
        self.tcfg = tcfg
        self.S, self.M = num_stages, num_microbatches
        self.mesh, self.axis_name, self.remat = mesh, axis_name, remat
        self.fsdp_axis = fsdp_axis
        self.group = mesh.get_group(axis_name)
        if dist.get_world_size(self.group) != num_stages:
            raise ValueError(f"the {axis_name} axis has "
                             f"{dist.get_world_size(self.group)} ranks, not "
                             f"{num_stages} stages")
        self.stage_index = dist.get_rank(self.group)
        self.per = tcfg.num_layers // num_stages
        self.stage = _Stage(tcfg, self.per, device=device)

    def shard_stage(self):
        """ZeRO-3 of the stage over `fsdp_axis`: FSDP2 splits each stage
        weight matrix on its out dim (JAX `_fsdp_sharded`: the flax
        kernel's last dim) and every other stage parameter on its first,
        gathered layer by layer where the stage reads them."""
        from unilm_tpu_torch.parallel.sharding import fully_shard_over

        if self.fsdp_axis is None:
            return
        fully_shard_over(self.stage, self.mesh[self.fsdp_axis], {})

    def grad_sync(self):
        """`make_train_step(grad_sync=)`: stage params live on their stage
        (averaged over the fsdp rows by FSDP2 when sharded), the embedding
        and final norm on every rank."""
        from unilm_tpu_torch.parallel.sharding import GradSync

        world = dist.get_world_size()
        F_ = (1 if self.fsdp_axis is None
              else dist.get_world_size(self.mesh.get_group(self.fsdp_axis)))
        stage_ids = {id(p) for p in self.stage.parameters()}
        return GradSync(self.mesh, [world / self.S / F_ if id(p) in stage_ids
                                    else float(world)
                                    for p in self.parameters()
                                    if p.requires_grad])

    def _embed_grad_over_stages(self, h):
        """The embedding output's gradient summed over the stage group
        (only stage 0's graph reads it for the pipeline input)."""
        return copy_to_group(h, self.group)

    def rows_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """A per-rows loss as the mean over the fsdp ranks' rows (its
        value; the gradient stays this rank's part, which `grad_sync`
        averages)."""
        if self.fsdp_axis is None:
            return loss
        tot = loss.detach().clone()
        dist.all_reduce(tot, group=self.mesh.get_group(self.fsdp_axis))
        tot /= dist.get_world_size(self.mesh.get_group(self.fsdp_axis))
        return loss + (tot - loss.detach())

    def _rows(self, tokens):
        if self.fsdp_axis is None:
            return tokens
        fg = self.mesh.get_group(self.fsdp_axis)
        n, r = dist.get_world_size(fg), dist.get_rank(fg)
        rows = tokens.shape[0] // n
        return tokens[r * rows:(r + 1) * rows]

    def apply_layers(self, h: torch.Tensor) -> torch.Tensor:
        """[M, mb, T, E] microbatched hidden states -> the same,
        pipelined over the stages."""
        T = h.shape[2]
        cfg = self.tcfg
        xpos = (xpos_inputs(cfg, 0, T, h.device) if cfg.xpos_rel_pos
                else None)
        return pipeline_apply(lambda x: self.stage(x, xpos), h,
                              group=self.group, remat=self.remat)


class PipelineLM(_Pipelined):
    """A decoder-only LM whose uniform dense DecoderLayers run pipelined
    over `mesh`'s `axis_name` (JAX `PipelineLM`): `embed_tokens` [V, E]
    (tied head), this rank's `stage.layers`, and `ln_f` (LayerNorm, eps
    1e-5, float32 statistics)."""

    def __init__(self, cfg, num_stages: int, mesh, num_microbatches: int,
                 axis_name: str = "stage", remat: bool = False, device=None):
        super().__init__()
        self._setup(cfg, num_stages, mesh, num_microbatches, axis_name,
                    remat, None, device)
        E = cfg.embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=device,
                                         dtype=cfg.dtype)
        self.ln_f_scale = nn.Parameter(torch.ones(E, device=device))
        self.ln_f_bias = nn.Parameter(torch.zeros(E, device=device))

    def load_stages(self, stacked: Dict[str, torch.Tensor]) -> None:
        """Load this rank's layers from `stack_stage_params`'s dict."""
        s = self.stage_index
        for i, layer in enumerate(self.stage.layers):
            layer.load_state_dict({k: v[s, i] for k, v in stacked.items()})

    def _ln_f(self, x):
        xf = x.float()
        y = F.layer_norm(xf, (xf.shape[-1],), eps=1e-5)
        return (y * self.ln_f_scale + self.ln_f_bias).to(x.dtype)

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.tcfg
        B, T = tokens.shape
        if B % self.M:
            raise ValueError(f"batch {B} not divisible into {self.M} "
                             "microbatches")
        emb = self.embed_tokens.weight
        h = self._embed_grad_over_stages(emb[tokens.long()]
                                         * cfg.embed_dim ** 0.5)
        h = self.apply_layers(h.reshape(self.M, B // self.M, T, -1))
        h = self._ln_f(h.reshape(B, T, -1))
        return torch.matmul(h.float(), emb.float().t())


class PipelineGPT(_Pipelined):
    """UniGPT's text path with its layer stack pipelined (JAX
    `PipelineGPT`): `embed_tokens`, this rank's `stage.layers`, the final
    `layer_norm`; with `fsdp_axis`, ZeRO-3 stage matrices and microbatch
    rows split over that axis (`features` takes the whole batch and uses
    this rank's rows)."""

    def __init__(self, cfg, num_stages: int, mesh, num_microbatches: int,
                 axis_name: str = "stage", remat: bool = False,
                 fsdp_axis: Optional[str] = None, device=None):
        super().__init__()
        from unilm_tpu_torch.models.kosmos import sinusoidal_table

        tcfg = cfg.decoder_cfg()
        self.cfg = cfg
        self._setup(tcfg, num_stages, mesh, num_microbatches, axis_name,
                    remat, fsdp_axis, device)
        E = cfg.embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E, device=device,
                                         dtype=cfg.param_dtype)
        if tcfg.normalize_before:
            self.layer_norm = make_norm(tcfg, device=device)
        if cfg.use_positional:
            table = sinusoidal_table(cfg.max_positions + cfg.padding_idx + 1,
                                     E, cfg.padding_idx)
            self.register_buffer("pos_table",
                                 torch.from_numpy(table).to(device),
                                 persistent=False)

    def from_unigpt(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a UniGPT state_dict: this rank's stage layers
        (decoder.layers.{s L/S + i}), the embedding, the final norm. Call
        before `shard_stage`."""
        s, per = self.stage_index, self.per
        own = {"embed_tokens.weight": sd["embed_tokens.weight"]}
        if hasattr(self, "layer_norm"):
            own["layer_norm.weight"] = sd["decoder.layer_norm.weight"]
            own["layer_norm.bias"] = sd["decoder.layer_norm.bias"]
        for i in range(per):
            pre = f"decoder.layers.{s * per + i}."
            for k, v in sd.items():
                if k.startswith(pre):
                    own[f"stage.layers.{i}.{k[len(pre):]}"] = v
        self.load_state_dict(own, strict=True)

    def to_unigpt(self) -> Dict[str, torch.Tensor]:
        """This rank's part of a UniGPT state_dict (the inverse of
        `from_unigpt`; the stage ranks' parts together are the whole).
        Sharded parameters are gathered, so every fsdp rank calls it."""
        from torch.distributed.tensor import DTensor

        s, per = self.stage_index, self.per
        out = {}
        for name, p in self.named_parameters():
            t = p.full_tensor() if isinstance(p, DTensor) else p
            if name.startswith("stage.layers."):
                i, rest = name[len("stage.layers."):].split(".", 1)
                name = f"decoder.layers.{s * per + int(i)}.{rest}"
            elif name.startswith("layer_norm."):
                name = f"decoder.{name}"
            out[name] = t.detach()
        return out

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows' pre-logit decoder output [rows, T, E] (UniGPT
        `return_features=True`)."""
        cfg, tcfg = self.cfg, self.tcfg
        tokens = self._rows(tokens)
        B, T = tokens.shape
        if B % self.M:
            raise ValueError(f"{B} rows not divisible into {self.M} "
                             "microbatches")
        h = self.embed_tokens.weight[tokens.long()].to(tcfg.dtype)
        if cfg.scale_embedding:
            h = h * cfg.embed_dim ** 0.5
        if cfg.use_positional:
            pos = torch.arange(T, device=h.device) + cfg.padding_idx + 1
            h = h + self.pos_table[pos][None].to(h.dtype)
        h = self._embed_grad_over_stages(h)
        h = self.apply_layers(h.reshape(self.M, B // self.M, T, -1))
        h = h.reshape(B, T, -1)
        if tcfg.normalize_before:
            h = self.layer_norm(h)
        return h

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.features(tokens)
        return torch.matmul(h.float(),
                            self.embed_tokens.weight.float().t())
