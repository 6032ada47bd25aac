"""Mixture-of-Experts FFN, X-MoE style (port of unilm_tpu/core/moe.py:
`_top2_gating` :31-127, `MoELayer` :130-187).

Capacity-based top-1 / top-2 routing (GShard) with dispatch and combine as
products against one-hot capacity masks, as the JAX layer computes them:

- the gate runs in float32 on x cast to float32: a plain `gate` Dense of
  E outputs, or with `cfg.moe_gate_dim > 0` xMoE's low-dimensional
  cosine routing (`gate_reduction` to gate_dim, normalised
  `gate_expert_embeddings` [E, gate_dim], a learned temperature clamped
  at 0.01);
- top-1 is the argmax of the softmax (the first index wins a tie, in
  torch as in JAX); the GShard load-balance loss is
  mean(density * density_proxy) * E^2;
- capacity is max(ceil(S * cf / E), 4) rounded up to a multiple of 8,
  then at most S (so 1 at a one-token decode), with cf =
  `moe_eval_capacity_factor` in a deterministic forward and
  `moe_capacity_factor` otherwise; queue positions come from a cumsum
  over the group's tokens, the second expert's queue continuing after
  each expert's top-1 load;
- under the "random" second-expert policy a training forward keeps the
  second expert where uniform < 2 * gate2 (the uniform from
  `draw_uniform`, which tests replace to feed JAX's draw); the top-2
  gates are renormalised with a 1e-9 guard;
- the overflow fraction counts the assignments the capacity clip dropped
  (a policy skip is no overflow).

A group is a row of the batch: routing and capacity are per row, so a
sharded batch routes exactly as one device does. `dispatch` and `combine`
are cast to x's dtype before the two products (JAX :169, :186); the
experts are one FFN with each parameter stacked on a leading E axis (flax
`nn.vmap(FeedForward)`, the tree's `experts/fc1/kernel` [E, in, out] is
`experts.fc1.weight` [E, out, in] here), in full precision under
`quant_weights` (JAX :177: only routed tokens stream an expert's
weights). The products are plain torch (`einsum`, `bmm`), as JAX leaves
them to XLA: no kernel of the repo is on this path. The gate, the
dispatch, the experts and the combine run under profiler ranges of those
names (`moe_gate`, `moe_dispatch`, `moe_experts`, `moe_combine`).

A forward is deterministic unless it is given a generator (`rng`: the
layer's training generator from the stack, core/transformer.py), the
flax layer's `deterministic` flag. It keeps its GShard loss and its
overflow fraction in `moe_aux` / `moe_overflow` (the JAX layer sows them
into `losses` / `moe_metrics`); runtime/train.py `apply_with_moe_aux`
clears them before a forward and sums them after it.

Under expert parallelism (parallel/sharding.py keeps each rank's block
of the stacked expert parameters, the mesh's `expert` axis, and calls
`MoELayer.shard_experts`) the tokens stay replicated over `expert`, so
routing, capacity and drops are the one-rank ones. Each rank dispatches
the slots of its own experts and runs them; an all-gather of the experts'
outputs over the expert group completes the combine (its backward keeps
each rank's experts' gradient), and the dispatch's input gradient is
summed over the group.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import (GATED_ACTIVATIONS, Dense, dropout,
                                         get_activation)
from unilm_tpu_torch.ops.collectives import (copy_to_group, gather_along,
                                              tensor_parallel)


def draw_uniform(shape, rng: torch.Generator, device) -> torch.Tensor:
    """The random policy's uniform [G, S] from the layer's generator (the
    flax layer's `jax.random.uniform` of its dropout key)."""
    return torch.rand(shape, generator=rng, device=device)


def is_moe_layer(cfg: TransformerConfig, layer_idx: int) -> bool:
    """Every `moe_freq`-th layer is an MoE layer (JAX `_build_ffn`)."""
    return cfg.moe_freq > 0 and (layer_idx + 1) % cfg.moe_freq == 0


def capacity(cfg: TransformerConfig, S: int, deterministic: bool) -> int:
    """Expert capacity for groups of S tokens (JAX :144-149)."""
    cf = (cfg.moe_eval_capacity_factor if deterministic
          else cfg.moe_capacity_factor)
    c = max(int(math.ceil(S * cf / cfg.moe_experts)), 4)
    c = -(-c // 8) * 8
    return min(c, S)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of int indices; an index outside [0, n) gives a row
    of zeros, as jax.nn.one_hot does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def expert_choice(logits: torch.Tensor, top2: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The experts `top2_gating` sends each token to on float32 logits
    [G, S, E]: (top-1 [G, S], top-2 [G, S] or None), each the first index
    of its largest gate."""
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    if not top2:
        return idx1, None
    gates2 = gates * (1.0 - _one_hot(idx1, logits.shape[-1]))
    return idx1, torch.argmax(gates2, dim=-1)


def top2_gating(logits: torch.Tensor, capacity: int, top2: bool,
                uniform: Optional[torch.Tensor],
                choice: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]
                = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """`_top2_gating` on float32 logits [G, S, E]: (combine [G, S, E, C]
    float32, dispatch bool, aux loss, overflow fraction). `uniform` [G, S]:
    the random policy's draw, None to keep every second expert. `choice`:
    the experts to send the tokens to, as `expert_choice` gives them
    (default: these logits' own), e.g. to replay another forward's routing
    with this one's gates."""
    G, S, E = logits.shape
    gates = torch.softmax(logits, dim=-1)

    idx1, idx2 = (expert_choice(logits, top2) if choice is None
                  else choice)
    mask1 = _one_hot(idx1, E)
    gate1 = (gates * mask1).sum(-1)

    density = mask1.mean(1)
    density_proxy = gates.mean(1)
    aux = (density * density_proxy).mean() * (E * E)

    pos1 = torch.cumsum(mask1, dim=1) * mask1 - mask1
    pos1_s = pos1.sum(-1).to(torch.int32)
    keep1 = pos1_s < capacity
    mask1 = mask1 * keep1[..., None]
    gate1 = gate1 * keep1
    slot1 = _one_hot(pos1_s, capacity)[..., None, :]

    if top2:
        mask2 = _one_hot(idx2, E)
        gate2 = (gates * mask2).sum(-1)
        if uniform is not None:
            mask2 = mask2 * (uniform < 2.0 * gate2)[..., None]
        attempted2 = mask2.sum()
        used1 = mask1.sum(1, keepdim=True)
        pos2 = (torch.cumsum(mask2, dim=1) - mask2) + used1
        pos2_s = (pos2 * mask2).sum(-1).to(torch.int32)
        keep2 = (pos2_s < capacity) & (mask2.sum(-1) > 0)
        mask2 = mask2 * keep2[..., None]
        gate2 = gate2 * keep2
        denom = gate1 + gate2
        denom = torch.where(denom > 1e-9, denom, torch.ones_like(denom))
        g1, g2 = gate1 / denom, gate2 / denom
        combine = (g1[..., None, None] * mask1[..., None] * slot1
                   + g2[..., None, None] * mask2[..., None]
                   * _one_hot(pos2_s, capacity)[..., None, :])
    else:
        combine = gate1[..., None, None] * mask1[..., None] * slot1
    dispatch = combine > 0.0

    dropped = (1.0 - keep1.float()).sum()
    attempts = torch.tensor(float(G * S), device=logits.device)
    if top2:
        dropped = dropped + (attempted2 - mask2.sum())
        attempts = attempts + attempted2
    overflow = dropped / torch.clamp(attempts, min=1.0)
    return combine, dispatch, aux, overflow


class ExpertDense(nn.Module):
    """E dense projections stacked on a leading axis: `weight` [E, out,
    in], `bias` [E, out] in cfg.param_dtype, computing x [E, N, in] in
    cfg.dtype. Initialised per expert at the xavier-uniform scale
    (core/layers.py `init_weights_`)."""

    def __init__(self, experts: int, in_features: int, out_features: int, *,
                 bias: bool, dtype, param_dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            experts, out_features, in_features, device=device,
            dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(experts, out_features,
                                              device=device,
                                              dtype=param_dtype))
                     if bias else None)
        self.tensor_split = None

    def split_over_tensor(self, kind: str, group) -> None:
        """As core/layers.py `Dense.split_over_tensor`, per expert."""
        self.tensor_split = (kind, group)

    def forward(self, x: torch.Tensor, whole: bool = True) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dt).transpose(1, 2)
        b = None if self.bias is None else self.bias.to(dt)[:, None]

        def product(xp, bp):
            y = torch.bmm(xp, w)
            return y if bp is None else y + bp

        if self.tensor_split is None:
            return product(x.to(dt), b)
        return tensor_parallel(product, x.to(dt), b, *self.tensor_split,
                               whole=whole)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        _, fan_out, fan_in = self.weight.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class ExpertNorm(nn.Module):
    """LayerNorm / RMSNorm with per-expert params [E, dim] (the vmapped
    FeedForward's `ffn_layernorm`), float32 statistics, output in the
    compute dtype."""

    def __init__(self, cfg: TransformerConfig, experts: int, dim: int,
                 device=None):
        super().__init__()
        self.rms = cfg.norm_type == "rmsnorm"
        self.eps = cfg.layernorm_eps
        self.compute_dtype = cfg.dtype
        self.weight = nn.Parameter(torch.ones(experts, dim, device=device,
                                              dtype=cfg.param_dtype))
        self.bias = (None if self.rms else nn.Parameter(torch.zeros(
            experts, dim, device=device, dtype=cfg.param_dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.rms:
            y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
            y = y * self.weight.float()[:, None]
        else:
            y = F.layer_norm(xf, (xf.shape[-1],), eps=self.eps)
            y = y * self.weight.float()[:, None] + self.bias.float()[:, None]
        return y.to(self.compute_dtype)

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()


class Experts(nn.Module):
    """E FeedForward blocks with stacked parameters (fc1, fc3 when gated,
    ffn_layernorm under subln, fc2): x [E, N, M] -> [E, N, M]."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        E, M, Fd = cfg.moe_experts, cfg.embed_dim, cfg.ffn_dim
        self.gated = cfg.activation in GATED_ACTIVATIONS
        self.act = get_activation(
            GATED_ACTIVATIONS.get(cfg.activation, cfg.activation), cfg.dtype)
        dense = lambda i, o: ExpertDense(E, i, o, bias=cfg.use_bias,
                                         dtype=cfg.dtype,
                                         param_dtype=cfg.param_dtype,
                                         device=device)
        self.fc1 = dense(M, Fd)
        if self.gated:
            self.fc3 = dense(M, Fd)
        if cfg.subln:
            self.ffn_layernorm = ExpertNorm(cfg, E, Fd, device=device)
        self.fc2 = dense(Fd, M)
        self.activation_dropout, self.dropout = (cfg.activation_dropout,
                                                 cfg.dropout)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        # as core/layers.py FeedForward: a split without the sub-LN keeps
        # the hidden as this rank's block of features
        kw = ({"whole": False} if self.fc1.tensor_split
              and not hasattr(self, "ffn_layernorm") else {})
        h = self.act(self.fc1(x, **kw))
        if self.gated:
            h = h * self.fc3(x, **kw)
        h = dropout(h, self.activation_dropout, rng)
        if hasattr(self, "ffn_layernorm"):
            h = self.ffn_layernorm(h)
        return dropout(self.fc2(h, **kw), self.dropout, rng)


class MoELayer(nn.Module):
    """Capacity-based MoE FFN: x [G, S, M] -> [G, S, M]; see the module
    docstring. Parameter names are the flax layer's: `gate` (or
    `gate_reduction`, `gate_expert_embeddings`, `gate_temperature`) and
    `experts`. `expert_group`: the process group of the mesh's `expert`
    axis when the layer runs only its block of the experts
    (`shard_experts`), else None."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if cfg.moe_experts <= 0:
            raise ValueError("an MoE layer needs cfg.moe_experts > 0")
        self.cfg = cfg
        E, M = cfg.moe_experts, cfg.embed_dim
        if cfg.moe_gate_dim > 0:
            gd = cfg.moe_gate_dim
            self.gate_reduction = Dense(M, gd, bias=False,
                                        dtype=torch.float32,
                                        param_dtype=torch.float32,
                                        device=device)
            self.gate_reduction.init_std = M ** -0.5
            self.gate_expert_embeddings = nn.Parameter(
                torch.empty(E, gd, device=device))
            self.gate_temperature = nn.Parameter(
                torch.full((), 0.07, device=device))
        else:
            self.gate = Dense(M, E, bias=False, dtype=torch.float32,
                              param_dtype=torch.float32, device=device)
            self.gate.init_std = M ** -0.5
        self.experts = Experts(cfg, device=device)
        self.expert_group = None
        self.moe_aux: Optional[torch.Tensor] = None
        self.moe_overflow: Optional[torch.Tensor] = None

    def shard_experts(self, group) -> None:
        """Run as one rank of expert parallelism over `group`: the stacked
        expert parameters now hold this rank's block of E / |group|
        experts (parallel/sharding.py)."""
        if self.cfg.moe_experts % dist.get_world_size(group):
            raise ValueError(f"{self.cfg.moe_experts} experts do not divide "
                             f"over {dist.get_world_size(group)} ranks")
        self.expert_group = group

    @torch.no_grad()
    def init_params_(self, generator: torch.Generator) -> None:
        if hasattr(self, "gate_expert_embeddings"):
            self.gate_expert_embeddings.normal_(0.0, 0.02,
                                                generator=generator)
            self.gate_temperature.fill_(0.07)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 router logits [G, S, E]."""
        xf = x.float()
        if self.cfg.moe_gate_dim <= 0:
            return self.gate(xf)
        red = self.gate_reduction(xf)
        red = red / (torch.linalg.vector_norm(red, dim=-1, keepdim=True)
                     + 1e-6)
        ee = self.gate_expert_embeddings.float()
        ee = ee / (torch.linalg.vector_norm(ee, dim=-1, keepdim=True) + 1e-6)
        temp = torch.clamp(self.gate_temperature.float(), min=0.01)
        return torch.einsum("gsd,ed->gse", red, ee) / temp

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        E = cfg.moe_experts
        G, S, M = x.shape
        deterministic = rng is None
        C = capacity(cfg, S, deterministic)
        uniform = None
        if (not deterministic and cfg.moe_top == 2
                and cfg.moe_second_expert_policy == "random"):
            uniform = draw_uniform((G, S), rng, x.device)
        with record_function("moe_gate"):
            combine, dispatch, aux, overflow = top2_gating(
                self.logits(x), C, cfg.moe_top == 2, uniform)
        self.moe_aux = aux.float()
        self.moe_overflow = overflow.detach()

        # [G, S, E*C]^T [G, S, M] -> [E, G, C, M]: each expert's slots
        d = dispatch.to(x.dtype).reshape(G, S, E, C)
        group = self.expert_group
        if group is None:
            with record_function("moe_dispatch"):
                expert_in = torch.bmm(d.reshape(G, S, E * C).transpose(1, 2),
                                      x)
                expert_in = expert_in.reshape(G, E, C, M).transpose(0, 1)
            with record_function("moe_experts"):
                expert_out = self.experts(expert_in.reshape(E, G * C, M),
                                          rng)
        else:
            # expert parallel: this rank's experts take their slots (the
            # input's gradient summed over the group), and an all-gather
            # of the experts' outputs over the group completes the combine
            n = E // dist.get_world_size(group)
            e0 = dist.get_rank(group) * n
            xd = copy_to_group(x, group)
            dl = d[:, :, e0:e0 + n].reshape(G, S, n * C)
            expert_in = torch.bmm(dl.transpose(1, 2), xd)
            expert_in = expert_in.reshape(G, n, C, M).transpose(0, 1)
            expert_out = gather_along(
                self.experts(expert_in.reshape(n, G * C, M), rng), 0, group)
        expert_out = expert_out.reshape(E, G, C, M).transpose(0, 1)
        # combine: [G, S, E*C] [G, E*C, M] -> [G, S, M]
        with record_function("moe_combine"):
            return torch.bmm(combine.to(x.dtype).reshape(G, S, E * C),
                             expert_out.reshape(G, E * C, M))
