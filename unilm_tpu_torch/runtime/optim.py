"""Optimizers and learning-rate schedules (port of
unilm_tpu/runtime/optim.py: `beit_layer_id` :27, `layer_decay_scales` :42,
`weight_decay_mask` :67, `cosine_schedule` :90,
`polynomial_decay_schedule` :99, `inverse_sqrt_schedule` :110 and every
branch of `create_optimizer` :130-173).

The JAX package builds these from optax; here each is written out with
optax's arithmetic and count semantics, so that the same gradients give
the same parameters:

- a schedule is a function of the update count BEFORE the update (optax's
  `scale_by_schedule`), so the first update of a warmup schedule has lr 0;
- `AdamW` is `optax.adamw`: bias-corrected moments, eps outside the
  square root, decoupled weight decay (on every parameter when `mask` is
  None), then the layer-decay scale (BEiT's layer-wise LR decay, when
  given), then -lr, in the order of the optax chain (:166-172);
- `Lamb` is the lamb branch (:152-161): adam, the masked decayed
  weights, optax.scale_by_trust_ratio (||p|| / ||u||, 1 where either
  norm is 0), the layer-decay scale, -lr;
- `Sgd` is the sgd branch: optax.trace (momentum b1, no Nesterov), the
  layer-decay scale, -lr;
- `Adafactor` is `optax.adafactor(lr)` with its defaults: factored second
  moments over the two largest dims when the smaller of them is >= 128,
  decay 1 - (t+1)^-0.8, update clipping at block RMS 1.0, scaling by the
  parameter's RMS (at least 1e-3), eps 1e-30.

An optimizer is a stateless transformation, as in optax: `init(params)`
returns its state (a dict of tensors and a step count, which torch.save
stores), `update(grads, state, params)` applies one update to the
parameters and the state in place (the port updates in place to keep one
copy of the fp32 master weights and the moments on the card).
`clip_norm` is optax.clip_by_global_norm at the head of the chain.

Layer decay keys on the port's parameter names (`layers.{i}` where the
flax path has `layers_{i}`). It keeps the reference's quirk for the BEiT
per-layer rel-pos tables: `rel_pos_bias_{i}` sits outside `layers.{i}`, so
every table gets layer id num_layers (upstream BEiT gives block i's table
id i + 1).
"""

from __future__ import annotations

import math
import re
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


# --------------------------------------------------------------------------- #
# schedules (optax.linear_schedule / polynomial_schedule / join_schedules /
# warmup_cosine_decay_schedule)
# --------------------------------------------------------------------------- #


def _polynomial(init: float, end: float, power: float,
                transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init

    def sched(count):
        c = min(max(count, 0), transition_steps)
        return (init - end) * (1 - c / transition_steps) ** power + end

    return sched


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def polynomial_decay_schedule(base_lr: float, total_steps: int,
                              warmup_steps: int = 0, end_lr: float = 0.0,
                              power: float = 1.0,
                              warmup_init_lr: float = 0.0) -> Schedule:
    """fairseq polynomial_decay: linear warmup, then polynomial decay."""
    return _join(_polynomial(warmup_init_lr, base_lr, 1.0,
                             max(warmup_steps, 1)),
                 _polynomial(base_lr, end_lr, power,
                             total_steps - warmup_steps), warmup_steps)


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                    min_lr: float = 0.0,
                    warmup_init_lr: float = 0.0) -> Schedule:
    """beit/utils.py cosine_scheduler (optax.warmup_cosine_decay_schedule)."""
    warmup = max(warmup_steps, 1)
    decay_steps = max(total_steps, warmup_steps + 1) - warmup
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def cosine(count):
        c = min(count, decay_steps)
        decayed = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1 - alpha) * decayed + alpha)

    return _join(_polynomial(warmup_init_lr, base_lr, 1.0, warmup), cosine,
                 warmup)


def inverse_sqrt_schedule(base_lr: float, warmup_steps: int = 4000,
                          warmup_init_lr: float = 0.0) -> Schedule:
    """fairseq inverse_sqrt."""

    def sched(step):
        step = max(step, 1)
        if step < warmup_steps:
            return (warmup_init_lr + (base_lr - warmup_init_lr) * step
                    / max(warmup_steps, 1))
        return base_lr * warmup_steps ** 0.5 / math.sqrt(step)

    return sched


def _lr(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


# --------------------------------------------------------------------------- #
# optimizers
# --------------------------------------------------------------------------- #


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def _clipper(grads: Sequence[torch.Tensor], clip_norm: Optional[float]
             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax.clip_by_global_norm(clip_norm) as a per-gradient map to
    float32: g / ||g|| * clip_norm when the global norm is at least
    clip_norm, else g (and g without clipping)."""
    gn = float(global_norm(grads)) if clip_norm else 0.0
    if clip_norm and gn >= clip_norm:
        return lambda g: g.float() / gn * clip_norm
    return lambda g: g.float()


class AdamW:
    """optax.adamw(learning_rate, b1, b2, eps, weight_decay, mask) with
    eps_root 0, optionally after optax.clip_by_global_norm(clip_norm) and
    with the per-parameter layer-decay `scales` before -lr."""

    def __init__(self, learning_rate: LearningRate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 mask: Optional[Sequence[bool]] = None,
                 clip_norm: Optional[float] = None,
                 scales: Optional[Sequence[float]] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = None if mask is None else list(mask)
        self.clip_norm = clip_norm
        self.scales = None if scales is None else list(scales)

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def _adam(self, i: int, g: torch.Tensor, state: dict, t: int
              ) -> torch.Tensor:
        """optax.scale_by_adam's update of parameter i at count t."""
        mu, nu = state["mu"][i], state["nu"][i]
        mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
        return (mu / (1 - self.b1 ** t)) / (
            torch.sqrt(nu / (1 - self.b2 ** t)) + self.eps)

    def _trust(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The step between the decayed weights and the layer-decay
        scale: none in adamw (Lamb's trust ratio)."""
        return u

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        count = state["count"]
        lr = _lr(self.learning_rate, count)
        clip = _clipper(grads, self.clip_norm)
        for i, (p, g) in enumerate(zip(params, grads)):
            u = self._adam(i, clip(g), state, count + 1)
            if self.weight_decay and (self.mask is None or self.mask[i]):
                u.add_(p, alpha=self.weight_decay)
            u = self._trust(u, p)
            if self.scales is not None:
                u.mul_(self.scales[i])
            p.add_(u, alpha=-lr)
        state["count"] = count + 1


class Lamb(AdamW):
    """The lamb branch of create_optimizer: adamw's chain with
    optax.scale_by_trust_ratio between the masked decayed weights and the
    layer-decay scales."""

    def _trust(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """u ||p|| / ||u||, or u where either norm is 0."""
        pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        return u * torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                               pn / un)


class Sgd:
    """The sgd branch of create_optimizer: optax.trace(decay=momentum)
    (t = g + momentum t, no Nesterov), the layer-decay scales, -lr;
    optionally after clip_by_global_norm. No weight decay, as there."""

    def __init__(self, learning_rate: LearningRate, momentum: float = 0.9,
                 clip_norm: Optional[float] = None,
                 scales: Optional[Sequence[float]] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.clip_norm = clip_norm
        self.scales = None if scales is None else list(scales)

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        count = state["count"]
        lr = _lr(self.learning_rate, count)
        clip = _clipper(grads, self.clip_norm)
        for i, (p, g) in enumerate(zip(params, grads)):
            tr = state["trace"][i]
            tr.mul_(self.momentum).add_(clip(g))
            u = tr if self.scales is None else tr * self.scales[i]
            p.add_(u, alpha=-lr)
        state["count"] = count + 1


def _factored_dims(shape, min_dim: int) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second largest and the largest dim, when factored."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda d: (shape[d], d))
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


def _safe_rms(x: torch.Tensor, min_rms: float) -> torch.Tensor:
    """optax's safe_root_mean_squares: the RMS of x, or min_rms where the
    RMS is not above it."""
    rms = torch.sqrt(x.float().pow(2).mean())
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


class Adafactor:
    """optax.adafactor(learning_rate) with its defaults (see the module
    docstring); momentum and weight decay are off, as there."""

    MIN_DIM = 128  # factor the two largest dims when the smaller is >= this
    DECAY_RATE = 0.8
    CLIP = 1.0  # block-RMS clipping threshold of the update
    EPS = 1e-30

    def __init__(self, learning_rate: LearningRate):
        self.learning_rate = learning_rate

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        v_row, v_col, v = [], [], []
        for p in params:
            dims = _factored_dims(p.shape, self.MIN_DIM)
            if dims is None:
                v_row.append(torch.zeros(1, device=p.device))
                v_col.append(torch.zeros(1, device=p.device))
                v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                v_row.append(p.new_zeros(p.shape[:d0] + p.shape[d0 + 1:]))
                v_col.append(p.new_zeros(p.shape[:d1] + p.shape[d1 + 1:]))
                v.append(torch.zeros(1, device=p.device))
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        count = state["count"]
        decay = 1.0 - (count + 1.0) ** (-self.DECAY_RATE)
        lr = _lr(self.learning_rate, count)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            g2 = g * g + self.EPS
            dims = _factored_dims(p.shape, self.MIN_DIM)
            if dims is None:
                v = state["v"][i]
                v.mul_(decay).add_(g2, alpha=1.0 - decay)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                vr, vc = state["v_row"][i], state["v_col"][i]
                vr.mul_(decay).add_(g2.mean(d0), alpha=1.0 - decay)
                vc.mul_(decay).add_(g2.mean(d1), alpha=1.0 - decay)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(rd1, keepdim=True)).rsqrt()
                u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
            rms = torch.sqrt(u.pow(2).mean())
            u = u / torch.clamp(rms / self.CLIP, min=1.0)
            p.sub_(u * lr * _safe_rms(p, 1e-3))
        state["count"] = count + 1


# --------------------------------------------------------------------------- #
# factory
# --------------------------------------------------------------------------- #

_NO_DECAY = ("cls_token", "mask_token", "pos_embed", "gamma",
             "relative_position_bias_table", "latent_query")
_LAYER_ZERO = ("cls_token", "mask_token", "patch_embed", "pos_embed",
               "embeddings", "word_embeddings", "position_embeddings",
               "spatial", "token_type")


def beit_layer_id(name: str, num_layers: int) -> int:
    """beit/optim_factory.py get_num_layer_for_vit on a port parameter
    name: embeddings, tokens and positions -> 0; `layers.{i}` -> i + 1; a
    rel-pos table outside the layers -> num_layers (the reference's rule,
    quirk included: see the module docstring); the rest (fc_norm, head)
    -> num_layers + 1."""
    if any(k in name for k in _LAYER_ZERO):
        return 0
    m = re.search(r"layers\.(\d+)", name)
    if m:
        return int(m.group(1)) + 1
    if "rel_pos_bias" in name:
        return num_layers
    return num_layers + 1


def layer_decay_scales(named_params: Sequence[Tuple[str, torch.Tensor]],
                       decay: float, num_layers: int,
                       layer_id_fn: Callable[[str, int], int] = beit_layer_id
                       ) -> List[float]:
    """Per-parameter multiplier decay^(num_layers + 1 - layer_id)
    (LayerDecayValueAssigner.get_scale, optim_factory.py:47-56)."""
    return [decay ** (num_layers + 1 - layer_id_fn(name, num_layers))
            for name, _ in named_params]


def weight_decay_mask(named_params: Sequence[Tuple[str, torch.Tensor]]
                      ) -> List[bool]:
    """True where weight decay applies: not on 1-D params (bias, norm
    scales) nor on the BEiT token/position tables
    (beit/optim_factory.py:58-78)."""
    return [p.ndim > 1 and not any(s in name for s in _NO_DECAY)
            for name, p in named_params]


def create_optimizer(named_params: Sequence[Tuple[str, torch.Tensor]],
                     learning_rate: LearningRate, *,
                     optimizer: str = "adamw", weight_decay: float = 0.05,
                     betas=(0.9, 0.999), eps: float = 1e-8,
                     layer_decay: Optional[float] = None,
                     num_layers: int = 12,
                     layer_id_fn: Callable[[str, int], int] = beit_layer_id,
                     clip_grad_norm: Optional[float] = None):
    """beit create_optimizer equivalent (optim_factory.py:100-182), every
    branch of the JAX factory: adamw, lamb, sgd (each with layer decay
    when `layer_decay` is set) and adafactor (which, as there, ignores the
    other options). `named_params` is model.named_parameters() as a list
    (names decide the weight-decay mask and the layer ids)."""
    if optimizer == "adafactor":
        return Adafactor(learning_rate)
    scales = (layer_decay_scales(named_params, layer_decay, num_layers,
                                 layer_id_fn) if layer_decay else None)
    if optimizer == "sgd":
        return Sgd(learning_rate, momentum=betas[0], clip_norm=clip_grad_norm,
                   scales=scales)
    if optimizer not in ("adamw", "lamb"):
        raise ValueError(f"unknown optimizer {optimizer}")
    cls = AdamW if optimizer == "adamw" else Lamb
    return cls(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
               weight_decay=weight_decay,
               mask=weight_decay_mask(named_params),
               clip_norm=clip_grad_norm, scales=scales)
