"""Optimizers and learning-rate schedules (port of
unilm_tpu/runtime/optim.py: `cosine_schedule` :90,
`polynomial_decay_schedule` :99, `inverse_sqrt_schedule` :110,
`weight_decay_mask` :67 and the adamw / adafactor branches of
`create_optimizer` :130-173).

The JAX package builds these from optax; here each is written out with
optax's arithmetic and count semantics, so that the same gradients give
the same parameters:

- a schedule is a function of the update count BEFORE the update (optax's
  `scale_by_schedule`), so the first update of a warmup schedule has lr 0;
- `AdamW` is `optax.adamw`: bias-corrected moments, eps outside the
  square root, decoupled weight decay (on every parameter when `mask` is
  None), then -lr;
- `Adafactor` is `optax.adafactor(lr)` with its defaults: factored second
  moments over the two largest dims when the smaller of them is >= 128,
  decay 1 - (t+1)^-0.8, update clipping at block RMS 1.0, scaling by the
  parameter's RMS (at least 1e-3), eps 1e-30.

An optimizer is a stateless transformation, as in optax: `init(params)`
returns its state (a dict of tensors and a step count, which torch.save
stores), `update(grads, state, params)` applies one update to the
parameters and the state in place (the port updates in place to keep one
copy of the fp32 master weights and the moments on the card). LAMB and
layer-wise LR decay belong to BEiT fine-tuning and raise (ROADMAP Queue 1
slice 6).
"""

from __future__ import annotations

import math
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


class AdamW:
    """optax.adamw(learning_rate, b1, b2, eps, weight_decay, mask) with
    eps_root 0, optionally after optax.clip_by_global_norm(clip_norm)."""

    def __init__(self, learning_rate: LearningRate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 mask: Optional[Sequence[bool]] = None,
                 clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = None if mask is None else list(mask)
        self.clip_norm = clip_norm

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]) -> None:
        count = state["count"]
        lr = _lr(self.learning_rate, count)
        t = count + 1
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        gn = float(global_norm(grads)) if self.clip_norm else 0.0
        clip = bool(self.clip_norm) and gn >= self.clip_norm
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float() / gn * self.clip_norm if clip else g.float()
            mu, nu = state["mu"][i], state["nu"][i]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay and (self.mask is None or self.mask[i]):
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = t


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
                     clip_grad_norm: Optional[float] = None):
    """beit create_optimizer equivalent: the adamw and adafactor branches.
    `named_params` is model.named_parameters() as a list (names decide the
    weight-decay mask)."""
    if layer_decay or optimizer == "lamb":
        raise NotImplementedError(
            "LAMB and layer-wise LR decay (BEiT fine-tuning) are not ported "
            "yet: ROADMAP Queue 1 slice 6")
    if optimizer == "adafactor":
        return Adafactor(learning_rate)
    if optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (adamw, adafactor "
            "are): ROADMAP Queue 1 slice 6")
    return AdamW(learning_rate, b1=betas[0], b2=betas[1], eps=eps,
                 weight_decay=weight_decay,
                 mask=weight_decay_mask(named_params),
                 clip_norm=clip_grad_norm)
