"""Training engine (port of unilm_tpu/runtime/train.py:
`cross_entropy_loss` :36, `TrainState` :20, `apply_with_moe_aux` :55-78
and `make_train_step` :81-154).

The JAX step is one jitted function over a param pytree; here it runs
eagerly on an `nn.Module`: micro-batch gradient accumulation (fairseq
update_freq) is a loop of backward passes into the parameters' `.grad`,
scaled by 1/microbatches at the end as JAX scales its summed gradients;
then global-norm clipping, the optimizer (runtime/optim.py), optional EMA
of the parameters, and the metrics `loss` and `grad_norm`. Parameters
keep `cfg.param_dtype` (float32 master weights) and so do their gradients.
A model spread over ranks (parallel/) passes its `grad_sync`, which
combines the gradients across ranks and takes their global norm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.runtime.optim import global_norm


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its parameters), the optimizer state and the
    EMA copy of the parameters (or None)."""

    step: int
    model: nn.Module
    opt_state: Any
    ema_params: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, tx, ema: bool = False) -> "TrainState":
        params = trainable(model)
        return cls(step=0, model=model, opt_state=tx.init(params),
                   ema_params=([p.detach().clone() for p in params]
                               if ema else None))

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": self.opt_state, "ema_params": self.ema_params}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.opt_state = sd["opt_state"]
        self.ema_params = sd["ema_params"]


def trainable(model: nn.Module) -> List[torch.Tensor]:
    """The parameters the optimizer updates, in a fixed order."""
    return [p for p in model.parameters() if p.requires_grad]


def cross_entropy_loss(
    logits: torch.Tensor,  # [..., V]
    targets: torch.Tensor,  # [...] int
    mask: Optional[torch.Tensor] = None,  # [...] float/bool
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_loss, num_tokens); the caller divides."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (
            -logp.mean(-1))
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum(), mask.sum()
    return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)


def teacher_forced_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                        generator: Optional[torch.Generator] = None,
                        label_smoothing: float = 0.0,
                        pad: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """An image-to-text fine-tune loss for `make_train_step` (TrOCR's, as
    JAX's benchmarks/train_mfu.py bench_trocr composes it over
    `TrOCRModel.__call__`): `batch` holds "images" [B, H, W, 3] and
    "tokens" [B, T + 1]; the model reads tokens[:, :-1] teacher-forced and
    the cross-entropy scores tokens[:, 1:], averaged over the targets that
    are not `pad` (every target without one). `generator`: the dropout
    masks of a training forward. Returns (loss, {})."""
    tokens = batch["tokens"]
    logits = model(batch["images"], tokens[:, :-1], generator=generator)
    targets = tokens[:, 1:]
    s, n = cross_entropy_loss(logits, targets,
                              None if pad is None else targets != pad,
                              label_smoothing)
    return s / n, {}


def apply_with_moe_aux(model: nn.Module, *args, **kwargs):
    """model(*args, **kwargs) with the MoE layers' GShard load-balance
    loss summed over the layers that ran (the JAX function reads the sown
    `losses` and `moe_metrics` collections). Returns (outputs, aux_loss,
    stats), stats = {"moe_overflow": the mean over those layers of the
    fraction of routing assignments the capacity clip dropped} (empty
    without MoE layers). The loss stays in the graph: the caller adds
    `wt * aux_loss` to its loss, as the reference's moe_gate_loss_wt."""
    from unilm_tpu_torch.core.moe import MoELayer

    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    for m in layers:
        m.moe_aux = m.moe_overflow = None
    out = model(*args, **kwargs)
    ran = [m for m in layers if m.moe_aux is not None]
    aux = torch.zeros((), dtype=torch.float32,
                      device=ran[0].moe_aux.device if ran else None)
    for m in ran:
        aux = aux + m.moe_aux
    stats = {}
    if ran:
        stats["moe_overflow"] = sum(m.moe_overflow for m in ran) / len(ran)
    return out, aux, stats


def _index(batch, i: int):
    if isinstance(batch, dict):
        return {k: v[i] for k, v in batch.items()}
    return batch[i]


def make_train_step(
    loss_fn: Callable[[nn.Module, Any], Tuple[torch.Tensor, Dict]],
    tx,
    *,
    ema_decay: Optional[float] = None,
    clip_grad_norm: Optional[float] = None,
    microbatches: int = 1,
    grad_sync=None,
):
    """loss_fn(model, batch) -> (loss, metrics_dict).

    Returns step(state, batch) -> (state, metrics): one optimizer update,
    with `state` updated in place and returned. With microbatches > 1,
    `batch` (a tensor or a dict of tensors) carries a leading axis of that
    size; each microbatch's forward and backward runs in turn, so only one
    microbatch's activations are alive at a time.

    `grad_sync`, for a model spread over ranks (parallel/): an object
    whose `reduce_grads(grads)` combines the accumulated gradients in
    place across the ranks that share parameters (the collectives SPMD
    inserts in JAX) and whose `grad_norm(grads)` gives the global norm of
    gradients held in shards; without it the norm is taken locally."""

    def step(state: TrainState, batch):
        model = state.model
        params = trainable(model)
        for p in params:
            p.grad = None
        loss_sum, metrics_sum = None, {}
        for i in range(microbatches):
            mb = batch if microbatches == 1 else _index(batch, i)
            loss, metrics = loss_fn(model, mb)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in metrics.items():
                v = torch.as_tensor(v).detach()
                metrics_sum[k] = v if k not in metrics_sum else (
                    metrics_sum[k] + v)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if grad_sync is not None:
            grad_sync.reduce_grads(grads)
        if microbatches > 1:
            inv = 1.0 / microbatches
            loss_sum = loss_sum * inv
            metrics_sum = {k: v * inv for k, v in metrics_sum.items()}
            for g in grads:
                g.mul_(inv)
        gnorm = (global_norm(grads) if grad_sync is None
                 else grad_sync.grad_norm(grads))
        if clip_grad_norm:
            scale = torch.clamp(clip_grad_norm / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        tx.update(grads, state.opt_state, params)
        if state.ema_params is not None and ema_decay:
            with torch.no_grad():
                for e, p in zip(state.ema_params, params):
                    e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        for p in params:
            p.grad = None
        state.step += 1
        metrics = dict(metrics_sum)
        metrics.update(loss=loss_sum, grad_norm=gnorm)
        return state, metrics

    return step
