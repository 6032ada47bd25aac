"""Sequence-parallel long-context training (port of
unilm_tpu/parallel/long_context.py: `SeqParallelLM` :32-104,
`activation_footprint_bytes` :107).

The sequence is sharded over the ranks of the mesh's `seq` axis: each
rank runs the whole decoder on its [B, T / P] shard (every op but
attention is position-local), and self-attention is the flash-chunk ring
(parallel/ring_attention.py `ring_attention_flash`, through
`cfg.seq_axis` in core/attention.py, xPos at global positions).

`SeqParallelLM` is the trainable workload: a decoder-only LM with tied
embeddings whose `loss_fn` plugs into runtime/train.py `make_train_step`
with `grad_sync=lm`. Each rank's next-token targets end
with the next shard's first token, brought by one hop of the ring the
other way; the last global position has no target and is masked. The
loss is the global mean over the ranks (its value on every rank); each
rank's backward carries its shard's part of it, and `reduce_grads` sums
the parameters' gradients over the ranks, as the JAX transpose of the
replicated parameters does under shard_map.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.layers import init_weights_
from unilm_tpu_torch.core.transformer import Decoder
from unilm_tpu_torch.parallel.ring_attention import _world, rotate
from unilm_tpu_torch.runtime.optim import global_norm


class SeqParallelLM(nn.Module):
    """Decoder-only LM trained with the sequence sharded over `group`
    (the mesh's `axis_name` process group; a one-rank group is one
    shard). Parameters are replicated over the group: `embed_tokens`
    [V, E] (tied head) and `decoder` (core/transformer.py `Decoder`, the
    JAX tree's names)."""

    def __init__(self, cfg, mesh=None, axis_name: str = "seq", *,
                 group=None, device=None):
        super().__init__()
        if mesh is not None:
            group = mesh.get_group(axis_name)
        self.group = group
        self.cfg = cfg.replace(seq_axis=group)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                         device=device, dtype=cfg.dtype)
        self.decoder = Decoder(self.cfg, device=device)

    def init_weights(self, generator: torch.Generator) -> "SeqParallelLM":
        """Random weights at the JAX init's scales (the embedding
        normal(E^-0.5)), the same on every rank for one generator seed."""
        self.embed_tokens.init_std = self.cfg.embed_dim ** -0.5
        init_weights_(self, generator)
        return self

    def local_loss(self, tokens: torch.Tensor):
        """This rank's [B, Tl] shard -> (summed nll, target count), both
        of this shard only."""
        cfg = self.cfg
        P, r = _world(self.group)
        emb = self.embed_tokens.weight
        x = emb[tokens.long()] * cfg.embed_dim ** 0.5
        h = self.decoder(x, causal=True)
        logits = torch.matmul(h.float(), emb.float().t())
        # the last position's target is the next shard's first token
        nxt = rotate([tokens[:, :1].contiguous()], self.group, shift=-1)[0]
        targets = torch.cat([tokens[:, 1:], nxt], dim=1).long()
        nll = -F.log_softmax(logits, dim=-1).gather(
            -1, targets[..., None])[..., 0]
        mask = torch.ones_like(nll)
        if r == P - 1:
            mask[:, -1] = 0.0  # the final global position has no target
        return (nll * mask).sum(), mask.sum()

    def loss_fn(self, model: nn.Module, tokens: torch.Tensor):
        """`make_train_step`'s loss over [B, T_global] tokens (each rank
        takes its shard): the global mean nll, and {"ntok": count}."""
        P, r = _world(self.group)
        Tl = tokens.shape[1] // P
        s, n = model.local_loss(tokens[:, r * Tl:(r + 1) * Tl])
        tot = torch.stack([s.detach(), n])
        if P > 1:
            dist.all_reduce(tot, group=self.group)
        s_all, n_all = tot[0], tot[1]
        # the value is the global loss; the gradient is this shard's part
        loss = s / n_all + (s_all - s.detach()) / n_all
        return loss, {"ntok": n_all}

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum the shards' parameter gradients over the group (in place)."""
        if _world(self.group)[0] > 1:
            for g in grads:
                dist.all_reduce(g, group=self.group)

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the (replicated) summed gradients."""
        return global_norm(grads)


def activation_footprint_bytes(cfg, batch: int, seq: int,
                               remat: bool = True) -> float:
    """Analytic per-device activation footprint of one bf16 train step:
    with per-layer remat the layer-boundary residuals (L x [B, T, E]) plus
    one layer's recomputed internals (4 x [B, T, E] + 2 x [B, T, F]; flash
    attention keeps no [T, S] plane); without remat every layer's
    internals (JAX `activation_footprint_bytes`)."""
    E, Fd, L = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers
    tok = batch * seq * 2
    boundaries = L * tok * E
    layer_internals = tok * (6 * E + 2 * Fd)
    if remat:
        return float(boundaries + layer_internals)
    return float(boundaries + L * layer_internals)
