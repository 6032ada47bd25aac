"""Chunked-vocabulary softmax cross-entropy (port of
unilm_tpu/ops/fused_ce.py: `chunked_cross_entropy` :118 with the custom
VJP's forward `_fwd` :50 and backward `_bwd_vjp` :87).

The sum of the token losses is computed from the decoder features and the
(tied) output embedding, scanning the vocabulary in chunks with an online
log-sum-exp, so no [N, V] logits tensor is ever built: the peak extra
memory is one [N, chunk] float32 block. The backward rebuilds each chunk's
softmax from the saved row log-sum-exp (dx += dz_c E_c, dE_c = dz_c^T x).
Label smoothing and a token mask are supported as in JAX.

The reference is plain JAX (no Pallas kernel), so this is plain torch: the
chunk products are float32 `torch.matmul`s of the features and the
embedding, as JAX's `jnp.dot(..., preferred_element_type=float32)` of a
bf16 x and a float32 embedding computes them. The last chunk is not
padded: JAX's zero rows past V get logits of -1e30 and add exactly zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _chunk_logits(x32: torch.Tensor, embed: torch.Tensor, base: int,
                  chunk: int) -> torch.Tensor:
    return x32 @ embed[base:base + chunk].float().t()


class ChunkedCrossEntropyFn(torch.autograd.Function):
    """Sum of token losses over x [N, E] against embed [V, E]; gradients
    flow to x and embed."""

    @staticmethod
    def forward(ctx, x, embed, targets, weight, chunk: int, ls: float):
        N = x.shape[0]
        V = embed.shape[0]
        x32 = x.float()
        m = torch.full((N,), -1e30, dtype=torch.float32, device=x.device)
        s = torch.zeros(N, dtype=torch.float32, device=x.device)
        tgt = torch.zeros_like(s)
        zsum = torch.zeros_like(s)
        for base in range(0, V, chunk):
            z = _chunk_logits(x32, embed, base, chunk)
            c = z.shape[1]
            cm = torch.maximum(m, z.amax(-1))
            s = s * torch.exp(m - cm) + torch.exp(z - cm[:, None]).sum(-1)
            m = cm
            off = (targets - base).clamp(0, c - 1)
            tl = z.gather(1, off[:, None])[:, 0]
            in_c = (targets >= base) & (targets < base + c)
            tgt = torch.where(in_c, tl, tgt)
            zsum = zsum + z.sum(-1)
        lse = m + torch.log(s)
        nll = lse - tgt
        if ls > 0.0:
            nll = (1.0 - ls) * nll + ls * (lse - zsum / V)
        ctx.save_for_backward(x, embed, targets, weight, lse)
        ctx.chunk, ctx.ls = chunk, ls
        return (nll * weight).sum()

    @staticmethod
    def backward(ctx, g):
        x, embed, targets, weight, lse = ctx.saved_tensors
        chunk, ls = ctx.chunk, ctx.ls
        V = embed.shape[0]
        x32 = x.float()
        scale = (g * weight)[:, None]
        dx = torch.zeros_like(x32)
        dembed = torch.empty(embed.shape, dtype=torch.float32,
                             device=embed.device)
        for base in range(0, V, chunk):
            z = _chunk_logits(x32, embed, base, chunk)
            c = z.shape[1]
            p = torch.exp(z - lse[:, None])
            onehot = ((targets - base)[:, None] == torch.arange(
                c, device=z.device)[None, :]).float()
            dz = p - (1.0 - ls) * onehot
            if ls > 0.0:
                dz = dz - ls / V
            dz = dz * scale
            dx = dx + dz @ embed[base:base + c].float()
            dembed[base:base + c] = dz.t() @ x32
        return (dx.to(x.dtype), dembed.to(embed.dtype), None, None, None,
                None)


def chunked_cross_entropy(
    features: torch.Tensor,   # [..., E] pre-logit decoder output
    embedding: torch.Tensor,  # [V, E] (tied) output embedding
    targets: torch.Tensor,    # [...] int
    mask: Optional[torch.Tensor] = None,  # [...] float/bool
    *,
    chunk: int = 8192,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for runtime.train.cross_entropy_loss(output_layer(x), ...):
    (sum_loss, num_tokens) without building [..., V] logits."""
    E = features.shape[-1]
    x = features.reshape(-1, E)
    t = targets.reshape(-1).long()
    if mask is None:
        w = torch.ones(t.shape[0], dtype=torch.float32, device=x.device)
        n = torch.tensor(float(t.numel()), device=x.device)
    else:
        w = mask.reshape(-1).float()
        n = w.sum()
    loss = ChunkedCrossEntropyFn.apply(x, embedding, t, w, chunk,
                                       float(label_smoothing))
    return loss, n
