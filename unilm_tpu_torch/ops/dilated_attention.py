"""LongNet dilated attention (port of unilm_tpu/ops/dilated_attention.py).

The sequence splits into segments of length w; within a segment attention
runs over the r-dilated subsequence (every r-th token), the heads spread
over the r offsets so that every token is covered; several (w, r)
configurations run side by side and their outputs are mixed per token by
each configuration's softmax denominator (LongNet's dynamic mixture).

In JAX these are XLA einsums with no Pallas kernel, so the port writes
them in plain torch, on the input's device: one batched dense attention
per configuration and offset over [B, T/w, w/r] tokens, then the mixture.
The O(T^2) plane of the long configurations is never formed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG_INF = -1e30


def _segment_dilated_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, w: int, r: int, offset: int,
                               causal: bool
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention within w-segments over the r-dilated subsequence at
    `offset` of one head group ([B, T, Hg, D], q pre-scaled): (out [B, T,
    Hg, D] float32, lse [B, T, Hg]) with zeros / NEG_INF at the positions
    this offset does not select."""
    B, T, Hg, D = q.shape
    ns, m = T // w, w // r

    def pick(x):  # [B, ns, m, Hg, D]: positions offset + r j of a segment
        return x.reshape(B, ns, w, Hg, D)[:, :, offset::r]

    qs, ks, vs = pick(q), pick(k), pick(v)
    s = torch.einsum("bsmhd,bsnhd->bshmn", qs.float(), ks.float())
    if causal:
        cm = torch.ones(m, m, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~cm, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)  # [B, ns, Hg, m]
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bshmn,bsnhd->bsmhd", p.to(vs.dtype).float(),
                     vs.float())
    out = torch.zeros(B, ns, w, Hg, D, dtype=o.dtype, device=q.device)
    out[:, :, offset::r] = o
    lse_full = torch.full((B, ns, w, Hg), NEG_INF, dtype=torch.float32,
                          device=q.device)
    lse_full[:, :, offset::r] = lse.transpose(-1, -2)
    return out.reshape(B, T, Hg, D), lse_full.reshape(B, T, Hg)


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      segment_lengths: Sequence[int] = (2048, 4096, 8192),
                      dilation_rates: Sequence[int] = (1, 2, 4),
                      scale: Optional[float] = None,
                      causal: bool = True) -> torch.Tensor:
    """LongNet dilated attention over [B, T, H, D]. The heads split evenly
    over each configuration's r offsets; the configurations mix per token
    by softmax-denominator weights. T must divide by every segment length
    (pad outside), each w by its r and, for r > 1, H by r."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    if len(segment_lengths) != len(dilation_rates):
        raise ValueError("one dilation rate per segment length")
    qs = (q * scale).to(q.dtype)
    outs, lses = [], []
    for w, r in zip(segment_lengths, dilation_rates):
        w = min(w, T)
        if T % w or w % r:
            raise ValueError(f"T={T} must divide by segment length {w}, "
                             f"and {w} by its dilation {r}")
        if r == 1:
            o, lse = _segment_dilated_attention(qs, k, v, w, 1, 0, causal)
        else:
            if H % r:
                raise ValueError(f"heads {H} must divide by dilation {r}")
            hg = H // r
            parts = [_segment_dilated_attention(
                qs[:, :, off * hg:(off + 1) * hg],
                k[:, :, off * hg:(off + 1) * hg],
                v[:, :, off * hg:(off + 1) * hg], w, r, off, causal)
                for off in range(r)]
            o = torch.cat([p[0] for p in parts], dim=2)
            lse = torch.cat([p[1] for p in parts], dim=2)
        outs.append(o)
        lses.append(lse)
    if len(outs) == 1:
        return outs[0].to(q.dtype)
    # dynamic mixture: exp(lse_i) / sum_j exp(lse_j) per token and head
    wgt = torch.softmax(torch.stack(lses), dim=0)  # [C, B, T, H]
    out = torch.sum(torch.stack(outs) * wgt[..., None], dim=0)
    return out.to(q.dtype)
