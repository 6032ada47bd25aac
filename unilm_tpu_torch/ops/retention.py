"""Gated retention: chunked-scan and recurrent forms (port of
unilm_tpu/ops/retention.py:27-118, YOCO / RetNet family).

Plain torch, as in JAX, which has no kernel here either: the chunk form is
a loop over chunks whose body is matrix products (within-chunk
decay-masked attention plus the cross-chunk state update); the recurrent
form is the O(1)-state decode step.

Math (per head; log-gates g_t = logsigmoid(gate)/normalizer <= 0):
    S_t = exp(g_t) S_{t-1} + k_t^T v_t
    o_t = q_t S_t
with k pre-scaled by head_dim**-0.5. The state is float32; each form
returns o in q's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def recurrent_gate_retention(
    q: torch.Tensor,  # [B, 1, H, Dk]
    k: torch.Tensor,  # [B, 1, H, Dk]
    v: torch.Tensor,  # [B, 1, H, Dv]
    g: torch.Tensor,  # [B, 1, H] log-gate
    state: torch.Tensor,  # [B, H, Dk, Dv] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. Returns (o [B,1,H,Dv], new_state [B,H,Dk,Dv]).
    The state is rectangular where Dv != Dk (RetNet's Dv = 2 Dk), square
    for YOCO's gated retention."""
    D = q.shape[-1]
    k = k * (D ** -0.5)
    decay = torch.exp(g.float())[:, 0, :, None, None]  # [B, H, 1, 1]
    kv = torch.einsum("bshd,bshe->bhde", k.float(), v.float())
    new_state = state * decay + kv
    o = torch.einsum("bshd,bhde->bshe", q.float(),
                     new_state.to(q.dtype).float()).to(q.dtype)
    return o, new_state


def chunk_gate_retention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,  # [B, T, H] log-gate (<= 0)
    chunk_size: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, D, Dv]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel gated retention. Returns (o [B,T,H,Dv], final_state).
    Dv may differ from Dk (RetNet's value dim is twice the key dim); the
    state is [B, H, Dk, Dv] float32."""
    B, T, H, D = q.shape
    Dv = v.shape[-1]
    C = min(chunk_size, T)
    pad = (-T) % C
    if pad:  # padded gates are 0, a decay of 1
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        g = F.pad(g, (0, 0, 0, pad))
    n = (T + pad) // C
    k = k * (D ** -0.5)

    def chunked(x):  # [B, n*C, H, d] -> [n, B, H, C, d]
        return x.reshape(B, n, C, H, -1).permute(1, 0, 3, 2, 4)

    qc, kc, vc = chunked(q), chunked(k), chunked(v)
    gc = g.reshape(B, n, C, H).permute(1, 0, 3, 2).float()  # [n, B, H, C]
    state = (torch.zeros((B, H, D, Dv), dtype=torch.float32, device=q.device)
             if initial_state is None else initial_state)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=q.device))
    outs = []
    for i in range(n):
        qi, ki, vi, gi = qc[i], kc[i], vc[i], gc[i]
        c = torch.cumsum(gi, dim=-1)  # [B, H, C] inclusive
        total = c[..., -1:]
        rel = c[..., :, None] - c[..., None, :]  # c_i - c_j
        decay = torch.where(causal, torch.exp(rel), 0.0)
        scores = torch.einsum("bhid,bhjd->bhij", qi.float(), ki.float())
        inner = torch.einsum("bhij,bhjd->bhid", scores * decay, vi.float())
        cross = torch.einsum("bhid,bhde->bhie", qi.float(), state)
        outs.append(inner + cross * torch.exp(c)[..., None])
        w = torch.exp(total - c)  # [B, H, C]
        kv = torch.einsum("bhjd,bhje->bhde", ki.float() * w[..., None],
                          vi.float())
        state = state * torch.exp(total)[..., None] + kv
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * C, H, Dv)
    return o[:, :T].to(q.dtype), state


def naive_gate_retention(q, k, v, g):
    """The O(T) recurrent reference, for tests."""
    B, T, H, D = q.shape
    state = torch.zeros((B, H, D, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
    outs = []
    for t in range(T):
        o, state = recurrent_gate_retention(
            q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], g[:, t:t + 1], state)
        outs.append(o)
    return torch.cat(outs, dim=1), state
