"""Ring attention: sequence-parallel exact attention (port of
unilm_tpu/parallel/ring_attention.py: `ring_attention` :43-97, `_merge`
:128, `_chunk_dead_fix` :144, `ring_attention_flash` :225 with its
custom VJP :240-322).

The sequence is sharded over the ranks of a process group (the mesh's
`seq` axis): each rank keeps its q shard [B, Tl, H, D] and the K/V chunks
travel the ring, one hop a step (`rotate`: `dist.batch_isend_irecv`, send
to the next rank, receive from the previous one), while each rank merges
the partial attention of the chunk it holds with online-softmax
statistics.

- `ring_attention` is the plain form: float32 scores of every chunk,
  merged online (no kernel), the reference of the dense check.
- `ring_attention_flash` is the trainable form, a
  `torch.autograd.Function`. Its forward runs the flash forward on each
  chunk (`chunk_forward`: #5 where `onepass_applies`, else #1, on a CUDA
  tensor; their plain twins on the CPU) and merges the (out, lse) pairs in
  float32 (`merge`). Its backward is a second ring of the flash backward
  (#6 / #7, `chunk_backward`) against the GLOBAL lse, so each chunk's
  dq, dk and dv are the blocks of the whole sequence's backward; the dk /
  dv accumulators travel with their chunk and make one final hop home.

What differs from the JAX module, and why:
- delta. JAX passes each chunk the global bf16 `out`, from which its
  kernels take delta = rowsum(dO out) over the whole row. The port's
  bf16 #6 takes delta itself over its own call's keys, a partial sum on a
  chunk, so the ring passes a delta of its own: rowsum(dO o) of the
  forward's merged float32 o, kept as the residual in place of the bf16
  out, taken once (repair 0b: #6/#7 take a caller's delta).
- dead rows. The kernels give (out 0, lse 0) for a row with no visible
  key, which the merge would count as a real contribution. JAX's
  `_chunk_dead_fix` forces (0, -inf) only for rows whose whole chunk is
  masked; on the causal diagonal a row of a left-padded chunk can see no
  key while the chunk has valid keys, and JAX then shrinks that row (a
  fault of the reference, ROADMAP Queue 3). The port takes each row's
  aliveness: any(mask) of an off-diagonal chunk, cumsum(mask) > 0 on the
  causal diagonal, and forces (0, -inf) for a dead row. A row that no
  chunk makes alive (an example masking every key) ends with lse = -1e30
  and out 0; in the backward every one of its keys is masked before the
  exponential, so its gradients are exact zeros.
- causal skipping. A chunk from a later position contributes nothing;
  JAX computes and masks it to keep the SPMD program uniform. Here the
  rotation runs on every rank but a rank skips the launch: rank r of P
  launches 1 + r forward chunk calls and 1 + r backward chunk calls
  (P (P + 1) / 2 over the ring) where a non-causal ring launches P each.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from unilm_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30


def _world(group) -> Tuple[int, int]:
    if group is None or not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def rotate(tensors: Sequence[torch.Tensor], group,
           shift: int = 1) -> List[torch.Tensor]:
    """Send each tensor to the rank `shift` places on in `group` and
    receive the one from `shift` places back (one ring hop,
    `dist.batch_isend_irecv`; shift -1 turns the ring the other way)."""
    P, r = _world(group)
    if P == 1:
        return list(tensors)
    nxt = dist.get_global_rank(group, (r + shift) % P)
    prv = dist.get_global_rank(group, (r - shift) % P)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for i, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t, nxt, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, o, prv, group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain ring attention over local shards [B, Tl, H, D]: float32
    scores per chunk, online-softmax merge; returns [B, Tl, H, D] in q's
    dtype."""
    B, Tl, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    P, r = _world(group)
    qs = (q * scale).float()
    o = torch.zeros(B, H, Tl, D, device=q.device)
    m = torch.full((B, H, Tl, 1), NEG_INF, device=q.device)
    l = torch.zeros(B, H, Tl, 1, device=q.device)
    kc, vc = k, v
    pos = torch.arange(Tl, device=q.device)
    for step in range(P):
        k_idx = (r - step) % P
        s = torch.einsum("bthd,bshd->bhts", qs, kc.float())
        if causal:
            keep = (k_idx * Tl + pos)[None, :] <= (r * Tl + pos)[:, None]
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(torch.where(s > NEG_INF / 2, s - m_new,
                                  torch.full_like(s, NEG_INF)))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhts,bshd->bhtd", p, vc.float())
        m = m_new
        if step < P - 1:
            kc, vc = rotate([kc, vc], group)
    out = o / torch.where(l > 0, l, torch.ones_like(l))
    return out.transpose(1, 2).to(q.dtype)


def chunk_forward(qs: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  mc: Optional[torch.Tensor], *, diagonal: bool,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring step's forward: the flash forward of pre-scaled q [B, Tl,
    H, D] over the chunk kc / vc (with its key-padding mask mc, int32 [B,
    Tl], or None), causal on the diagonal chunk of a causal ring, full
    visibility elsewhere. Returns (o_c float32 [B, Tl, H, D], lse_c [B, H,
    Tl]) with each row that sees no key of the chunk at (0, NEG_INF)."""
    B, T, H, D = qs.shape
    c = causal and diagonal
    if fa.onepass_applies(B, H, T, kc.shape[1], D, None, 0,
                          qs.element_size()):
        out, lse = fa.flash_forward_onepass(qs, kc, vc, None, mc, causal=c)
    else:
        out, lse = fa.flash_forward(qs, kc, vc, None, mc, causal=c)
    o = out.float()
    if mc is None:
        return o, lse
    valid = mc != 0
    # a row's aliveness: some visible valid key in this chunk
    alive = (torch.cumsum(valid.int(), dim=1) > 0 if c
             else valid.any(1, keepdim=True).expand(B, T))
    lse = torch.where(alive[:, None, :], lse, torch.full_like(lse, NEG_INF))
    o = torch.where(alive[:, :, None, None], o, torch.zeros_like(o))
    return o, lse


def merge(o: torch.Tensor, lse: torch.Tensor, o_c: torch.Tensor,
          lse_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax merge of two (normalised out [B, T, H, D], lse [B,
    H, T]) pairs, float32 (JAX `_merge`); a row at NEG_INF in both stays
    (0, NEG_INF)."""
    m = torch.maximum(lse, lse_c)
    dead = m <= NEG_INF / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    w1 = torch.exp(torch.clamp(lse - m_safe, min=NEG_INF))
    w2 = torch.exp(torch.clamp(lse_c - m_safe, min=NEG_INF))
    den = w1 + w2
    den = torch.where(den > 0, den, torch.ones_like(den))
    t = lambda w: w.transpose(1, 2)[..., None]  # [B, H, T] -> [B, T, H, 1]
    o = (o * t(w1) + o_c * t(w2)) / t(den)
    lse = torch.where(dead, torch.full_like(m, NEG_INF),
                      m_safe + torch.log(den))
    return o, lse


def ring_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """rowsum(dO o) [B, H, T] float32 from the merged float32 o: every
    chunk's backward takes this whole-row delta."""
    return (g.float() * o).sum(-1).transpose(1, 2).contiguous()


def chunk_backward(qs, kc, vc, mc, lse, g, delta, *, diagonal: bool,
                   causal: bool):
    """One ring step's backward: (dq, dk, dv) float32 of the chunk against
    the global lse and delta (#6 / #7 on a CUDA tensor, their twin on the
    CPU), dq for pre-scaled q."""
    dq, dk, dv, _ = fa.flash_backward(
        qs, kc, vc, None, mc, 0, None, None, lse, g,
        causal=causal and diagonal, delta=delta, want_dbias=False)
    return dq.float(), dk.float(), dv.float()


class RingAttentionFn(torch.autograd.Function):
    """`ring_attention_flash` under autograd; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, kpm, group, causal, scale):
        P, r = _world(group)
        qs = (q * scale).contiguous()
        k, v = k.contiguous(), v.contiguous()
        mask = None if kpm is None else kpm.to(torch.int32).contiguous()
        o, lse = chunk_forward(qs, k, v, mask, diagonal=True, causal=causal)
        kc, vc, mc = k, v, mask
        for step in range(1, P):
            moved = rotate([kc, vc] + ([] if mc is None else [mc]), group)
            kc, vc = moved[0], moved[1]
            mc = None if mc is None else moved[2]
            if causal and (r - step) % P > r:
                continue  # a later chunk: nothing to add
            o_c, lse_c = chunk_forward(qs, kc, vc, mc, diagonal=False,
                                       causal=causal)
            o, lse = merge(o, lse, o_c, lse_c)
        ctx.save_for_backward(qs, k, v, mask, o, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        qs, k, v, mask, o, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        P, r = _world(group)
        delta = ring_delta(o, g)
        g = g.to(qs.dtype).contiguous()
        dq, dkc, dvc = chunk_backward(qs, k, v, mask, lse, g, delta,
                                      diagonal=True, causal=causal)
        kc, vc, mc = k, v, mask
        for step in range(1, P):
            moved = rotate([kc, vc, dkc, dvc]
                           + ([] if mc is None else [mc]), group)
            kc, vc, dkc, dvc = moved[:4]
            mc = None if mc is None else moved[4]
            if causal and (r - step) % P > r:
                continue
            dq_c, dk_c, dv_c = chunk_backward(qs, kc, vc, mc, lse, g, delta,
                                              diagonal=False, causal=causal)
            dq = dq + dq_c
            dkc = dkc + dk_c
            dvc = dvc + dv_c
        if P > 1:
            # one final hop takes every accumulator to its chunk's rank
            dkc, dvc = rotate([dkc, dvc], group)
        return ((dq * ctx.scale).to(qs.dtype), dkc.to(k.dtype),
                dvc.to(v.dtype), None, None, None, None)


def ring_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kpm: Optional[torch.Tensor], group,
                         causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel exact attention with flash kernels per chunk.
    q/k/v: [B, Tl, H, D] local shards of the sequence over the ranks of
    `group` (in rank order); kpm: optional [B, Tl] key-padding mask shard
    (nonzero = valid), which travels with its k/v chunk. Returns [B, Tl,
    H, D]; differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return RingAttentionFn.apply(q, k, v, kpm, group, causal, scale)
