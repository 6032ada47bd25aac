"""Train-mode attention (port of unilm_tpu/core/attention.py
`MultiheadAttention` :34-258, its `mode="train"` self- and cross-attention
branches).

q/k/v projections, full-sequence xPos (`_apply_xpos_train` :271-283) with
the length-extrapolation qscale (:204-208), attention through
ops/attention.py (on a CUDA tensor the flash kernels, forward and
backward), sub-LN `inner_attn_ln` and `out_proj`. The parameters carry the
JAX module's names; the generation path (core/transformer.py
`ScanSelfAttention`) subclasses this module, so one set of weights serves
training, prefill and decode.

Cross-attention in train mode takes `key` in `forward_train` (the Kosmos
latent-query resampler, TrOCR's teacher-forced decoder): q from the
query, k and v from `key` (whose width `kv_dim` may differ from the
query's, as TrOCR's 768-wide encoder under a 1024-wide decoder), no
inner_attn_ln (sub-LN skips cross-attention projections, :75-77). The
cached cross-attention of generation is core/transformer.py's
`ScanCrossAttention`, a subclass.

Under `cfg.multiway` (BEiT-3, VLMo) q_proj, k_proj, v_proj, out_proj and
the sub-LN inner_attn_ln are `MultiwayDense` / `MultiwayNorm` pairs
(JAX :80-92, :239-256), and `forward_train` takes the modality `split`
(core/multiway.py).

Sequence-parallel self-attention (`cfg.seq_axis`, JAX :105-140): the
module holds a [B, Tl] shard of the sequence, `cfg.seq_axis` is the
process group of the mesh's `seq` axis (parallel/long_context.py sets
it), and train-mode self-attention goes through
parallel/ring_attention.py `ring_attention_flash` with the shard's
key-padding mask riding the ring. The xPos tables then rotate at global
positions (the shard of rank r starts at r Tl) and the
length-extrapolation qscale takes the global length (`xpos_inputs` with
`k_len`, from the stack). An additive bias raises, as in JAX.

Tensor-parallel (parallel/sharding.py splits q/k/v by columns and
out_proj by rows over the mesh's `tensor` axis): train mode attends over
this rank's block of heads (`heads_group`), the attention-probability
dropout drawing that block's masks; the heads are joined before the
sub-LN, or without it out_proj sums the ranks' parts. The generation
path projects whole heads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from unilm_tpu_torch.core import positional
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import make_dense, make_norm
from unilm_tpu_torch.core.multiway import (MultiwayDense, MultiwayNorm,
                                           Split)
from unilm_tpu_torch.ops.attention import attention
from unilm_tpu_torch.ops.collectives import gather_along


def xpos_inputs(cfg: TransformerConfig, start: int, T: int, device,
                k_len: Optional[int] = None):
    """xPos rotary tables for positions start..start+T-1, laid out to
    broadcast against [B, T, H, D]: ((sin, cos) for q with the decay scale,
    (sin, cos) for k with its inverse, length-extrapolation qscale over a
    key length `k_len`, start + T by default)."""
    pos = start + torch.arange(T, device=device)
    sin, cos, xsc = positional.xpos_sin_cos_scale(
        pos, 0.0, cfg.head_dim, cfg.xpos_scale_base)
    q_tab = [t[:, None] for t in positional.rotary_tables(sin, cos, xsc)]
    k_tab = [t[:, None] for t in positional.rotary_tables(sin, cos, 1.0 / xsc)]
    qscale = positional.length_extrapolation_qscale(
        pos, start + T if k_len is None else k_len, cfg.scale_length)
    return q_tab, k_tab, qscale[:, None, None]


def apply_xpos(q, k, xpos):
    """Rotate q and k with `xpos_inputs` tables and apply the qscale, each
    cast back to its dtype as the JAX module does."""
    (sq, cq), (sk, ck), qscale = xpos
    q = positional.apply_rotary(q, sq, cq)
    k = positional.apply_rotary(k, sk, ck)
    return (q * qscale).to(q.dtype), k


class MultiheadAttention(nn.Module):
    """Self- or cross-attention with the JAX module's parameters: q_proj,
    k_proj, v_proj, out_proj and (sub-LN self-attention) inner_attn_ln.
    `kv_dim`: the width k_proj and v_proj read (default embed_dim; the
    flax module takes it from its input)."""

    def __init__(self, cfg: TransformerConfig, self_attention: bool = True,
                 kv_dim: Optional[int] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.self_attention = self_attention
        H, D, E = cfg.num_heads, cfg.head_dim, cfg.embed_dim
        vo_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
        if not self_attention and cfg.subln:
            vo_scale = 1.0 / cfg.deepnorm_init_div
        if cfg.multiway:
            dense = lambda i, o, s: MultiwayDense(cfg, i, o, init_scale=s,
                                                  device=device)
        else:
            dense = lambda i, o, s: make_dense(cfg, i, o, init_scale=s,
                                               device=device)
        self.q_proj = dense(E, H * D, 2 ** -0.5)
        kv_dim = E if kv_dim is None else kv_dim
        self.k_proj = dense(kv_dim, H * D, 2 ** -0.5)
        self.v_proj = dense(kv_dim, H * D, 2 ** -0.5 * vo_scale)
        if cfg.subln and self_attention:
            self.inner_attn_ln = (
                MultiwayNorm(cfg, H * D, device=device) if cfg.multiway
                else make_norm(cfg, H * D, device=device))
        self.out_proj = dense(H * D, E, vo_scale)

    @property
    def scale(self) -> float:
        cfg = self.cfg
        return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5

    def _mw(self, module: nn.Module, x: torch.Tensor, split: Split):
        """`module` on x, with the modality split under cfg.multiway."""
        return module(x, split) if self.cfg.multiway else module(x)

    def heads_group(self):
        """The tensor group when the projections are split over it
        (parallel/sharding.py) into whole heads: q/k/v column splits,
        out_proj a row split; else None."""
        s = getattr(self.q_proj, "tensor_split", None)
        if s is None or self.cfg.num_heads % dist.get_world_size(s[1]):
            return None
        return s[1]

    def project(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                split: Split = None, whole: bool = True):
        """q from x, k and v from kv (default x), as [B, T|S, H, D]; with
        `whole=False` under `heads_group`, this rank's block of heads."""
        kv = x if kv is None else kv
        B, T, S = x.shape[0], x.shape[1], kv.shape[1]
        D = self.cfg.head_dim
        if whole:
            proj = lambda m, t: self._mw(m, t, split)
        else:
            proj = lambda m, t: m(t, whole=False)
        return (proj(self.q_proj, x).view(B, T, -1, D),
                proj(self.k_proj, kv).view(B, S, -1, D),
                proj(self.v_proj, kv).view(B, S, -1, D))

    def output(self, out: torch.Tensor, split: Split = None,
               whole: bool = True) -> torch.Tensor:
        """[B, T, H, D] attention output -> inner_attn_ln -> out_proj;
        `whole=False`: this rank's block of heads (`heads_group`), joined
        before the sub-LN (a norm over every head) or else taken by the
        row-parallel out_proj as its block of input features."""
        B, T = out.shape[0], out.shape[1]
        out = out.reshape(B, T, -1)
        if not whole:
            if not hasattr(self, "inner_attn_ln"):
                return self.out_proj(out, whole=False)
            out = gather_along(out, -1, self.heads_group())
        if hasattr(self, "inner_attn_ln"):
            out = self._mw(self.inner_attn_ln, out, split)
        return self._mw(self.out_proj, out, split)

    def forward_train(self, x: torch.Tensor, key: Optional[torch.Tensor] = None,
                      *, causal: bool = False,
                      key_padding_mask: Optional[torch.Tensor] = None,
                      attn_bias: Optional[torch.Tensor] = None,
                      xpos=None, split: Split = None,
                      rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full-sequence attention (mode="train"): self-attention over x,
        or cross-attention of x over `key` for a cross-attention module.
        `xpos` are the `xpos_inputs(cfg, 0, T)` tables, shared by every
        layer (self-attention only); `split` the multiway modality split
        (core/multiway.py); `rng` the layer's dropout generator (a
        training forward), which drops the attention probabilities at
        cfg.attention_dropout."""
        cfg = self.cfg
        if self.self_attention == (key is not None):
            raise ValueError("a cross-attention module takes `key`; a "
                             "self-attention module does not")
        # split over `tensor`: attend over this rank's heads
        whole = self.heads_group() is None
        q, k, v = self.project(x, key, split, whole)
        if xpos is not None:
            q, k = apply_xpos(q, k, xpos)
        if cfg.seq_axis is not None and self.self_attention:
            if attn_bias is not None:
                raise NotImplementedError(
                    "cfg.seq_axis (sequence-parallel ring attention) does "
                    "not thread additive biases through the ring chunks; "
                    "key-padding masks are supported")
            from unilm_tpu_torch.parallel.ring_attention import (
                ring_attention_flash)

            out = ring_attention_flash(q, k, v, key_padding_mask,
                                       cfg.seq_axis, causal, self.scale)
            return self.output(out, split, whole)
        out = attention(q, k, v, bias=attn_bias,
                        key_padding_mask=key_padding_mask, scale=self.scale,
                        causal=causal,
                        window=cfg.window_size if self.self_attention else 0,
                        dropout_rate=cfg.attention_dropout,
                        dropout_rng=rng, use_flash=cfg.use_flash)
        return self.output(out, split, whole)
