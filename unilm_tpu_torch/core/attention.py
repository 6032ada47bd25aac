"""Train-mode self-attention (port of unilm_tpu/core/attention.py
`MultiheadAttention` :34-258, its `mode="train"` self-attention branch).

q/k/v projections, full-sequence xPos (`_apply_xpos_train` :271-283) with
the length-extrapolation qscale (:204-208), attention through
ops/attention.py (on a CUDA tensor the flash kernels, forward and
backward), sub-LN `inner_attn_ln` and `out_proj`. The parameters carry the
JAX module's names; the generation path (core/transformer.py
`ScanSelfAttention`) subclasses this module, so one set of weights serves
training, prefill and decode.

Cross-attention (TrOCR, slice 8), the multiway projections (BEiT-3) and
sequence-parallel ring attention (`cfg.seq_axis`, slice 9) raise
NotImplementedError naming their ROADMAP entry.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unilm_tpu_torch.core import positional
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.core.layers import make_dense, make_norm
from unilm_tpu_torch.ops.attention import attention


def xpos_inputs(cfg: TransformerConfig, start: int, T: int, device):
    """xPos rotary tables for positions start..start+T-1, laid out to
    broadcast against [B, T, H, D]: ((sin, cos) for q with the decay scale,
    (sin, cos) for k with its inverse, length-extrapolation qscale)."""
    pos = start + torch.arange(T, device=device)
    sin, cos, xsc = positional.xpos_sin_cos_scale(
        pos, 0.0, cfg.head_dim, cfg.xpos_scale_base)
    q_tab = [t[:, None] for t in positional.rotary_tables(sin, cos, xsc)]
    k_tab = [t[:, None] for t in positional.rotary_tables(sin, cos, 1.0 / xsc)]
    qscale = positional.length_extrapolation_qscale(
        pos, start + T, cfg.scale_length)
    return q_tab, k_tab, qscale[:, None, None]


def apply_xpos(q, k, xpos):
    """Rotate q and k with `xpos_inputs` tables and apply the qscale, each
    cast back to its dtype as the JAX module does."""
    (sq, cq), (sk, ck), qscale = xpos
    q = positional.apply_rotary(q, sq, cq)
    k = positional.apply_rotary(k, sk, ck)
    return (q * qscale).to(q.dtype), k


class MultiheadAttention(nn.Module):
    """Self-attention with the JAX module's parameters: q_proj, k_proj,
    v_proj, out_proj and (sub-LN) inner_attn_ln."""

    def __init__(self, cfg: TransformerConfig, self_attention: bool = True,
                 device=None):
        super().__init__()
        if not self_attention:
            raise NotImplementedError(
                "cross-attention (TrOCR decoder) is not ported yet: ROADMAP "
                "Queue 1 slice 8")
        if cfg.multiway:
            raise NotImplementedError(
                "multiway projections (BEiT-3) are not ported yet: ROADMAP "
                "Queue 1 slice 7")
        self.cfg = cfg
        H, D, E = cfg.num_heads, cfg.head_dim, cfg.embed_dim
        vo_scale = (1.0 / cfg.deepnorm_init_div) * cfg.subln_init_mul
        self.q_proj = make_dense(cfg, E, H * D, init_scale=2 ** -0.5,
                                 device=device)
        self.k_proj = make_dense(cfg, E, H * D, init_scale=2 ** -0.5,
                                 device=device)
        self.v_proj = make_dense(cfg, E, H * D,
                                 init_scale=2 ** -0.5 * vo_scale, device=device)
        if cfg.subln:
            self.inner_attn_ln = make_norm(cfg, H * D, device=device)
        self.out_proj = make_dense(cfg, H * D, E, init_scale=vo_scale,
                                   device=device)

    @property
    def scale(self) -> float:
        cfg = self.cfg
        return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5

    def project(self, x: torch.Tensor):
        """q, k, v as [B, T, H, D]."""
        B, T = x.shape[0], x.shape[1]
        H, D = self.cfg.num_heads, self.cfg.head_dim
        return (self.q_proj(x).view(B, T, H, D),
                self.k_proj(x).view(B, T, H, D),
                self.v_proj(x).view(B, T, H, D))

    def output(self, out: torch.Tensor) -> torch.Tensor:
        """[B, T, H, D] attention output -> inner_attn_ln -> out_proj."""
        B, T = out.shape[0], out.shape[1]
        out = out.reshape(B, T, -1)
        if self.cfg.subln:
            out = self.inner_attn_ln(out)
        return self.out_proj(out)

    def forward_train(self, x: torch.Tensor, *, causal: bool,
                      key_padding_mask: Optional[torch.Tensor] = None,
                      attn_bias: Optional[torch.Tensor] = None,
                      xpos=None) -> torch.Tensor:
        """Full-sequence self-attention (mode="train"). `xpos` are the
        `xpos_inputs(cfg, 0, T)` tables, shared by every layer."""
        cfg = self.cfg
        if cfg.seq_axis:
            raise NotImplementedError(
                "sequence-parallel ring attention (cfg.seq_axis) is not "
                "ported yet: ROADMAP Queue 1 slice 9")
        q, k, v = self.project(x)
        if xpos is not None:
            q, k = apply_xpos(q, k, xpos)
        out = attention(q, k, v, bias=attn_bias,
                        key_padding_mask=key_padding_mask, scale=self.scale,
                        causal=causal, window=cfg.window_size,
                        dropout_rate=cfg.attention_dropout,
                        use_flash=cfg.use_flash)
        return self.output(out)
