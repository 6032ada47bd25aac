"""Flash attention forward and backward (port of
unilm_tpu/ops/flash_attention.py `flash_attention` :1979, `_flash_forward`
:268 / `_flash_kernel` :99, and the custom VJP `_flash_bwd` :1920 /
`_flash_backward_pallas` :1718 / `_bwd_dq_kernel` :1235 /
`_bwd_dkv_kernel` :1381).

`flash_forward` takes pre-scaled q and returns `out` [B, T, H, D] and the
row log-sum-exp `lse` [B, H, T] float32 (the TPU kernel's lane-major
[B, H*nq, 1, bq] lse buffer is TPU tiling and is not carried over). The
contract is the TPU kernel's: causal with a query offset, sliding window,
valid kv prefix (`kv_len`), per-key padding mask and an additive bias that
broadcasts over [B|1, H|1, T, S]. Fully masked rows give out = 0 and
lse = 0.

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/flash_fwd.cu; on a CPU tensor it runs `flash_forward_plain`, the
same function in plain torch. Nothing else selects the plain version.

`flash_attention` runs the forward under `FlashAttentionFn`, whose
backward takes (dq, dk, dv, dbias) from the two kernels of
csrc/flash_bwd.cu on a CUDA tensor and from `flash_backward_plain` on a
CPU tensor; a head-broadcast bias recomputes through plain autograd, as
JAX does. The opt-in TPU schedules UNILM_TPU_TRI_FLASH (kernel #2) and
UNILM_TPU_FUSED_BWD (kernel #8) raise rather than being ignored.

`fused_encoder_attention` (port of `fused_encoder_attention` :701,
`_vit_forward` :632 / `_vit_kernel` :580) is the encoder hot path:
non-causal, full kv, no key-padding mask, an exact softmax over whole
score rows, no lse. It runs under `EncoderAttentionFn`, the custom VJP
`_vit_fwd` / `_vit_bwd` (:933-975): forward csrc/encoder_attention.cu
(#3), backward csrc/encoder_attention_bwd.cu (`_vit_bwd_kernel`, #4) on a
CUDA tensor; `fused_encoder_attention_plain` and
`fused_encoder_backward_plain` on a CPU tensor. The backward saves q, k,
v and the bias only, as the TPU kernel reads no residual. The JAX
dispatch of `_vit_bwd` to `doc_backward` (#10) or a dense recompute when
the one-pass plane exceeds the TPU's VMEM (`_vit_bwd_profitable`) is a
TPU budget and is not carried: #4 takes every shape #3 takes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from unilm_tpu_torch.ops._native import (
    F, I, P, CudaKernel, check_tensor, ptr, stream)

NEG_INF = -1e30
SUPPORTED_D = (64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel("flash_fwd.cu", {
    # q, k, v, bias, mask, out, lse, B, T, S, H, D, bias_sb, bias_sh,
    # q_offset, limit, causal, window, dtype, stream
    "flash_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P],
})


def supports(q: torch.Tensor, k: torch.Tensor,
             bias: Optional[torch.Tensor], window: int) -> bool:
    """Shape/dtype admissibility of the CUDA kernel."""
    B, T, H, D = q.shape
    if D not in SUPPORTED_D or q.dtype not in _DTYPE_CODE:
        return False
    if bias is not None:
        if bias.ndim != 4:
            return False
        if bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H):
            return False
        if bias.shape[2] != T or bias.shape[3] != k.shape[1]:
            return False
    return True


def _keep_mask(T, S, q_offset, limit, causal, window, mask, device):
    rows = q_offset + torch.arange(T, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    keep = cols < limit
    if causal:
        keep = keep & (cols <= rows)
    if window > 0:
        keep = keep & (rows - cols < window)
    keep = keep[None, None]
    if mask is not None:
        keep = keep & mask.bool()[:, None, None, :]
    return keep  # [B|1, 1, T, S]


def flash_forward_plain(q, k, v, bias=None, mask=None, q_offset: int = 0,
                        kv_len: Optional[int] = None, *, causal: bool = False,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the kernel: q pre-scaled [B,T,H,D], k/v
    [B,S,H,D]. Float32 scores; the probabilities are rounded to v's dtype
    before the PV product, as the TPU kernel does."""
    B, T, H, D = q.shape
    S = k.shape[1]
    limit = S if kv_len is None else kv_len
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()
    keep = _keep_mask(T, S, q_offset, limit, causal, window, mask, q.device)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)  # [B, H, T, 1]
    out = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    out = out / torch.where(l > 0, l, 1.0).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)), 0.0)
    return out.to(q.dtype), lse[..., 0]


def _flash_forward_cuda(q, k, v, bias, mask, q_offset, kv_len, causal,
                        window):
    B, T, H, D = q.shape
    S = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernel takes float32/bfloat16, got {q.dtype}")
    if D not in SUPPORTED_D:
        raise ValueError(f"flash kernel takes head_dim in {SUPPORTED_D}, "
                         f"got {D}")
    dev = q.device
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    sb = sh = 0
    if bias is not None:
        Bb, Hb = bias.shape[0], bias.shape[1]
        if Bb not in (1, B) or Hb not in (1, H):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"over [B={B}, H={H}]")
        check_tensor("bias", bias, dtype=q.dtype, shape=(Bb, Hb, T, S),
                     device=dev)
        sh = T * S if Hb > 1 else 0
        sb = Hb * T * S if Bb > 1 else 0
    if mask is not None:
        check_tensor("key_padding_mask", mask, dtype=torch.int32,
                     shape=(B, S), device=dev)
    limit = S if kv_len is None else min(int(kv_len), S)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    KERNEL.launch(
        "flash_fwd", ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask), ptr(out),
        ptr(lse), B, T, S, H, D, sb, sh, int(q_offset), limit, int(causal),
        int(window), _DTYPE_CODE[q.dtype], stream())
    return out, lse


def flash_forward(q, k, v, bias=None, mask=None, q_offset: int = 0,
                  kv_len: Optional[int] = None, *, causal: bool = False,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D], lse [B,H,T] f32) for pre-scaled q. `mask` is the
    int32/bool [B, S] key-padding mask (nonzero = valid)."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, bias, mask, q_offset, kv_len,
                                   causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    return _flash_forward_cuda(q, k, v, bias, mask, q_offset, kv_len, causal,
                               window)


# --------------------------------------------------------------------------- #
# Backward: kernels #6 (dq + dbias) and #7 (dk, dv)
# --------------------------------------------------------------------------- #

BWD_KERNEL_DQ = CudaKernel("flash_bwd.cu", {
    # q, k, v, dout, lse, delta, bias, mask, dq, dbias, B, T, S, H, D,
    # bias_sb, bias_sh, q_offset, limit, causal, window, acc_b, dtype, stream
    "flash_bwd_dq": [P] * 10 + [I] * 13 + [P],
})
BWD_KERNEL_DKV = CudaKernel("flash_bwd.cu", {
    # q, k, v, dout, lse, delta, bias, mask, dk, dv, B, T, S, H, D, bias_sb,
    # bias_sh, q_offset, limit, causal, window, dtype, stream
    "flash_bwd_dkv": [P] * 10 + [I] * 12 + [P],
})


# Runs of the head-broadcast-bias backward on the card, which recomputes
# through plain autograd as the JAX package does (`_flash_bwd` :1939-1943)
# and so has no CUDA kernel (and no CudaKernel counter) of its own.
BWD_RECOMPUTE_LAUNCHES = 0


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * out) in float32, [B, H, T] (JAX computes it outside the
    kernels too, :1726)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _reduce_to(ds: torch.Tensor, shape) -> torch.Tensor:
    """Sum [B, H, T, S] over the dims that `shape` broadcasts."""
    dims = [i for i in (0, 1) if shape[i] == 1 and ds.shape[i] > 1]
    return ds.sum(dims, keepdim=True) if dims else ds


def flash_backward_plain(q, k, v, bias, mask, q_offset: int,
                         kv_len: Optional[int], out, lse, do, *,
                         causal: bool = False, window: int = 0):
    """Plain torch twin of kernels #6 and #7: (dq, dk, dv, dbias) for
    pre-scaled q [B,T,H,D], k/v [B,S,H,D], the forward's out and lse
    [B,H,T] and the output gradient do. Recomputes p = exp(s - lse) under
    the mask; p, dp and ds are float32, ds is rounded to the inputs' dtype
    before the ds k and ds^T q products, p is not rounded before p^T dO (the
    TPU kernels' rounding, :1319-1341 and :1440-1459). dbias is float32,
    summed over the dims the bias broadcasts, None without a bias."""
    B, T, H, D = q.shape
    S = k.shape[1]
    limit = S if kv_len is None else min(int(kv_len), S)
    dt = q.dtype
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()
    keep = _keep_mask(T, S, q_offset, limit, causal, window, mask, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    dp = torch.einsum("bthd,bshd->bhts", dof, v.float())
    ds = p * (dp - _delta(out, do)[..., None])
    dsr = ds.to(dt).float()
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dk = torch.einsum("bhts,bthd->bshd", dsr, q.float())
    dq = torch.einsum("bhts,bshd->bthd", dsr, k.float())
    dbias = None if bias is None else _reduce_to(ds, bias.shape)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype), dbias


def _ref_attention(q, k, v, bias, mask, q_offset, limit, causal, window):
    """Differentiable plain attention on pre-scaled q, as the JAX
    `_ref_attention` (:1196): float32 logits, masked with NEG_INF (a fully
    masked row softmaxes to uniform here, unlike the kernels), probabilities
    rounded to q's dtype before the PV product."""
    B, T, H, D = q.shape
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()
    keep = _keep_mask(T, S, q_offset, limit, causal, window, mask, q.device)
    probs = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(),
                        v.float()).to(q.dtype)


def _needs_reduce(bias, B: int, H: int) -> bool:
    """The dispatch of `_flash_bwd` (:1928-1938): a head-broadcast bias
    (H > 1) recomputes through plain autograd; a batch-broadcast bias goes to
    the kernel, which sums dbias over the batch. The TPU's VMEM budget for
    that batch sum (:1933-1934) has no counterpart: the CUDA kernel sums in
    the dbias rows each block owns, at any S."""
    return bias is not None and bias.shape[1] == 1 and H > 1


def _flash_backward_cuda(q, k, v, bias, mask, q_offset, limit, out, lse, do,
                         causal, window, want_dbias):
    B, T, H, D = q.shape
    S = k.shape[1]
    dev = q.device
    if q.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"flash backward kernels take float32/bfloat16 and "
                         f"head_dim in {SUPPORTED_D}, got {q.dtype}, D={D}")
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    do = do.to(q.dtype).contiguous()
    check_tensor("dout", do, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("lse", lse, dtype=torch.float32, shape=(B, H, T), device=dev)
    delta = _delta(out, do)
    sb = sh = 0
    acc_b = 0
    dbias = None
    if bias is not None:
        Bb, Hb = bias.shape[0], bias.shape[1]
        check_tensor("bias", bias, dtype=q.dtype, shape=(Bb, Hb, T, S),
                     device=dev)
        sh = T * S if Hb > 1 else 0
        sb = Hb * T * S if Bb > 1 else 0
        if want_dbias:
            if Hb == 1 and H > 1:
                raise ValueError("the dq kernel does not sum dbias over "
                                 "heads; a head-broadcast bias recomputes "
                                 "(FlashAttentionFn)")
            dbias = torch.zeros((Bb, Hb, T, S), dtype=torch.float32,
                                device=dev)
            acc_b = int(Bb == 1 and B > 1)
    if mask is not None:
        check_tensor("key_padding_mask", mask, dtype=torch.int32,
                     shape=(B, S), device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = _DTYPE_CODE[q.dtype]
    common = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
              ptr(bias), ptr(mask))
    geom = (B, T, S, H, D, sb, sh, int(q_offset), limit, int(causal),
            int(window))
    BWD_KERNEL_DQ.launch("flash_bwd_dq", *common, ptr(dq), ptr(dbias), *geom,
                         acc_b, code, stream())
    BWD_KERNEL_DKV.launch("flash_bwd_dkv", *common, ptr(dk), ptr(dv), *geom,
                          code, stream())
    return dq, dk, dv, dbias


def flash_backward(q, k, v, bias, mask, q_offset: int,
                   kv_len: Optional[int], out, lse, do, *,
                   causal: bool = False, window: int = 0,
                   want_dbias: bool = True):
    """(dq, dk, dv, dbias) of `flash_forward`: kernels #6 and #7 on a CUDA
    tensor, `flash_backward_plain` on a CPU tensor. dbias (float32) is None
    without a bias or when not wanted."""
    if q.device.type == "cpu":
        dq, dk, dv, dbias = flash_backward_plain(
            q, k, v, bias, mask, q_offset, kv_len, out, lse, do,
            causal=causal, window=window)
        return dq, dk, dv, dbias if want_dbias else None
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward: unsupported device {q.device}")
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    S = k.shape[1]
    limit = S if kv_len is None else min(int(kv_len), S)
    return _flash_backward_cuda(q, k, v, bias, mask, q_offset, limit, out, lse,
                                do, causal, window,
                                want_dbias and bias is not None)


class FlashAttentionFn(torch.autograd.Function):
    """flash_forward (kernel #1) under autograd, saving out and lse; the
    backward is kernels #6 and #7 on CUDA tensors and their plain twin on
    CPU tensors, dispatched as the JAX custom VJP `_flash_bwd` (:1920)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, q_offset, kv_len, causal, window):
        out, lse = flash_forward(q, k, v, bias, mask, q_offset, kv_len,
                                 causal=causal, window=window)
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        ctx.geom = (q_offset, kv_len, causal, window)
        return out

    @staticmethod
    def backward(ctx, do):
        global BWD_RECOMPUTE_LAUNCHES
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        q_offset, kv_len, causal, window = ctx.geom
        B, T, H, D = q.shape
        S = k.shape[1]
        limit = S if kv_len is None else min(int(kv_len), S)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        if _needs_reduce(bias, B, H):
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (q, k, v, bias)]
                o = _ref_attention(*ins, mask, q_offset, limit, causal,
                                   window)
                dq, dk, dv, dbias = torch.autograd.grad(o, ins, do)
            if q.is_cuda:
                BWD_RECOMPUTE_LAUNCHES += 1
        elif bias is None and os.environ.get("UNILM_TPU_FUSED_BWD"):
            raise NotImplementedError(
                "UNILM_TPU_FUSED_BWD selects the one-pass backward "
                "`_bwd_fused_kernel` (kernel #8), not ported yet: ROADMAP "
                "Queue 2, schedule options of #6/#7")
        else:
            dq, dk, dv, dbias = flash_backward(
                q, k, v, bias, mask, q_offset, kv_len, out, lse, do,
                causal=causal, window=window, want_dbias=want_dbias)
        dbias = dbias.to(bias.dtype) if want_dbias else None
        return dq, dk, dv, dbias, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, H, D]
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,  # [B|1, H|1, T, S]
    key_padding_mask: Optional[torch.Tensor] = None,  # bool [B, S]
    scale: Optional[float] = None,
    causal: bool = False,
    q_offset: Optional[int] = None,
    kv_len: Optional[int] = None,
    window: int = 0,
) -> torch.Tensor:
    """Flash attention entry point; layout matches ops.attention.attention.
    q is scaled in its own dtype before the kernel, as the JAX entry
    point does (:2005), so bf16 rounding matches. Differentiable in q, k, v
    and bias (FlashAttentionFn)."""
    if os.environ.get("UNILM_TPU_TRI_FLASH"):
        raise NotImplementedError(
            "UNILM_TPU_TRI_FLASH selects the lower-triangle forward grid "
            "`_flash_tri_kernel` (kernel #2), not ported yet: ROADMAP Queue "
            "2, schedule option of #1")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttentionFn.apply(
        (q * scale).contiguous(), k.contiguous(), v.contiguous(), bias,
        key_padding_mask, 0 if q_offset is None else int(q_offset), kv_len,
        causal, window)


# --------------------------------------------------------------------------- #
# Fused encoder attention: kernel #3
# --------------------------------------------------------------------------- #

ENCODER_KERNEL = CudaKernel("encoder_attention.cu", {
    # q, k, v, bias, out, B, T, S, H, D, bias_sb, bias_sh, scale, dtype,
    # stream
    "encoder_attn_fwd": [P] * 5 + [I] * 7 + [F, I, P],
})
# the longest kv the kernel keeps as whole score rows in shared memory (the
# dispatcher's bound for the encoder branch, ops/attention.py)
ENCODER_MAX_S = 2048


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The encoder twins' working precision: float32 for bf16 and fp32
    inputs (the kernels' accumulators), float64 kept for gradcheck."""
    return t if t.dtype == torch.float64 else t.float()


def fused_encoder_attention_plain(q, k, v, bias=None,
                                  scale: Optional[float] = None):
    """Plain torch twin of kernel #3: softmax(scale q k^T + bias) v on
    q [B,T,H,D], k/v [B,S,H,D], bias [B|1,H|1,T,S]. Float32 scores; the
    probabilities are rounded to v's dtype and the row sum adds the rounded
    values, as the TPU kernel's exact path does (:622-623)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthd,bshd->bhts", _acc(q), _acc(k)) * scale
    if bias is not None:
        s = s + _acc(bias)
    p = _acc(torch.exp(s - s.amax(-1, keepdim=True)).to(v.dtype))
    l = p.sum(-1, keepdim=True).permute(0, 2, 1, 3)  # [B, T, H, 1]
    out = torch.einsum("bhts,bshd->bthd", p, _acc(v)) / l
    return out.to(q.dtype)


def _encoder_attention_cuda(q, k, v, bias, scale):
    B, T, H, D = q.shape
    S = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"encoder attention kernel takes float32/bfloat16, "
                         f"got {q.dtype}")
    if D not in SUPPORTED_D:
        raise ValueError(f"encoder attention kernel takes head_dim in "
                         f"{SUPPORTED_D}, got {D}")
    if not 0 < S <= ENCODER_MAX_S:
        raise ValueError(f"encoder attention kernel takes 0 < S <= "
                         f"{ENCODER_MAX_S} keys, got {S}")
    dev = q.device
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    sb = sh = 0
    if bias is not None:
        Bb, Hb = bias.shape[0], bias.shape[1]
        if Bb not in (1, B) or Hb not in (1, H):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"over [B={B}, H={H}]")
        check_tensor("bias", bias, dtype=q.dtype, shape=(Bb, Hb, T, S),
                     device=dev)
        sh = T * S if Hb > 1 else 0
        sb = Hb * T * S if Bb > 1 else 0
    out = torch.empty_like(q)
    ENCODER_KERNEL.launch(
        "encoder_attn_fwd", ptr(q), ptr(k), ptr(v), ptr(bias), ptr(out), B, T,
        S, H, D, sb, sh, float(scale), _DTYPE_CODE[q.dtype], stream())
    return out


def _encoder_forward(q, k, v, bias, scale):
    """Kernel #3 on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return fused_encoder_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_encoder_attention: unsupported device "
                         f"{q.device}")
    return _encoder_attention_cuda(q, k, v, bias, scale)


# --------------------------------------------------------------------------- #
# Its backward: kernel #4
# --------------------------------------------------------------------------- #

ENCODER_BWD_KERNEL = CudaKernel("encoder_attention_bwd.cu", {
    # q, k, v, dout, bias, dq, dk, dv, dbias, partial, stats, B, T, S, H, D,
    # bias_sb, bias_sh, bias_h, group, head_sum, scale, dtype, stream
    "encoder_attn_bwd": [P] * 11 + [I] * 10 + [F, I, P],
})
# A batch-summed dbias: the batch is cut into groups, one dq block per
# (64-row q tile, head, group) summing its group in order (a third launch
# adds the groups' planes), so that about this many blocks share the work.
# At BEiT-B (B=256) that is one batch item per group, at the price of
# 477 MB of transient partial planes; chip_smoke.py's encoder_bwd phase
# times it against 16x fewer blocks (PERF.md).
DBIAS_BLOCKS = 16896
_BWD_Q_TILE = 64  # query rows of a dq block (csrc/encoder_attention_bwd.cu BQ)


def fused_encoder_backward_plain(q, k, v, bias, do,
                                 scale: Optional[float] = None):
    """Plain torch twin of kernel #4: (dq, dk, dv, dbias) of
    `fused_encoder_attention` for the output gradient `do`. p is the exact
    float32 softmax of scale q k^T + bias, recomputed; dp = dO v^T,
    ds = p (dp - rowsum(p dp)); ds is rounded to k's dtype before the ds k
    and ds^T q products (each then times scale), p to dO's dtype before
    p^T dO (`_vit_bwd_kernel` :772-798). dbias is float32, ds summed over
    the dims the bias broadcasts; None without a bias."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthd,bshd->bhts", _acc(q), _acc(k)) * scale
    if bias is not None:
        s = s + _acc(bias)
    p = torch.softmax(s, dim=-1)
    dof = _acc(do)
    dp = torch.einsum("bthd,bshd->bhts", dof, _acc(v))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dsr = _acc(ds.to(k.dtype))
    dq = torch.einsum("bhts,bshd->bthd", dsr, _acc(k)) * scale
    dk = torch.einsum("bhts,bthd->bshd", dsr, _acc(q)) * scale
    dv = torch.einsum("bhts,bthd->bshd", _acc(p.to(do.dtype)), dof)
    dbias = None if bias is None else _reduce_to(ds, bias.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _encoder_backward_cuda(q, k, v, bias, do, scale, want_dbias):
    B, T, H, D = q.shape
    S = k.shape[1]
    if q.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"encoder attention backward kernel takes "
                         f"float32/bfloat16 and head_dim in {SUPPORTED_D}, "
                         f"got {q.dtype}, D={D}")
    if not 0 < S <= ENCODER_MAX_S:
        raise ValueError(f"encoder attention backward kernel takes 0 < S <= "
                         f"{ENCODER_MAX_S} keys, got {S}")
    dev = q.device
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("dout", do, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    sb = sh = 0
    Hb, group, head_sum = 1, 1, 0
    dbias = partial = None
    if bias is not None:
        Bb, Hb = bias.shape[0], bias.shape[1]
        if Bb not in (1, B) or Hb not in (1, H):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"over [B={B}, H={H}]")
        check_tensor("bias", bias, dtype=q.dtype, shape=(Bb, Hb, T, S),
                     device=dev)
        sh = T * S if Hb > 1 else 0
        sb = Hb * T * S if Bb > 1 else 0
        if want_dbias:
            dbias = torch.empty((Bb, Hb, T, S), dtype=torch.float32,
                                device=dev)
            head_sum = int(Hb == 1 and H > 1)
            if Bb == 1 and B > 1:
                blocks = -(-T // _BWD_Q_TILE) * (1 if head_sum else H)
                group = -(-B // min(B, -(-DBIAS_BLOCKS // blocks)))
                groups = -(-B // group)
                if groups > 1:
                    partial = torch.empty((groups, Hb, T, S),
                                          dtype=torch.float32, device=dev)
    stats = torch.empty((3, B, H, T), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ENCODER_BWD_KERNEL.launch(
        "encoder_attn_bwd", ptr(q), ptr(k), ptr(v), ptr(do), ptr(bias),
        ptr(dq), ptr(dk), ptr(dv), ptr(dbias), ptr(partial), ptr(stats), B, T,
        S, H, D, sb, sh, Hb, group, head_sum, float(scale),
        _DTYPE_CODE[q.dtype], stream())
    return dq, dk, dv, dbias


def fused_encoder_backward(q, k, v, bias, do, scale: Optional[float] = None,
                           *, want_dbias: bool = True):
    """(dq, dk, dv, dbias) of `fused_encoder_attention`: kernel #4 on a CUDA
    tensor, `fused_encoder_backward_plain` on a CPU tensor. dbias (float32,
    summed over the dims the bias broadcasts) is None without a bias or
    when not wanted."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        dq, dk, dv, dbias = fused_encoder_backward_plain(q, k, v, bias, do,
                                                         scale)
        return dq, dk, dv, dbias if want_dbias else None
    if q.device.type != "cuda":
        raise ValueError(f"fused_encoder_backward: unsupported device "
                         f"{q.device}")
    return _encoder_backward_cuda(q, k, v, bias, do.to(q.dtype).contiguous(),
                                  scale, want_dbias and bias is not None)


class EncoderAttentionFn(torch.autograd.Function):
    """Kernel #3 under autograd (the JAX custom VJP `_vit_fwd` / `_vit_bwd`,
    :933-975): the forward saves q, k, v and the bias, nothing else; the
    backward is kernel #4 on CUDA tensors and its plain twin on CPU
    tensors. dbias is computed only when the bias needs a gradient, and
    returned in the bias's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _encoder_forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = fused_encoder_backward(
            q, k, v, bias, do, ctx.scale, want_dbias=want_dbias)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None


def fused_encoder_attention(q, k, v, bias=None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal full-kv attention on q [B,T,H,D], k/v [B,S,H,D] with an
    additive bias [B|1,H|1,T,S]; scale defaults to D^-0.5. Differentiable
    in q, k, v and the bias (EncoderAttentionFn): kernels #3 and #4 on a
    CUDA tensor (S <= ENCODER_MAX_S; anything else they do not take
    raises), their plain twins on a CPU tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if bias is not None:
            bias = bias.to(q.dtype).contiguous()
    return EncoderAttentionFn.apply(q, k, v, bias, float(scale))
