"""Blocked document attention, forward and backward (port of
unilm_tpu/ops/doc_attention.py: `HeadMajorBias` :56, `_doc_fwd_kernel` :69 /
`_doc_fwd_impl` :251, `_doc_bwd_kernel` :108 / `doc_backward` :291, the
custom VJP `_doc_attention` :384-409, `doc_attention` :412 and `supports`
:427).

Non-causal, full-kv attention at S <= 2048 with a key-padding mask and/or
an additive bias: the LayoutLMv3 encoder (FUNSD: B=32, T=S=709, H=12, D=64,
a per-example head-major bias) and the Pix2Struct tower at <= 2048 patch
slots. The contract is the TPU kernels':

- the softmax in the exp2 domain: q times scale * log2(e), rounded to q's
  dtype, the bias times log2(e), a masked key at the finite -1e30, so a row
  whose keys are all masked averages v uniformly instead of giving NaN;
- the forward's probabilities rounded to v's dtype, the row sum adding the
  rounded values;
- the backward recomputes the scores, p is the fp32 natural softmax, delta
  = rowsum(p dp) (recomputed, not rowsum(dO out)), ds = p (dp - delta),
  rounded to k's dtype before ds k and ds^T q, p to dO's dtype before
  p^T dO; ds is the bias gradient, emitted in bf16 for bf16 inputs and in
  fp32 for fp32 inputs, and summed in fp32 over a broadcast batch or head
  axis outside the kernel, as the JAX package does (:370-381).

The bias is `[B|1, H|1, T, S]` or a `HeadMajorBias` wrapping `[H, B|1, T,
S]`. The kernels address either through a (batch, head) stride pair, so
head-major costs nothing: the wrapper passes the strides of a permuted
view. Padding T and S to the TPU's (8, 128) tiling is not carried.

On a CUDA tensor the wrappers launch csrc/doc_attention.cu (#9) and
csrc/doc_attention_bwd.cu (#10), or raise on what they do not take; on a
CPU tensor they run the plain twins `doc_attention_plain` and
`doc_backward_plain`. `DocAttentionFn` puts the pair under autograd, saving
q, k, v, the bias and the mask (the TPU kernel reads no residual).
"""

from __future__ import annotations

from typing import Optional

import torch

from unilm_tpu_torch.ops._native import (
    F, I, P, CudaKernel, check_tensor, ptr, stream)

NEG_INF = -1e30
LOG2E = 1.4426950408889634
MAX_S = 2048  # the longest kv of the dispatcher's doc branch (ops/attention.py)
SUPPORTED_D = (64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

FWD_KERNEL = CudaKernel("doc_attention.cu", {
    # q, k, v, bias, mask, out, B, T, S, H, D, bias_sb, bias_sh, scale,
    # dtype, stream
    "doc_attn_fwd": [P] * 6 + [I] * 7 + [F, I, P],
})
BWD_KERNEL = CudaKernel("doc_attention_bwd.cu", {
    # q, k, v, dout, bias, mask, dq, dk, dv, ds, stats, B, T, S, H, D,
    # bias_sb, bias_sh, ds_sb, ds_sh, scale, dtype, stream
    "doc_attn_bwd": [P] * 11 + [I] * 9 + [F, I, P],
})


# The bf16 backward's tiles (csrc/doc_attention_bwd.cu, namespace hop): q
# tiles of DOC_BWD_ROWS rows (two consumer warpgroups of 64), key tiles of
# 64, and the dk/dv launch's key blocks (two consumers of 64 keys at D = 64,
# one at D = 96 and 128) over 64-row q tiles.
DOC_BWD_ROWS = 128
DOC_BWD_TILE = 64


def doc_bwd_tile_plan(T: int, S: int, D: int = 64) -> dict:
    """The three launches of kernel #10's bf16 path as blocks of steps
    (r0, r1, c0, c1), a [r0, r1) x [c0, c1) tile of (query row, key)
    pairs each, in the order the block walks them:
    - "stats": a block per DOC_BWD_ROWS q rows, walking the 64-key tiles
      (the row statistics; the bias read once);
    - "dkv": a block per key block (128 keys at D = 64, else 64), walking
      the 64-row q tiles (ds written, dk and dv);
    - "dq": a block per DOC_BWD_ROWS q rows, walking the 64-key tiles of
      the ds plane (dq).
    Each launch visits every pair once; the ragged tiles at T and S hold
    only the rows and keys that exist."""
    rows, tile = DOC_BWD_ROWS, DOC_BWD_TILE
    kblock = 2 * tile if D == 64 else tile

    def walk(n_outer, step_outer, n_inner, step_inner, outer_rows):
        out = []
        for o in range(0, n_outer, step_outer):
            o1 = min(o + step_outer, n_outer)
            steps = []
            for i in range(0, n_inner, step_inner):
                i1 = min(i + step_inner, n_inner)
                steps.append((o, o1, i, i1) if outer_rows else (i, i1, o, o1))
            out.append(steps)
        return out

    return {"stats": walk(T, rows, S, tile, True),
            "dkv": walk(S, kblock, T, tile, False),
            "dq": walk(T, rows, S, tile, True)}


# The bf16 forward's tiles (csrc/doc_attention.cu, namespace hop, `FwdGeo`):
# a block per DOC_FWD_ROWS q rows (two consumer warpgroups of 64), 64-key
# tiles swept twice through one ring of K, V and bias tiles.
DOC_FWD_ROWS = 128
DOC_FWD_TILE = 64
_SMEM_MAX = 232448  # bytes of shared memory a block may opt into


def doc_fwd_tile_plan(T: int, S: int, D: int = 64, bias: bool = True) -> dict:
    """Kernel #9's bf16 path (csrc/doc_attention.cu `doc_fwd_sm90`, whose
    `FwdGeo` and walk compute this rule: change both together) for one
    (batch, head), its blocks in grid order. Each block:
    - "rows": its q rows [q0, q1) (q1 <= T), "consumers": the [r0, r1) of
      each consumer warpgroup with rows (64 each; one past T has none);
      the consumers read their q rows into registers once;
    - "loads": what the producer stages into shared memory, in ring order:
      for each ring step ("k", c0, c1), in the second sweep ("v", c0, c1),
      and with a bias ("bias", q0, q1, c0, c1) in both sweeps;
    - "steps": (sweep, r0, r1, c0, c1), each consumer's pairs per tile:
      sweep 0 takes the row max, sweep 1 p and P V.
    "stages" and "smem" are the ring's depth and the block's shared memory
    in bytes (the kernel's static_assert holds it within the card's)."""
    rows, tile, half = DOC_FWD_ROWS, DOC_FWD_TILE, DOC_FWD_ROWS // 2
    stages = 3 if D == 128 else 4
    smem = (stages * (2 * tile * D * 2 + rows * (tile // 8 + 1) * 16)
            + (MAX_S // tile) * (tile // 32) * 4 + 2 * stages * 8 + 1024)
    blocks = []
    for q0 in range(0, T, rows):
        q1 = min(q0 + rows, T)
        cons = [(r0, min(r0 + half, T)) for r0 in range(q0, q0 + rows, half)
                if r0 < T]
        loads, steps = [], []
        for sweep in (0, 1):
            for c0 in range(0, S, tile):
                c1 = min(c0 + tile, S)
                loads.append(("k", c0, c1))
                if sweep:
                    loads.append(("v", c0, c1))
                if bias:
                    loads.append(("bias", q0, q1, c0, c1))
                steps += [(sweep, r0, r1, c0, c1) for r0, r1 in cons]
        blocks.append({"rows": (q0, q1), "consumers": cons, "loads": loads,
                       "steps": steps})
    return {"rows": rows, "tile": tile, "stages": stages, "smem": smem,
            "blocks": blocks}


class HeadMajorBias:
    """Marks a bias stored [H, B|1, T, S] instead of [B|1, H, T, S]: the
    natural output order of the bias lookup (ops/bucket_bias.py
    `materialize_bias`). A plain object, not a tuple:
    core/transformer.py's Encoder reads a tuple as one bias per layer."""

    __slots__ = ("hbts",)

    def __init__(self, hbts: torch.Tensor):
        self.hbts = hbts

    def bhts(self) -> torch.Tensor:
        """The same bias as a [B|1, H, T, S] view (no copy)."""
        return self.hbts.permute(1, 0, 2, 3)


def _split(bias):
    """(tensor, head_major) of a bias argument."""
    if isinstance(bias, HeadMajorBias):
        return bias.hbts, True
    return bias, False


def _bhts(bias_t: Optional[torch.Tensor], hmajor: bool):
    """The bias as a [B|1, H|1, T, S] view."""
    if bias_t is None:
        return None
    return bias_t.permute(1, 0, 2, 3) if hmajor else bias_t


def supports(q: torch.Tensor, k: torch.Tensor, bias, *, causal: bool,
             window: int, kv_len, q_offset) -> bool:
    """Whether the kernels take this call: non-causal, full kv, S <= 2048,
    head_dim in SUPPORTED_D, fp32/bf16, a bias that broadcasts over
    [B, H, T, S]. The TPU's VMEM bounds (S <= 1024 with a per-head bias,
    H * D % 128) are TPU budgets and are not carried."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if causal or window or kv_len is not None or q_offset is not None:
        return False
    if not 0 < S <= MAX_S or D not in SUPPORTED_D or q.dtype not in _DTYPE_CODE:
        return False
    b = _bhts(*_split(bias))
    return b is None or (b.ndim == 4 and b.shape[0] in (1, B)
                         and b.shape[1] in (1, H)
                         and tuple(b.shape[2:]) == (T, S))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The twins' working precision: float32 (float64 kept for gradcheck)."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q, k, bias4, mask, scale):
    """exp2-domain scores [B, H, T, S]: (q * scale * log2(e) rounded to q's
    dtype) k^T + log2(e) bias, a masked key at NEG_INF."""
    qs = (_acc(q) * (scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bthd,bshd->bhts", _acc(qs), _acc(k))
    if bias4 is not None:
        s = s + _acc(bias4) * LOG2E
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    return s


def doc_attention_plain(q, k, v, bias=None, mask=None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain torch twin of kernel #9 on q [B,T,H,D], k/v [B,S,H,D], a bias
    [B|1,H|1,T,S] or HeadMajorBias, a bool [B, S] mask (True = valid).
    Float32 scores; p = exp2(s - max) rounded to v's dtype, the row sum of
    the rounded values."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, _bhts(*_split(bias)), mask, scale)
    p = _acc(torch.exp2(s - s.amax(-1, keepdim=True)).to(v.dtype))
    l = p.sum(-1, keepdim=True).permute(0, 2, 1, 3)  # [B, T, H, 1]
    return (torch.einsum("bhts,bshd->bthd", p, _acc(v)) / l).to(q.dtype)


def _reduce_ds(ds: torch.Tensor, bias_t: torch.Tensor, hmajor: bool):
    """ds [B, H, T, S] (or [H, B, T, S] head-major) summed in fp32 over the
    axes the bias broadcasts, in the bias's dtype and layout."""
    bdim, hdim = (1, 0) if hmajor else (0, 1)
    dims = [d for d in (bdim, hdim)
            if bias_t.shape[d] == 1 and ds.shape[d] > 1]
    if dims:
        ds = ds.float().sum(dims, keepdim=True)
    return ds.to(bias_t.dtype)


def doc_backward_plain(q, k, v, bias, mask, do,
                       scale: Optional[float] = None):
    """Plain torch twin of kernel #10: (dq, dk, dv, dbias) of
    `doc_attention_plain` for the output gradient `do` (the module
    docstring's rounding contract). dbias is ds in q's dtype, summed over
    the bias's broadcast axes, in the bias's layout and dtype; None without
    a bias."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias_t, hmajor = _split(bias)
    s = _scores(q, k, _bhts(bias_t, hmajor), mask, scale)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dof = _acc(do)
    dp = torch.einsum("bthd,bshd->bhts", dof, _acc(v))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dsr = _acc(ds.to(k.dtype))
    dq = torch.einsum("bhts,bshd->bthd", dsr, _acc(k)) * scale
    dk = torch.einsum("bhts,bthd->bshd", dsr, _acc(q)) * scale
    dv = torch.einsum("bhts,bthd->bshd", _acc(p.to(do.dtype)), dof)
    dbias = None
    if bias_t is not None:
        ds = ds.to(q.dtype)
        dbias = _reduce_ds(ds.permute(1, 0, 2, 3) if hmajor else ds, bias_t,
                           hmajor)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #

def _check_qkv(q, k, v, name):
    B, T, H, D = q.shape
    S = k.shape[1]
    if q.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"{name} takes float32/bfloat16 and head_dim in "
                         f"{SUPPORTED_D}, got {q.dtype}, D={D}")
    if not 0 < S <= MAX_S:
        raise ValueError(f"{name} takes 0 < S <= {MAX_S} keys, got {S}")
    dev = q.device
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    return B, T, S, H, D


def _bias_strides(bias_t, hmajor, q, B, H, T, S):
    """(batch stride, head stride) of the bias rows, 0 on a broadcast axis;
    raises unless each [T, S] plane is contiguous and in q's dtype."""
    if bias_t is None:
        return 0, 0
    b = _bhts(bias_t, hmajor)
    if (b.ndim != 4 or b.shape[0] not in (1, B) or b.shape[1] not in (1, H)
            or tuple(b.shape[2:]) != (T, S)):
        raise ValueError(f"bias {tuple(b.shape)} (as [B, H, T, S]) does not "
                         f"broadcast over [{B}, {H}, {T}, {S}]")
    if b.dtype != q.dtype or b.device != q.device:
        raise ValueError(f"bias is {b.dtype} on {b.device}, expected "
                         f"{q.dtype} on {q.device}")
    if b.stride(3) != 1 or b.stride(2) != S or not bias_t.is_contiguous():
        raise ValueError("bias must be contiguous")
    return (b.stride(0) if b.shape[0] > 1 else 0,
            b.stride(1) if b.shape[1] > 1 else 0)


def _mask_arg(mask, B, S, dev):
    if mask is None:
        return None
    mask = mask.to(torch.int32).contiguous()
    check_tensor("key_padding_mask", mask, dtype=torch.int32, shape=(B, S),
                 device=dev)
    return mask


def _doc_forward_cuda(q, k, v, bias_t, hmajor, mask, scale):
    B, T, S, H, D = _check_qkv(q, k, v, "doc attention kernel (#9)")
    sb, sh = _bias_strides(bias_t, hmajor, q, B, H, T, S)
    mask = _mask_arg(mask, B, S, q.device)
    out = torch.empty_like(q)
    FWD_KERNEL.launch("doc_attn_fwd", ptr(q), ptr(k), ptr(v), ptr(bias_t),
                      ptr(mask), ptr(out), B, T, S, H, D, sb, sh, float(scale),
                      _DTYPE_CODE[q.dtype], stream())
    return out


def _doc_backward_cuda(q, k, v, bias_t, hmajor, mask, do, scale):
    """(dq, dk, dv, ds): ds is the full [B, H, T, S] (head-major: [H, B,
    T, S]) plane in q's dtype, written whether or not there is a bias."""
    B, T, S, H, D = _check_qkv(q, k, v, "doc attention backward kernel (#10)")
    check_tensor("dout", do, dtype=q.dtype, shape=(B, T, H, D),
                 device=q.device)
    sb, sh = _bias_strides(bias_t, hmajor, q, B, H, T, S)
    mask = _mask_arg(mask, B, S, q.device)
    if hmajor:
        ds = torch.empty((H, B, T, S), dtype=q.dtype, device=q.device)
        ds_sb, ds_sh = T * S, B * T * S
    else:
        ds = torch.empty((B, H, T, S), dtype=q.dtype, device=q.device)
        ds_sb, ds_sh = H * T * S, T * S
    stats = torch.empty((3, B, H, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    BWD_KERNEL.launch(
        "doc_attn_bwd", ptr(q), ptr(k), ptr(v), ptr(do), ptr(bias_t),
        ptr(mask), ptr(dq), ptr(dk), ptr(dv), ptr(ds), ptr(stats), B, T, S, H,
        D, sb, sh, ds_sb, ds_sh, float(scale), _DTYPE_CODE[q.dtype], stream())
    return dq, dk, dv, ds


def _forward(q, k, v, bias_t, hmajor, mask, scale):
    """Kernel #9 on a CUDA tensor, its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return doc_attention_plain(
            q, k, v, HeadMajorBias(bias_t) if hmajor else bias_t, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"doc_attention: unsupported device {q.device}")
    return _doc_forward_cuda(q, k, v, bias_t, hmajor, mask, scale)


def _backward(q, k, v, bias_t, hmajor, mask, do, scale, want_dbias):
    """(dq, dk, dv, dbias): kernel #10 on a CUDA tensor, its plain twin on a
    CPU tensor; dbias reduced to the bias's shape, or None."""
    bias = HeadMajorBias(bias_t) if hmajor else bias_t
    if q.device.type == "cpu":
        dq, dk, dv, dbias = doc_backward_plain(q, k, v, bias, mask, do, scale)
        return dq, dk, dv, dbias if want_dbias else None
    if q.device.type != "cuda":
        raise ValueError(f"doc_backward: unsupported device {q.device}")
    dq, dk, dv, ds = _doc_backward_cuda(q, k, v, bias_t, hmajor, mask,
                                        do.to(q.dtype).contiguous(), scale)
    dbias = _reduce_ds(ds, bias_t, hmajor) if want_dbias else None
    return dq, dk, dv, dbias


def doc_backward(q, k, v, bias, mask, do, scale: Optional[float] = None):
    """(dq, dk, dv, dbias) of `doc_attention` for the output gradient `do`:
    kernel #10 on a CUDA tensor, `doc_backward_plain` on a CPU tensor.
    dbias (in the bias's layout and dtype, summed over its broadcast axes)
    is None without a bias."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias_t, hmajor = _split(bias)
    return _backward(q, k, v, bias_t, hmajor, mask, do, scale,
                     bias_t is not None)


class DocAttentionFn(torch.autograd.Function):
    """Kernel #9 under autograd (the JAX custom VJP `_doc_attention`,
    :384-409): the forward saves q, k, v, the bias tensor and the mask; the
    backward is kernel #10 on CUDA tensors and its plain twin on CPU
    tensors. dbias is reduced and returned only when the bias needs a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias_t, mask, scale, hmajor):
        ctx.save_for_backward(q, k, v, bias_t, mask)
        ctx.scale, ctx.hmajor = scale, hmajor
        return _forward(q, k, v, bias_t, hmajor, mask, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_t, mask = ctx.saved_tensors
        want = bias_t is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = _backward(q, k, v, bias_t, ctx.hmajor, mask, do,
                                      ctx.scale, want)
        return dq, dk, dv, dbias, None, None, None


def doc_attention(q, k, v, bias=None, key_padding_mask=None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal full-kv attention on q [B,T,H,D], k/v [B,S,H,D], S <=
    2048, with a bias [B|1,H|1,T,S] or HeadMajorBias([H,B|1,T,S]) and a
    bool [B, S] key-padding mask (True = valid); scale defaults to
    D^-0.5. Differentiable in q, k, v and the bias (DocAttentionFn):
    kernels #9 and #10 on a CUDA tensor (anything they do not take
    raises), their plain twins on a CPU tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bias_t, hmajor = _split(bias)
    if q.device.type == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if bias_t is not None:
            bias_t = bias_t.to(q.dtype).contiguous()
    return DocAttentionFn.apply(q, k, v, bias_t, key_padding_mask,
                                float(scale), hmajor)
