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
csrc/flash_fwd.cu (bf16: wgmma fed by a TMA ring, warp-specialised, over
the key tiles `flash_tile_plan` classifies; fp32: a CUDA-core body); on a
CPU tensor it runs `flash_forward_plain`, the same function in plain
torch. Nothing else selects the plain version.

`flash_attention` runs the forward under `FlashAttentionFn`, whose
backward takes (dq, dk, dv, dbias) from the two kernels of
csrc/flash_bwd.cu on a CUDA tensor and from `flash_backward_plain` on a
CPU tensor; a head-broadcast bias recomputes through plain autograd, as
JAX does.

The JAX package's two opt-in schedules are selected by the same
environment variables, read at call time, under the same conditions:
- UNILM_TPU_TRI_FLASH, on a causal call with window 0, no q_offset, no
  kv_len and T == S (JAX :2030-2032): the forward is `flash_forward_tri`,
  the lower-triangle schedule of `_flash_tri_kernel` (#2, :404;
  csrc/flash_tri.cu). Every other call runs #1 as without the variable.
- UNILM_TPU_FUSED_BWD, on a backward without a bias (`_flash_bwd`
  :1944-1948): dq, dk and dv come from `flash_backward_fused`, the
  one-pass `_bwd_fused_kernel` (#8, :1520; csrc/flash_bwd_fused.cu).
  JAX also requires `_fused_bwd_blocks` to fit the TPU core's VMEM
  (S * D * 8 <= 2 MB and a 13 MB block budget, :1496); that is a TPU
  budget and is not carried: #8 takes every S.
On CPU tensors both run their plain twins, which compute the same
function as #1's and #6/#7's (`flash_forward_tri_plain`,
`flash_backward_fused_plain`).

Short sequences take the one-pass forward `flash_forward_onepass`
(`_onepass_kernel`, #5, :978; csrc/onepass_attention.cu), which keeps
whole score rows on chip. `onepass_applies` is a copy of JAX's
`_onepass_profitable` (:1152): the TPU core's 8 MB VMEM budget for q/k/v
and the score plane, with T and S <= 2048. It is the one TPU budget the
port copies, because on the TPU it is the rule that picks which body
computes a flash call; copied, the port picks the kernel JAX picks, shape
for shape. `FlashAttentionFn` applies it after the triangle schedule and
before #1, in `_flash_impl`'s order (:1166-1180). #5's (out, lse) is #1's
function, so the backward does not change.

`fused_encoder_attention` (port of `fused_encoder_attention` :701,
`_vit_forward` :632 / `_vit_kernel` :580) is the encoder hot path:
non-causal, full kv, no key-padding mask, an exact softmax over whole
score rows, no lse (#3's bf16 kernel takes rows of more than 128 keys
tile by tile with an online softmax, within the bf16 tolerance of the
twin). It runs under `EncoderAttentionFn`, the custom VJP
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


ONEPASS_KERNEL = CudaKernel("onepass_attention.cu", {
    # q, k, v, bias, mask, out, lse, B, T, S, H, D, bias_sb, bias_sh,
    # q_offset, limit, causal, window, dtype, stream
    "onepass_attn_fwd": [P] * 7 + [I] * 12 + [P],
})


TRI_KERNEL = CudaKernel("flash_tri.cu", {
    # q, k, v, bias, mask, out, lse, B, T, H, D, bias_sb, bias_sh, dtype,
    # stream
    "flash_tri_fwd": [P] * 7 + [I] * 7 + [P],
})


def tri_applies(causal: bool, window: int, q_offset: Optional[int],
                kv_len: Optional[int], T: int, S: int) -> bool:
    """Does this call take the lower-triangle forward (#2)? JAX's
    condition (:2030-2032): UNILM_TPU_TRI_FLASH set, causal, window 0, no
    query offset, no kv_len, T == S."""
    return bool(os.environ.get("UNILM_TPU_TRI_FLASH")) and (
        causal and window == 0 and q_offset is None and kv_len is None
        and T == S)


def fused_applies(bias: Optional[torch.Tensor]) -> bool:
    """Does this backward take the one-pass kernel (#8)? JAX's condition
    (:1944-1948) without the TPU VMEM budget: no bias and
    UNILM_TPU_FUSED_BWD set."""
    return bias is None and bool(os.environ.get("UNILM_TPU_FUSED_BWD"))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# JAX's VMEM budget for the one-pass kernel (bytes; about half of the TPU
# core's 16 MB, leaving room for double-buffered q/k/v/out blocks), :1149
_ONEPASS_VMEM_BUDGET = 8 * 1024 * 1024


def onepass_applies(B: int, H: int, T: int, S: int, D: int, bias,
                    window: int, itemsize: int = 2) -> bool:
    """Does this flash call take the one-pass forward (#5)? A copy of
    JAX's `_onepass_profitable` (:1152-1163): T, S <= 2048 and
    double-buffered q/k/v at the operand's width (D padded to 128 lanes)
    plus four fp32 [Tp, Sp] planes and an fp32 bias plane per bias head
    within 8 MB. `itemsize` is the pre-scaled q's; B and window are
    unread, as in JAX."""
    if T > 2048 or S > 2048:
        return False
    Tp, Sp = _cdiv(T, 8) * 8, _cdiv(S, 128) * 128
    lanes_d = max(D, 128)
    qkv = 3 * H * max(Tp, Sp) * lanes_d * itemsize * 2
    plane = 4 * Tp * Sp * 4
    b = 0 if bias is None else bias.shape[1] * Tp * Sp * 4
    return qkv + plane + b <= _ONEPASS_VMEM_BUDGET


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


def _bias_strides(bias, B: int, H: int, T: int, S: int, dtype,
                  device) -> Tuple[int, int]:
    """Check a [B|1, H|1, T, S] bias for a kernel and return its (batch,
    head) element strides, 0 for a broadcast axis; (0, 0) without one."""
    if bias is None:
        return 0, 0
    Bb, Hb = bias.shape[0], bias.shape[1]
    if Bb not in (1, B) or Hb not in (1, H):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                         f"over [B={B}, H={H}]")
    check_tensor("bias", bias, dtype=dtype, shape=(Bb, Hb, T, S),
                 device=device)
    return (Hb * T * S if Bb > 1 else 0), (T * S if Hb > 1 else 0)


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


def flash_tile_plan(T: int, S: int, q_offset: int, limit: int, causal: bool,
                    window: int, BQ: int, BK: int):
    """Kernel #1's and #6's tile classification (csrc/flash_common.cuh
    `key_walk` and `tile_interior`, which compute the same rule: change
    both together): for each q tile of BQ rows, (j_begin, j_end,
    interior). Key tiles of BK keys outside [j_begin, j_end) are skipped:
    the walk never visits them and they hold no visible pair.
    interior[j - j_begin] is True for a tile
    whose every (row, key) pair is visible before the key-padding mask,
    which then takes the mask-free body; the rest are boundary tiles.
    Rows >= T do not count; `limit` is the valid kv prefix. The kernel
    walks a 128-row block's plan and classifies by each consumer's 64
    rows, the plan at BQ = 64; #6 walks 64-key tiles the same way."""
    limit = min(limit, S)
    plan = []
    for i in range(_cdiv(T, BQ)):
        lo = q_offset + i * BQ
        hi = q_offset + min(T, (i + 1) * BQ) - 1
        k_end = min(limit, hi + 1) if causal else limit
        k_begin = max(0, lo - window + 1) if window > 0 else 0
        j_begin = k_begin // BK
        j_end = max(_cdiv(k_end, BK) if k_end > 0 else 0, j_begin)
        interior = [
            c0 + BK <= limit and (not causal or c0 + BK - 1 <= lo)
            and (window <= 0 or hi - c0 < window)
            for c0 in range(j_begin * BK, j_end * BK, BK)]
        plan.append((j_begin, j_end, interior))
    return plan


def flash_bwd_tile_plan(T: int, S: int, q_offset: int, limit: int,
                        causal: bool, window: int, BQ: int, BK: int):
    """Kernel #7's tile walk, the transpose of `flash_tile_plan` (csrc/
    flash_common.cuh `q_walk` computes the same rule: change both together):
    for each key tile of BK keys, (i_begin, i_end, interior) over the q
    tiles of BQ rows. Key tile j is in q tile i's walk of `flash_tile_plan`
    exactly when i_begin <= i < i_end, and interior[i - i_begin] is that
    plan's interior flag for (i, j). The kernel walks a block's key tiles
    (64 keys per consumer warpgroup) as one tile of their width."""
    limit = min(limit, S)
    nq = _cdiv(T, BQ)
    plan = []
    for c0 in range(0, S, BK):
        c_last = c0 + BK - 1
        if c0 >= limit:
            i_begin = i_end = 0
        else:
            i_begin = 0
            if causal:  # the tile's first key must be <= a row's last row
                d = c0 - q_offset
                i_begin = nq if d >= T else max(d, 0) // BQ
            i_end = nq
            if window > 0:  # a tile's first row within window of the last key
                i_end = min(nq, max(_cdiv(c_last + window - q_offset, BQ), 0))
            i_end = max(i_end, i_begin)
        interior = []
        for i in range(i_begin, i_end):
            lo = q_offset + i * BQ
            hi = q_offset + min(T, (i + 1) * BQ) - 1
            interior.append(c0 + BK <= limit
                            and (not causal or c_last <= lo)
                            and (window <= 0 or hi - c0 < window))
        plan.append((i_begin, i_end, interior))
    return plan


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
    sb, sh = _bias_strides(bias, B, H, T, S, q.dtype, dev)
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


# #5's bf16 plan (csrc/onepass_attention.cu): the walk takes T <= 16 (a
# block of 8 warps per (batch, head), 32-key tiles a lane per key); longer
# q takes the wgmma rows (a block per 128 q rows, consumers of 64 rows,
# K/V chunks of 128 keys at D = 64 and 64 at D = 96 and 128)
ONEPASS_WALK_MAX_T, ONEPASS_WALK_WARPS, ONEPASS_WALK_TILE = 16, 8, 32
ONEPASS_ROWS, ONEPASS_CONSUMER_ROWS = 128, 64


def onepass_chunk(D: int) -> int:
    """Keys per K/V chunk of #5's wgmma rows (`Geo<D>::BK`)."""
    return 128 if D == 64 else 64


def onepass_tile_plan(T: int, S: int, q_offset: int, limit: int,
                      causal: bool, window: int, D: int = 64) -> dict:
    """Kernel #5's bf16 plan (csrc/onepass_attention.cu `launch_bf16`, the
    walk's key range and tiles, hop's `key_walk` ranges compute the same
    rule: change both together) for one (batch, head): {"route": "walk" or
    "wgmma", "blocks": [...]}, a block being {"staged": the key ranges
    (c0, c1) it reads, each once, keys < S; "steps": (r0, r1, c0, c1, who)
    the (row, key) rectangles it computes, in order, `who` the warp (walk)
    or the consumer (wgmma)}. The walk reads exactly the keys its rows can
    see; the wgmma block stages the chunks (`onepass_chunk(D)` keys) its
    rows can see and each consumer computes the chunks its 64 rows can
    see."""
    limit = min(limit, S)

    def key_range(lo, hi):  # absolute positions lo..hi
        k_end = min(limit, hi + 1) if causal else limit
        k_begin = max(0, lo - window + 1) if window > 0 else 0
        return k_begin, k_end

    if T <= ONEPASS_WALK_MAX_T:
        kb, ke = key_range(q_offset, q_offset + T - 1)
        w, t = ONEPASS_WALK_WARPS, ONEPASS_WALK_TILE
        steps = sorted(((0, T, c0, min(c0 + t, ke), (c0 - kb) // t % w)
                        for c0 in range(kb, ke, t)), key=lambda x: (x[4], x[2]))
        return {"route": "walk",
                "blocks": [{"staged": [(kb, ke)] if ke > kb else [],
                            "steps": steps}]}
    blocks, n = [], onepass_chunk(D)
    for q0 in range(0, T, ONEPASS_ROWS):
        jb, je = flash_tile_plan(T, S, q_offset, limit, causal, window,
                                 ONEPASS_ROWS, n)[q0 // ONEPASS_ROWS][:2]
        steps = []
        for cw, r0 in enumerate(range(q0, min(q0 + ONEPASS_ROWS, T),
                                      ONEPASS_CONSUMER_ROWS)):
            r1 = min(r0 + ONEPASS_CONSUMER_ROWS, T)
            cjb, cje = flash_tile_plan(r1 - r0, S, q_offset + r0, limit,
                                       causal, window, r1 - r0, n)[0][:2]
            steps += [(r0, r1, j * n, min(j * n + n, S), cw)
                      for j in range(max(cjb, jb), min(cje, je))]
        blocks.append({"staged": [(j * n, min(j * n + n, S))
                                  for j in range(jb, je)],
                       "steps": steps})
    return {"route": "wgmma", "blocks": blocks}


def flash_forward_onepass_plain(q, k, v, bias=None, mask=None,
                                q_offset: int = 0,
                                kv_len: Optional[int] = None, *,
                                causal: bool = False, window: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of kernel #5. `_onepass_kernel` computes #1's
    function with #1's rounding (p to v's dtype before the PV product, the
    row sum of the unrounded p, out = 0 and lse = 0 for a row with no kept
    key, :1047-1058); its fast path (:1025-1045) is the same function in
    the exp2 domain. So this is `flash_forward_plain`."""
    return flash_forward_plain(q, k, v, bias, mask, q_offset, kv_len,
                               causal=causal, window=window)


def _flash_forward_onepass_cuda(q, k, v, bias, mask, q_offset, kv_len,
                                causal, window):
    B, T, H, D = q.shape
    S = k.shape[1]
    if q.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"one-pass attention kernel takes float32/bfloat16 "
                         f"and head_dim in {SUPPORTED_D}, got {q.dtype}, "
                         f"D={D}")
    if not 0 < S <= ENCODER_MAX_S:
        raise ValueError(f"one-pass attention kernel takes 0 < S <= "
                         f"{ENCODER_MAX_S} keys, got {S}")
    if q_offset < 0:
        raise ValueError(f"one-pass attention kernel takes q_offset >= 0, "
                         f"got {q_offset}")
    dev = q.device
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    sb, sh = _bias_strides(bias, B, H, T, S, q.dtype, dev)
    if mask is not None:
        check_tensor("key_padding_mask", mask, dtype=torch.int32,
                     shape=(B, S), device=dev)
    limit = S if kv_len is None else min(int(kv_len), S)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    ONEPASS_KERNEL.launch(
        "onepass_attn_fwd", ptr(q), ptr(k), ptr(v), ptr(bias), ptr(mask),
        ptr(out), ptr(lse), B, T, S, H, D, sb, sh, int(q_offset), limit,
        int(causal), int(window), _DTYPE_CODE[q.dtype], stream())
    return out, lse


def flash_forward_onepass(q, k, v, bias=None, mask=None, q_offset: int = 0,
                          kv_len: Optional[int] = None, *,
                          causal: bool = False, window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D], lse [B,H,T] f32) of `flash_forward`'s function:
    kernel #5 on a CUDA tensor (S <= 2048; anything it does not take
    raises), its plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_forward_onepass_plain(q, k, v, bias, mask, q_offset,
                                           kv_len, causal=causal,
                                           window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward_onepass: unsupported device "
                         f"{q.device}")
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    return _flash_forward_onepass_cuda(q, k, v, bias, mask, q_offset, kv_len,
                                       causal, window)


# q rows and keys per tile of #2's bf16 kernel (csrc/flash_tri.cu BQ == BK)
TRI_TILE = 128


def tri_fold_plan(T: int, tile: int = TRI_TILE):
    """Kernel #2's folded walk (csrc/flash_tri.cu `pair_tiles` and the walks
    of `producer` and `consumer_tile` compute the same rule: change both
    together). Of nq = ceil(T / tile) q tiles, block c of ceil(nq / 2)
    takes q tile nq-1-c, then q tile c (once where the two are the same
    tile, the middle block of an odd nq), and walks k tiles 0..i of each.
    Returns, for each block, its (q tile, k tile, diagonal) steps in the
    order its K/V ring streams them; only a step with `diagonal` set
    evaluates the causal predicate."""
    nq = _cdiv(T, tile)
    plan = []
    for c in range(_cdiv(nq, 2)):
        tiles = [nq - 1 - c] if c == nq - 1 - c else [nq - 1 - c, c]
        plan.append([(i, j, j == i) for i in tiles for j in range(i + 1)])
    return plan


def flash_forward_tri_plain(q, k, v, bias=None, mask=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of kernel #2: #1's function with causal fixed
    (T == S, no offset, no kv_len). The TPU kernel computes the same
    function with the same rounding (p to v's dtype before the PV product,
    :463-467), so this is `flash_forward_plain(..., causal=True)`."""
    return flash_forward_plain(q, k, v, bias, mask, 0, None, causal=True)


def _flash_forward_tri_cuda(q, k, v, bias, mask):
    B, T, H, D = q.shape
    if q.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"triangle flash kernel takes float32/bfloat16 and "
                         f"head_dim in {SUPPORTED_D}, got {q.dtype}, D={D}")
    dev = q.device
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    sb, sh = _bias_strides(bias, B, H, T, T, q.dtype, dev)
    if mask is not None:
        check_tensor("key_padding_mask", mask, dtype=torch.int32,
                     shape=(B, T), device=dev)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    TRI_KERNEL.launch("flash_tri_fwd", ptr(q), ptr(k), ptr(v), ptr(bias),
                      ptr(mask), ptr(out), ptr(lse), B, T, H, D, sb, sh,
                      _DTYPE_CODE[q.dtype], stream())
    return out, lse


def flash_forward_tri(q, k, v, bias=None, mask=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the causal self-attention q [B,T,H,D] (pre-scaled),
    k/v [B,T,H,D]: kernel #2 on a CUDA tensor, its plain twin on a CPU
    tensor. `mask` is the int32/bool [B, T] key-padding mask."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"the triangle schedule takes T == S, got "
                         f"T={q.shape[1]}, S={k.shape[1]}")
    if q.device.type == "cpu":
        return flash_forward_tri_plain(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward_tri: unsupported device {q.device}")
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
    return _flash_forward_tri_cuda(q, k, v, bias, mask)


# --------------------------------------------------------------------------- #
# Backward: kernels #6 (dq + dbias) and #7 (dk, dv)
# --------------------------------------------------------------------------- #

BWD_KERNEL_DQ = CudaKernel("flash_bwd.cu", {
    # q, k, v, dout, lse, delta, bias, mask, dq, dbias, B, T, S, H, D,
    # bias_sb, bias_sh, q_offset, limit, causal, window, acc_b, delta_mode,
    # dtype, stream
    "flash_bwd_dq": [P] * 10 + [I] * 14 + [P],
})
# #6's delta sweep alone (bf16): kernel #8's exact delta, counted apart from
# #6's own launches
BWD_KERNEL_DELTA = CudaKernel("flash_bwd.cu", {
    # q, k, v, dout, lse, delta, mask, B, T, S, H, D, q_offset, limit,
    # causal, window, stream
    "flash_bwd_delta": [P] * 7 + [I] * 9 + [P],
})
# csrc/flash_bwd.cuh `delta_mode`: #6 sums rowsum(p dp) itself, or reads
# the caller's delta
DELTA_SWEEP, DELTA_GIVEN = 0, 1
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
    """rowsum(dO * out) in float32, [B, H, T], as JAX computes it outside
    its kernels (:1726): the fp32 kernels' delta (#6/#7 and #8). From a
    bf16 out it loses a near-uniform row's q and k gradients; in bf16 #6
    takes rowsum(p dp) itself, and #8 takes it from #6's sweep."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _reduce_to(ds: torch.Tensor, shape) -> torch.Tensor:
    """Sum [B, H, T, S] over the dims that `shape` broadcasts."""
    dims = [i for i in (0, 1) if shape[i] == 1 and ds.shape[i] > 1]
    return ds.sum(dims, keepdim=True) if dims else ds


def flash_backward_plain(q, k, v, bias, mask, q_offset: int,
                         kv_len: Optional[int], out, lse, do, *,
                         causal: bool = False, window: int = 0,
                         delta: Optional[torch.Tensor] = None):
    """Plain torch twin of kernels #6 and #7: (dq, dk, dv, dbias) for
    pre-scaled q [B,T,H,D], k/v [B,S,H,D], the forward's out and lse
    [B,H,T] and the output gradient do. Recomputes p = exp(s - lse) under
    the mask; p, dp and ds are float32, ds is rounded to the inputs' dtype
    before the ds k and ds^T q products, p is not rounded before p^T dO (the
    TPU kernels' rounding, :1319-1341 and :1440-1459). ds = p (dp - delta)
    with the kernels' delta: rowsum(p dp) in bf16, as #6 takes it,
    rowsum(dO out) in float32 (the same to fp32 rounding, and nearer
    autograd's where lse is large), unless `delta` [B, H, T] is given
    (the ring's chunks pass their row's). dbias is float32, summed over
    the dims the bias broadcasts, None without a bias."""
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
    if delta is None:
        delta = (_delta(out, do) if dt == torch.float32 else
                 (p * dp).sum(-1))
    ds = p * (dp - delta[..., None])
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
                         causal, window, want_dbias, delta=None):
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
    # bf16 without a caller's delta: #6 writes rowsum(p dp) here and #7
    # reads it
    mode = DELTA_GIVEN
    if delta is not None:
        check_tensor("delta", delta, dtype=torch.float32, shape=(B, H, T),
                     device=dev)
    elif q.dtype == torch.float32:
        delta = _delta(out, do)
    else:
        delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
        mode = DELTA_SWEEP
    sb, sh = _bias_strides(bias, B, H, T, S, q.dtype, dev)
    acc_b = 0
    dbias = None
    if bias is not None:
        Bb, Hb = bias.shape[0], bias.shape[1]
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
                         acc_b, mode, code, stream())
    BWD_KERNEL_DKV.launch("flash_bwd_dkv", *common, ptr(dk), ptr(dv), *geom,
                          code, stream())
    return dq, dk, dv, dbias


def flash_backward(q, k, v, bias, mask, q_offset: int,
                   kv_len: Optional[int], out, lse, do, *,
                   causal: bool = False, window: int = 0,
                   want_dbias: bool = True,
                   delta: Optional[torch.Tensor] = None):
    """(dq, dk, dv, dbias) of `flash_forward`: kernels #6 and #7 on a CUDA
    tensor, `flash_backward_plain` on a CPU tensor. dbias (float32) is None
    without a bias or when not wanted. `delta` [B, H, T] float32: the
    caller's rowsum of p dp over the row's keys (the ring's chunks, which
    see a part of them); by default the backward takes it itself."""
    if q.device.type == "cpu":
        dq, dk, dv, dbias = flash_backward_plain(
            q, k, v, bias, mask, q_offset, kv_len, out, lse, do,
            causal=causal, window=window, delta=delta)
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
                                want_dbias and bias is not None, delta)


# --------------------------------------------------------------------------- #
# The one-pass backward: kernel #8 (dq, dk, dv; no bias)
# --------------------------------------------------------------------------- #

FUSED_BWD_KERNEL = CudaKernel("flash_bwd_fused.cu", {
    # q, k, v, dout, lse, delta, mask, dq, dk, dv, dq_acc, turns, B, T, S, H,
    # D, q_offset, limit, causal, window, dtype, stream
    "flash_bwd_fused": [P] * 12 + [I] * 10 + [P],
})
# The bf16 kernel's geometry (csrc/flash_bwd_fused.cu `FusedGeo`): 64-row
# q tiles, one turn counter each (the fp32 body's row tiles are 64 too), and
# key blocks of 128 keys at D = 64 (two consumer warpgroups), 64 at 96/128.
FUSED_BWD_ROWS = 64
_FUSED_MIN_STEP = FUSED_BWD_ROWS  # the row step of a turn counter


def fused_bwd_plan(T: int, S: int, D: int, causal: bool, window: int,
                   q_offset: int, limit: int) -> dict:
    """Kernel #8's bf16 walk and dq turn order (csrc/flash_bwd_fused.cu
    `block_of`, `block_walk` and the writer's `key_walk` target compute
    this rule: change both together). "blocks" in grid (linear) order, the
    key blocks reversed: each {"key_block": j, "keys": (c0, c1) clipped at
    S, "steps": [(i, target), ...]}: the 64-row q tiles i it walks
    upward (`flash_bwd_tile_plan` at the block's width: its K and V stay
    resident, Q/dO tiles i are staged once each) and, for each, the count
    of key blocks that add into row tile i's dq before it (the turn it
    waits for: every later key block that sees the tile). "consumers":
    the 64-key warpgroups of a block."""
    rows = FUSED_BWD_ROWS
    keys = 2 * rows if D == 64 else rows
    limit = min(limit, S)
    fwd = flash_tile_plan(T, S, q_offset, limit, causal, window, rows, keys)
    bwd = flash_bwd_tile_plan(T, S, q_offset, limit, causal, window, rows,
                              keys)
    nkb = _cdiv(S, keys)
    blocks = []
    for n in range(nkb):
        j = nkb - 1 - n
        ib, ie, _ = bwd[j]
        blocks.append({"key_block": j,
                       "keys": (j * keys, min(S, (j + 1) * keys)),
                       "steps": [(i, fwd[i][1] - 1 - j)
                                 for i in range(ib, ie)]})
    return {"rows": rows, "keys": keys, "consumers": keys // rows,
            "blocks": blocks}


def flash_backward_fused_plain(q, k, v, mask, q_offset: int,
                               kv_len: Optional[int], out, lse, do, *,
                               causal: bool = False, window: int = 0):
    """Plain torch twin of kernel #8: (dq, dk, dv) of `flash_forward`
    without a bias. `_bwd_fused_kernel`'s contract is the split pair's:
    p = exp(s - lse) under the mask, not rounded before p^T dO; ds =
    p (dp - delta) in fp32, rounded to the inputs' dtype before ds k and
    ds^T q (:1598-1611); so this is `flash_backward_plain` with no bias,
    and with its delta: rowsum(dO out) in fp32 (JAX's), and in bf16 the
    exact rowsum(p dp) that #6's sweep gives the kernel (JAX's from the
    bf16 out loses a near-uniform row's q and k gradients)."""
    return flash_backward_plain(q, k, v, None, mask, q_offset, kv_len, out,
                                lse, do, causal=causal, window=window)[:3]


def _flash_backward_fused_cuda(q, k, v, mask, q_offset, limit, out, lse, do,
                               causal, window):
    B, T, H, D = q.shape
    S = k.shape[1]
    dev = q.device
    if q.dtype not in _DTYPE_CODE or D not in SUPPORTED_D:
        raise ValueError(f"fused flash backward kernel takes float32/"
                         f"bfloat16 and head_dim in {SUPPORTED_D}, got "
                         f"{q.dtype}, D={D}")
    if q_offset < 0:
        raise ValueError(f"fused flash backward kernel takes q_offset >= 0, "
                         f"got {q_offset}")
    check_tensor("q", q, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("k", k, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    check_tensor("v", v, dtype=q.dtype, shape=(B, S, H, D), device=dev)
    do = do.to(q.dtype).contiguous()
    check_tensor("dout", do, dtype=q.dtype, shape=(B, T, H, D), device=dev)
    check_tensor("lse", lse, dtype=torch.float32, shape=(B, H, T), device=dev)
    if mask is not None:
        check_tensor("key_padding_mask", mask, dtype=torch.int32,
                     shape=(B, S), device=dev)
    if q.dtype == torch.float32:
        delta = _delta(out, do)
    else:
        # the exact rowsum(p dp), from #6's delta sweep launched alone
        delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
        BWD_KERNEL_DELTA.launch(
            "flash_bwd_delta", ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
            ptr(delta), ptr(mask), B, T, S, H, D, int(q_offset), limit,
            int(causal), int(window), stream())
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # scratch the launcher zeroes: one turn counter per (batch, head, row
    # step) and, for bf16, the fp32 dq accumulator
    turns = torch.empty(B * H * -(-T // _FUSED_MIN_STEP), dtype=torch.int32,
                        device=dev)
    dq_acc = (None if q.dtype == torch.float32 else
              torch.empty((B, T, H, D), dtype=torch.float32, device=dev))
    FUSED_BWD_KERNEL.launch(
        "flash_bwd_fused", ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
        ptr(delta), ptr(mask), ptr(dq), ptr(dk), ptr(dv), ptr(dq_acc),
        ptr(turns), B, T, S, H, D, int(q_offset), limit, int(causal),
        int(window), _DTYPE_CODE[q.dtype], stream())
    return dq, dk, dv


def flash_backward_fused(q, k, v, mask, q_offset: int,
                         kv_len: Optional[int], out, lse, do, *,
                         causal: bool = False, window: int = 0):
    """(dq, dk, dv) of a bias-free `flash_forward`: kernel #8 on a CUDA
    tensor, `flash_backward_fused_plain` on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_backward_fused_plain(q, k, v, mask, q_offset, kv_len,
                                          out, lse, do, causal=causal,
                                          window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward_fused: unsupported device "
                         f"{q.device}")
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    S = k.shape[1]
    limit = S if kv_len is None else min(int(kv_len), S)
    return _flash_backward_fused_cuda(q, k, v, mask, q_offset, limit, out,
                                      lse, do, causal, window)


class FlashAttentionFn(torch.autograd.Function):
    """The flash forward under autograd, saving out and lse, chosen in
    `_flash_impl`'s order (:1166-1180): #2 where `tri` (the caller's
    `tri_applies`) says so, else #5 where `onepass_applies`, else #1;
    `ctx.forward` names the one that ran ("tri", "onepass" or "flash").
    The backward is dispatched as the JAX custom VJP `_flash_bwd` (:1920):
    kernels #6 and #7, or #8 where `fused_applies`, on CUDA tensors, their
    plain twins on CPU tensors. #2 and #5 return the same (out, lse) pair
    as #1, so either backward follows any forward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, q_offset, kv_len, causal, window,
                tri):
        B, T, H, D = q.shape
        if tri:
            ctx.forward = "tri"
            out, lse = flash_forward_tri(q, k, v, bias, mask)
        elif onepass_applies(B, H, T, k.shape[1], D, bias, window,
                             q.element_size()):
            ctx.forward = "onepass"
            out, lse = flash_forward_onepass(q, k, v, bias, mask, q_offset,
                                             kv_len, causal=causal,
                                             window=window)
        else:
            ctx.forward = "flash"
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
        elif fused_applies(bias):
            dq, dk, dv = flash_backward_fused(
                q, k, v, mask, q_offset, kv_len, out, lse, do, causal=causal,
                window=window)
        else:
            dq, dk, dv, dbias = flash_backward(
                q, k, v, bias, mask, q_offset, kv_len, out, lse, do,
                causal=causal, window=window, want_dbias=want_dbias)
        dbias = dbias.to(bias.dtype) if want_dbias else None
        return dq, dk, dv, dbias, None, None, None, None, None, None


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
    and bias (FlashAttentionFn). The schedule variables are read here, on
    the call's own geometry, before q_offset defaults to 0."""
    tri = tri_applies(causal, window, q_offset, kv_len, q.shape[1],
                      k.shape[1])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttentionFn.apply(
        (q * scale).contiguous(), k.contiguous(), v.contiguous(), bias,
        key_padding_mask, 0 if q_offset is None else int(q_offset), kv_len,
        causal, window, tri)


# --------------------------------------------------------------------------- #
# Fused encoder attention: kernel #3
# --------------------------------------------------------------------------- #

ENCODER_KERNEL = CudaKernel("encoder_attention.cu", {
    # q, k, v, bias, out, B, T, S, H, D, bias_sb, bias_sh, scale, dtype,
    # stream
    "encoder_attn_fwd": [P] * 5 + [I] * 7 + [F, I, P],
})
# the longest kv #3 takes: its fp32 body keeps whole score rows in shared
# memory (the dispatcher's bound for the encoder branch, ops/attention.py)
ENCODER_MAX_S = 2048


# #3's bf16 kernel (csrc/encoder_attention.cu): q rows per consumer
# warpgroup (two a 128-row group) and keys per K/V tile (the S = Q K^T
# product's width)
ENCODER_ROWS, ENCODER_TILE = 64, 128


def encoder_tile_plan(T: int, S: int):
    """Kernel #3's bf16 plan (csrc/encoder_attention.cu `producer`,
    `consumer` and `tile` compute the same rule: change both together):
    (mode, steps). Each row group of 128 (two consumers of 64 rows) takes
    the K/V tiles of 128 keys in turn. mode "whole" (S <= 128): one tile
    holds the whole row, an exact softmax; "streamed": the online softmax
    over the tiles. steps: one (row_begin, row_end, key_begin, key_end,
    keys_computed) per (row group, consumer, key tile) with rows < T: the
    consumer's rows, the tile's keys < S, and the keys its products run
    over, the whole tile (K and V read as zeros past S, and p is 0
    there)."""
    steps = []
    for r0 in range(0, T, ENCODER_ROWS):  # consumer 0 and 1 of each group
        for c0 in range(0, S, ENCODER_TILE):
            steps.append((r0, min(r0 + ENCODER_ROWS, T), c0,
                          min(c0 + ENCODER_TILE, S), ENCODER_TILE))
    return ("whole" if S <= ENCODER_TILE else "streamed"), steps


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
    sb, sh = _bias_strides(bias, B, H, T, S, q.dtype, dev)
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
    # q, k, v, dout, bias, dq, dk, dv, dbias, partial, stats, ds, B, T, S, H,
    # D, bias_sb, bias_sh, bias_h, group, head_sum, scale, dtype, stream
    "encoder_attn_bwd": [P] * 12 + [I] * 10 + [F, I, P],
})

# #4's bf16 kernels (csrc/encoder_attention_bwd.cu, namespace hop): the
# statistics and dq launches take items of 128 q rows over key tiles
# (`_enc_bwd_key_tiles`), the dk/dv launch key blocks of ENC_BWD_ROWS keys
# per consumer warpgroup (two at D = 64, one at D = 96 and 128) over
# 64-row q tiles, with a dbias tile of [keys, tp] fp32 in shared memory
# where it fits.
ENC_BWD_ROWS, ENC_BWD_QTILE = 64, 128
_SMEM_MAX = 232448  # bytes of shared memory a block may opt into
H100_SMS = 132


def _enc_bwd_key_tiles(D: int):
    """Keys per tile of #4's statistics and dq launches (`StatGeo<D>::BK`,
    `DqGeo<D>::BK`)."""
    return (128 if D == 64 else 64), 64


def _enc_bwd_dkv_smem(D: int) -> int:
    """`DkvGeo<D>::SMEM`: the dk/dv launch's shared memory without the
    dbias tile (K and V; per ring stage q, dO, a bias tile and 3 x 64
    statistics; the barriers; 1024 bytes of alignment slack)."""
    bkb, nst = (128, 2) if D == 64 else (64, 3)
    bias_row = (bkb // 8 + 1) * 16  # hopper.cuh Plane<bkb>::BYTES_PER_ROW
    stage = 2 * 64 * D * 2 + 64 * bias_row + 3 * 64 * 4
    return 2 * bkb * D * 2 + nst * stage + (2 + 2 * nst) * 8 + 1024


def enc_bwd_plan(B: int, T: int, S: int, H: int, D: int = 64,
                 bias_shape=None, want_dbias: bool = True,
                 sms: int = H100_SMS) -> dict:
    """Kernel #4's grouping (csrc/encoder_attention_bwd.cu: `launch`,
    `item_bh` and `acc_stride` compute the same rule: change both
    together) for a [Bb, Hb, T, S] bias (`bias_shape`, None without one):
    - "group", "groups": a batch-summed dbias (Bb = 1 < B) is summed in
      groups of `group` batch items, sized for about two dk/dv blocks an
      SM; otherwise every batch item is a group of one. The fp32 launches
      take the same groups.
    - "head_sum": a head-broadcast dbias (Hb = 1 < H) is summed by blocks
      that loop over every head.
    - "blocks": the dk/dv launch's grid, key blocks x (1 or H) x groups.
    - "partial_bytes": the groups' fp32 planes when more than one group
      sums the batch (0 otherwise), which the last launch adds in group
      order.
    - "tp": the dbias tile's row stride (fp32) in the dk/dv launch's
      shared memory, 0 where a block sums nothing or the tile does not fit
      (the block then adds into its rows of the global plane)."""
    dbias = want_dbias and bias_shape is not None
    Bb, Hb = (bias_shape[0], bias_shape[1]) if dbias else (B, H)
    head_sum = int(Hb == 1 and H > 1)
    batch_sum = Bb == 1 and B > 1
    nkb = _cdiv(S, ENC_BWD_ROWS * (2 if D == 64 else 1))
    per_group = nkb * (1 if head_sum else H)
    group = _cdiv(B, min(B, _cdiv(2 * sms, per_group))) if batch_sum else 1
    groups = _cdiv(B, group)
    tp = 0
    if group > 1 or head_sum:
        tp = (_cdiv(T, 2) * 2 + 23) // 32 * 32 + 8
        bkb = ENC_BWD_ROWS * (2 if D == 64 else 1)
        if _enc_bwd_dkv_smem(D) + bkb * tp * 4 > _SMEM_MAX:
            tp = 0
    return {"group": group, "head_sum": head_sum, "groups": groups,
            "blocks": per_group * groups,
            "partial_bytes": (groups * Hb * T * S * 4
                              if batch_sum and groups > 1 else 0),
            "tp": tp}


def enc_bwd_steps(B: int, T: int, S: int, H: int, D: int, plan: dict) -> dict:
    """The blocks of `enc_bwd_plan`'s three launches as lists of steps
    (b, h, r0, r1, c0, c1), a [r0, r1) x [c0, c1) tile of (query row, key)
    pairs of one (batch, head), in the order the block walks them:
    "stats" and "dq", an item of 128 q rows of a (batch, head) over the
    key tiles (`_enc_bwd_key_tiles`; the persistent blocks take the items
    in this order, grid-stride); "dkv", a block per (key block, head or every head, group)
    in grid order, its items batch-major, each over its 64-row q tiles.
    "dbias_plane": per dk/dv block, the (group, head) plane it writes
    (head 0 for a head-summed one)."""
    bkb = ENC_BWD_ROWS * (2 if D == 64 else 1)

    def rows(kt):
        return [[(b, h, r0, min(r0 + ENC_BWD_QTILE, T), c0, min(c0 + kt, S))
                 for c0 in range(0, S, kt)]
                for b in range(B) for h in range(H)
                for r0 in range(0, T, ENC_BWD_QTILE)]
    stats_kt, dq_kt = _enc_bwd_key_tiles(D)
    dkv, planes, g = [], [], plan["group"]
    for z in range(plan["groups"]):
        for hh in range(1 if plan["head_sum"] else H):
            for c0 in range(0, S, bkb):
                heads = range(H) if plan["head_sum"] else (hh,)
                dkv.append([(b, h, r0, min(r0 + 64, T), c0, min(c0 + bkb, S))
                            for b in range(z * g, min(B, (z + 1) * g))
                            for h in heads for r0 in range(0, T, 64)])
                planes.append((z, hh))
    return {"stats": rows(stats_kt), "dkv": dkv, "dq": rows(dq_kt),
            "dbias_plane": planes}


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
    sb, sh = _bias_strides(bias, B, H, T, S, q.dtype, dev)
    Hb = 1 if bias is None else bias.shape[1]
    plan = enc_bwd_plan(B, T, S, H, D, None if bias is None else bias.shape,
                        want_dbias, torch.cuda.get_device_properties(
                            dev).multi_processor_count)
    dbias = partial = None
    if want_dbias:
        dbias = torch.empty(tuple(bias.shape), dtype=torch.float32, device=dev)
        if plan["partial_bytes"]:
            partial = torch.empty((plan["groups"], Hb, T, S),
                                  dtype=torch.float32, device=dev)
    stats = torch.empty((3, B, H, T), dtype=torch.float32, device=dev)
    # the bf16 path's ds plane (launch 2 writes it, launch 3 reads it)
    ds = (torch.empty((B, H, T, S), dtype=torch.bfloat16, device=dev)
          if q.dtype == torch.bfloat16 else None)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ENCODER_BWD_KERNEL.launch(
        "encoder_attn_bwd", ptr(q), ptr(k), ptr(v), ptr(do), ptr(bias),
        ptr(dq), ptr(dk), ptr(dv), ptr(dbias), ptr(partial), ptr(stats),
        ptr(ds), B, T, S, H, D, sb, sh, Hb, plan["group"], plan["head_sum"],
        float(scale), _DTYPE_CODE[q.dtype], stream())
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
