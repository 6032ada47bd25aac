"""Fused elementwise ops: SwiGLU and the interleaved rotary embedding (port
of unilm_tpu/ops/fused.py: `swiglu` :35 / `_swiglu_kernel` :30,
`rotary_apply` :80 / `_rotary_kernel` :64).

As in the JAX package, no model calls these: YOCO, RetNet and LatentLM
keep their plain forms (models/yoco.py `apply_rotary`). These are the
public ops. CPU tensors take the `*_plain` versions; a CUDA tensor
launches the kernel in csrc/fused.cu or raises.
"""

from __future__ import annotations

import torch

from unilm_tpu_torch.ops._native import I, LL, P, CudaKernel, ptr, stream

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

SWIGLU_KERNEL = CudaKernel("fused.cu", {
    # g, u, out, n, g_dtype, u_dtype, stream
    "swiglu": [P, P, P, LL, I, I, P],
})
ROTARY_KERNEL = CudaKernel("fused.cu", {
    # x, sin, cos, out, rows, T, H, D, dtype, stream
    "rotary": [P, P, P, P, I, I, I, I, I, P],
})


def swiglu_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in float32 from both upcast inputs, in g's dtype."""
    gf = g.float()
    return (gf * torch.sigmoid(gf) * u.float()).to(g.dtype)


def swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Fused silu(g) * u over any [..., d] (g and u of one shape; float32
    or bfloat16 each). Returns g's shape and dtype."""
    if g.device.type == "cpu":
        return swiglu_plain(g, u)
    if g.device.type != "cuda":
        raise ValueError(f"swiglu: device {g.device}")
    if tuple(u.shape) != tuple(g.shape) or u.device != g.device:
        raise ValueError(f"swiglu: u {tuple(u.shape)} on {u.device} does not "
                         f"match g {tuple(g.shape)} on {g.device}")
    if g.dtype not in _DTYPE_CODE or u.dtype not in _DTYPE_CODE:
        raise ValueError(f"swiglu takes float32/bfloat16, got {g.dtype}, "
                         f"{u.dtype}")
    g, u = g.contiguous(), u.contiguous()
    out = torch.empty_like(g)
    SWIGLU_KERNEL.launch("swiglu", ptr(g), ptr(u), ptr(out), g.numel(),
                         _DTYPE_CODE[g.dtype], _DTYPE_CODE[u.dtype], stream())
    return out


def rotary_apply_plain(x: torch.Tensor, sin: torch.Tensor,
                       cos: torch.Tensor) -> torch.Tensor:
    """Interleaved rotary on x [B, T, H, D] by sin/cos [T, D/2]: the pair
    (x[2i], x[2i+1]) turns by angle i; float32 math, x's dtype out."""
    xf = x.float()
    s = sin.float().repeat_interleave(2, dim=-1)[None, :, None, :]
    c = cos.float().repeat_interleave(2, dim=-1)[None, :, None, :]
    rot = torch.stack((-xf[..., 1::2], xf[..., ::2]), dim=-1).reshape(xf.shape)
    return (xf * c + rot * s).to(x.dtype)


def rotary_apply(x: torch.Tensor, sin: torch.Tensor,
                 cos: torch.Tensor) -> torch.Tensor:
    """Fused interleaved rotary on x [B, T, H, D] (float32 or bfloat16,
    any H, D even) by sin/cos [T, D/2] (read as float32). Returns x's
    shape and dtype."""
    if x.device.type == "cpu":
        return rotary_apply_plain(x, sin, cos)
    if x.device.type != "cuda":
        raise ValueError(f"rotary_apply: device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rotary_apply takes float32/bfloat16 [B, T, H, D], "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, T, H, D = x.shape
    if D % 2 or x.numel() >= 2 ** 31:
        raise ValueError(f"rotary_apply: D={D} must be even and x below 2^31 "
                         f"elements, got {tuple(x.shape)}")
    for name, t in (("sin", sin), ("cos", cos)):
        if tuple(t.shape) != (T, D // 2) or t.device != x.device:
            raise ValueError(f"rotary_apply: {name} {tuple(t.shape)} on "
                             f"{t.device}, expected {(T, D // 2)} on "
                             f"{x.device}")
    # sin/cos are read by scalar loads: any offset will do
    x = x.contiguous()
    sin = sin.to(torch.float32).contiguous()
    cos = cos.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    ROTARY_KERNEL.launch("rotary", ptr(x), ptr(sin), ptr(cos), ptr(out),
                         B * T, T, H, D, _DTYPE_CODE[x.dtype], stream())
    return out
