"""Int8 weight-only quantization (port of unilm_tpu/ops/quant.py:
`quantize_int8` :45, `_xla_int8_matmul` :139, `int8_matmul` :149,
`QuantDense` :184, `quantize_dense_tree` :222).

Weights are quantized symmetrically per output channel: int8 values plus
one f32 scale per channel. The projection computes x @ float(W) with an
fp32 accumulator, multiplies by the scales once and casts to x's dtype
once. On a CUDA tensor `int8_matmul` launches the hand-written kernel in
csrc/int8_matmul.cu; on a CPU tensor `int8_matmul_plain` computes the
same thing in plain torch.

Layout: the port stores W as [N, K] (the torch Linear layout, `weight_i8`)
where the JAX package stores `kernel_i8` [K, N]; convert/from_jax.py
transposes.

The JAX scanned stack gives QuantDense `use_kernel=not cfg.scan_layers`
(unilm_tpu/core/layers.py:139) for a TPU-only reason: a Pallas custom call
forces nn.scan's per-layer weight slice to materialize. The port's layers
are separate modules with their own tensors, so the kernel serves the
scanned configuration as well.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unilm_tpu_torch.ops._native import I, P, CudaKernel, check_tensor, ptr, stream

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel("int8_matmul.cu", {
    # x, w, scale, out, M, N, K, dtype, stream
    "int8_matmul": [P, P, P, P, I, I, I, I, P],
})

# the decoder-layer projections ServingEngine quantizes
# (unilm_tpu/runtime/serving.py:573)
PROJECTIONS = frozenset({"q_proj", "k_proj", "v_proj", "out_proj", "fc1",
                         "fc2", "fc3"})


def quantize_int8(w: torch.Tensor, axis: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization; `axis` is the CONTRACTION
    axis. Returns (w_i8 of w's shape, scale f32 over the other axes).
    fp32 amax, scale = max(amax, 1e-8) / 127, round half to even, clip to
    +-127: bit-equal to the JAX function."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    wi = torch.round(wf / scale.unsqueeze(axis))
    wi = torch.clamp(wi, -127, 127).to(torch.int8)
    return wi, scale


def int8_matmul_plain(x: torch.Tensor, w_i8: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The plain version (JAX `_xla_int8_matmul`): fp32 product, scale,
    one cast to x's dtype. x [..., K], w_i8 [N, K], scale [N]."""
    acc = torch.matmul(x.float(), w_i8.float().t())
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_i8: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_i8, scale) without a dequantized copy of W.
    x [..., K] float32/bfloat16, w_i8 [N, K] int8, scale [N] f32; returns
    [..., N] in x's dtype. CPU tensors take `int8_matmul_plain`; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_i8, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: device {x.device}")
    N, K = w_i8.shape
    if x.shape[-1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w_i8 "
                         f"{tuple(w_i8.shape)}")
    if x.dtype not in _DTYPE_CODE or K % 8:
        raise ValueError(f"int8_matmul kernel takes float32/bfloat16 x and "
                         f"K % 8 == 0, got {x.dtype}, K={K}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    dev = x.device
    check_tensor("x", x2, dtype=x.dtype, shape=(M, K), device=dev)
    check_tensor("w_i8", w_i8, dtype=torch.int8, shape=(N, K), device=dev)
    check_tensor("scale", scale, dtype=torch.float32, shape=(N,), device=dev)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    KERNEL.launch("int8_matmul", ptr(x2), ptr(w_i8), ptr(scale), ptr(out),
                  M, N, K, _DTYPE_CODE[x.dtype], stream())
    return out.reshape(*lead, N)


class QuantDense(nn.Module):
    """Dense twin whose weight is int8 [N, K] plus f32 scales [N] and an
    f32 bias. The tensors are buffers filled by conversion
    (`quantize_state_dict`, or the bridge from a `quantize_dense_tree`
    tree); a fresh module holds zeros and unit scales, as the JAX init
    does. `use_kernel=False` keeps every device on the plain version."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 dtype, use_kernel: bool = True, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.use_kernel = use_kernel
        self.register_buffer("weight_i8", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        if bias:
            self.register_buffer("bias", torch.zeros(
                out_features, dtype=torch.float32, device=device))
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.use_kernel:
            y = int8_matmul(x, self.weight_i8, self.scale)
        else:
            y = int8_matmul_plain(x, self.weight_i8, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def quantize_dense_tree(params: Mapping,
                        predicate: Optional[Callable] = None) -> dict:
    """Flax-layout tree (nested dicts of arrays) -> the same tree with every
    2-D `kernel` [K, N], or stacked 3-D [L, K, N], replaced by `kernel_i8`
    (same shape, int8) and `scale` ([N] or [L, N] f32), per output channel.
    `predicate(path_tuple)` restricts which modules are quantized. Leaves
    come back as numpy arrays."""
    from unilm_tpu_torch.convert.from_jax import to_tensor

    def walk(node, path):
        if not isinstance(node, Mapping):
            return node
        out = {}
        for k, v in node.items():
            p = path + (k,)
            if (k == "kernel" and hasattr(v, "ndim") and v.ndim in (2, 3)
                    and (predicate is None or predicate(p))):
                wi, scale = quantize_int8(to_tensor(np.asarray(v)),
                                          axis=v.ndim - 2)
                out["kernel_i8"] = wi.numpy()
                out["scale"] = scale.numpy()
            else:
                out[k] = walk(v, p)
        return out

    return walk(params, ())


def _is_layer_projection(name: str) -> bool:
    """`...layers.<i>.<...>.<proj>.weight` for a decoder-layer projection
    the serving engine quantizes (unilm_tpu/runtime/serving.py:577)."""
    parts = name.split(".")
    return (len(parts) >= 3 and parts[-1] == "weight"
            and parts[-2] in PROJECTIONS and "layers" in parts)


def quantize_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The state-dict counterpart of `quantize_dense_tree` with the serving
    engine's predicate: every decoder-layer projection `weight` [N, K]
    becomes `weight_i8` [N, K] int8 + `scale` [N] f32 (per output channel,
    contraction axis 1); its bias is kept as f32, as QuantDense stores
    it. Everything else passes through."""
    out = dict(sd)
    for name, t in sd.items():
        if _is_layer_projection(name):
            prefix = name[: -len("weight")]
            del out[name]
            out[prefix + "weight_i8"], out[prefix + "scale"] = quantize_int8(
                t, axis=1)
            if prefix + "bias" in sd:
                out[prefix + "bias"] = sd[prefix + "bias"].float()
    return out
