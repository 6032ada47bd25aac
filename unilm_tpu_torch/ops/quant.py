"""Int8 weight-only quantization (port of unilm_tpu/ops/quant.py:
`quantize_int8` :45, `_xla_int8_matmul` :139, `int8_matmul` :149,
`QuantDense` :184, `quantize_dense_tree` :222), with the decoder-only
predicate `is_decoder_projection`.

Weights are quantized symmetrically per output channel: int8 values plus
one f32 scale per channel. The projection computes x @ float(W) with an
fp32 accumulator, multiplies by the scales once and casts to x's dtype
once. On a CUDA tensor `int8_matmul` launches the hand-written kernel in
csrc/int8_matmul.cu; on a CPU tensor `int8_matmul_plain` computes the
same thing in plain torch. bf16 x runs on the tensor cores with a split-K
plan (`int8_matmul_plan`, tests/test_torch_int8_matmul_plan.py pins it
and emulates it against the JAX kernel); fp32 x on the CUDA cores.

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

from unilm_tpu_torch.ops._native import (
    I, P, CudaKernel, check_tensor, ptr, sm_count, stream)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel("int8_matmul.cu", {
    # x, w, scale, out, M, N, K, dtype, mt, ksplit, nst, stream
    "int8_matmul": [P, P, P, P, I, I, I, I, I, I, I, P],
})

# The bf16 kernel (csrc/int8_matmul.cu `hop::int8_mm_sm90`): a block takes
# INT8_CHANNELS output channels (wgmma's 64 rows), `mt` rows of x (its N
# side) and one of `ksplit` ranges of whole INT8_CHUNK-wide K chunks; the
# splits of a channel tile are one thread block cluster, merged in split
# order. A ring stage holds one chunk: the W box [64][128] int8 and the x
# rows [mt][128] bf16; INT8_PRODUCERS warps fill the stages in turn.
INT8_CHANNELS = 64
INT8_CHUNK = 128
INT8_PRODUCERS = 4
INT8_MAX_SPLIT = 8  # a portable cluster
INT8_RING = 96 * 1024  # ring bytes a block at most


def int8_matmul_plan(M: int, N: int, K: int, n_sm: int) -> dict:
    """The bf16 kernel's tiles for x [M, K] @ W[N, K]^T on `n_sm` SMs:
    - `channel_tile`: output channels a block (64, wgmma's M side);
    - `mt` (the N tile of the swapped product): rows of x a block, 8 for
      M <= 8, else 16, 32 or 64; `m_tiles` = ceil(M / mt) over grid.z;
    - `ksplit`: K ranges a channel tile, the cluster: about two blocks an
      SM, floor(2 n_sm / (channel tiles * m_tiles)), at least 1, at most 8
      and the chunks there are; then as few as cover the chunks at
      `chunks` = ceil(chunks / ksplit) each, so that no split is empty;
    - `stages`: ring stages, a chunk each, a multiple of INT8_PRODUCERS
      (a stage is always filled by the same producer warp), at most
      INT8_RING bytes where that allows more than INT8_PRODUCERS, and no
      more than a split's chunks rounded up to it (then every chunk is in
      flight at once);
    - `k_ranges`: [k0, k1) of each split, the last one short;
    - `blocks`: channel tiles * ksplit * m_tiles."""
    mt = 8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64
    m_tiles = -(-M // mt)
    tiles = -(-N // INT8_CHANNELS)
    nchunk = -(-K // INT8_CHUNK)
    ksplit = max(1, min(INT8_MAX_SPLIT, nchunk,
                        (2 * n_sm) // (tiles * m_tiles)))
    chunks = -(-nchunk // ksplit)
    ksplit = -(-nchunk // chunks)
    stage = INT8_CHANNELS * INT8_CHUNK + mt * 2 * INT8_CHUNK
    G = INT8_PRODUCERS
    stages = G * max(1, min(-(-chunks // G), INT8_RING // (stage * G)))
    k_ranges = [(s * chunks * INT8_CHUNK,
                 min(K, (s + 1) * chunks * INT8_CHUNK)) for s in range(ksplit)]
    return {"channel_tile": INT8_CHANNELS, "mt": mt, "m_tiles": m_tiles,
            "ksplit": ksplit, "chunks": chunks, "stages": stages,
            "k_ranges": k_ranges, "blocks": tiles * ksplit * m_tiles}


def int8_k_order(K: int) -> torch.Tensor:
    """The order in which the bf16 kernel's products take K: position j of
    chunk c (INT8_CHUNK wide) holds column c * INT8_CHUNK + perm(j). In a
    chunk, thread t of a quad reads the W bytes w t .. w t + w - 1 of its
    rows (w = INT8_CHUNK / 4), byte w t + 4 s + u standing for column
    2 t + (u & 1) + 8 (u >> 1) of the chunk's k-step s; x's staged row is
    permuted the same way. Columns past K (a short last chunk) are left
    out."""
    j = torch.arange(INT8_CHUNK)
    s, c = j // 16, j % 16
    t, u = (c % 8) // 2, (c % 2) + 2 * (c // 8)
    perm = INT8_CHUNK // 4 * t + 4 * s + u
    order = (torch.arange(-(-K // INT8_CHUNK))[:, None] * INT8_CHUNK
             + perm[None]).reshape(-1)
    return order[order < K]


_PLANS = {}


def _plan(M: int, N: int, K: int, dev) -> tuple:
    """(mt, ksplit, stages) of the bf16 kernel on device `dev`."""
    key = (M, N, K, dev)
    if key not in _PLANS:
        plan = int8_matmul_plan(M, N, K, sm_count(dev))
        _PLANS[key] = (plan["mt"], plan["ksplit"], plan["stages"])
    return _PLANS[key]


# the layer projections the serving engine and the Kosmos CLI quantize
# (unilm_tpu/runtime/serving.py:573, unilm_tpu/cli/kosmos_infer.py:144)
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
    # bf16 with K % 16 == 0: the wgmma kernel's plan; otherwise the
    # CUDA-core kernel, which takes none
    plan = (_plan(M, N, K, dev) if x.dtype == torch.bfloat16 and K % 16 == 0
            else (0, 0, 0))
    KERNEL.launch("int8_matmul", ptr(x2), ptr(w_i8), ptr(scale), ptr(out),
                  M, N, K, _DTYPE_CODE[x.dtype], *plan, stream())
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


def is_decoder_projection(path) -> bool:
    """True for a projection kernel of a layer of the text decoder: a flax
    path (..., "decoder", "layers" | "layers_<i>", ..., <proj>, "kernel")
    with <proj> in PROJECTIONS. Tower and connector projections
    (`img_model/encoder/layers_<i>/...`, `img_connector/x_attn/...`) are
    never selected.

    The JAX CLI's and serving engine's predicate, `pth[-2] in _PROJ and
    any(s.startswith("layers") ...)` (unilm_tpu/cli/kosmos_infer.py:145-148),
    also selects the Pix2Struct tower's layer projections, whose
    `nn.Dense` then finds no `kernel`: `kosmos_infer --int8` on an image
    raises in the JAX package. The port quantizes the decoder only. An MoE
    layer's experts (`.../moe/experts/fc1/kernel`, stacked on an expert
    axis) and its router stay in full precision, as the JAX engine leaves
    the 3-D expert kernels and the gate."""
    path = tuple(path)
    return (len(path) >= 4 and path[-2] in PROJECTIONS
            and "experts" not in path
            and any(a == "decoder" and b.startswith("layers")
                    for a, b in zip(path, path[1:])))


def _is_layer_projection(name: str) -> bool:
    """`...decoder.layers.<i>.<...>.<proj>.weight`: a decoder-layer
    projection (`is_decoder_projection` on state-dict names)."""
    parts = name.split(".")
    return parts[-1] == "weight" and is_decoder_projection(
        tuple(parts[:-1]) + ("kernel",))


def quantize_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The state-dict counterpart of `quantize_dense_tree` with the
    predicate `is_decoder_projection`: every decoder-layer projection
    `weight` [N, K] becomes `weight_i8` [N, K] int8 + `scale` [N] f32 (per
    output channel, contraction axis 1); its bias is kept as f32, as
    QuantDense stores it. Everything else passes through."""
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
