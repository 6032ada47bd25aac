"""Shared building blocks (port of unilm_tpu/core/layers.py): projections,
norms, activations, the feed-forward block, LayerScale and DropPath.

Parameters are stored in `cfg.param_dtype` and cast to the compute dtype
`cfg.dtype` on use, as flax's `dtype`/`param_dtype` pair does. Norm
statistics run in float32 and the result is cast to the compute dtype,
as flax's LayerNorm does.

Random initialisation follows the JAX initialisers' scales (xavier-uniform
times the deepnorm/subln factor for projections, normal(std) for
embeddings) and draws from an explicit `torch.Generator`
(`init_weights_`).

Dropout (flax `nn.Dropout`, and the attention probabilities' dropout of
ops/attention.py) draws every mask through one helper, ops/dropout.py's
`draw_keep`, from an explicit `torch.Generator`. A stack draws one seed per layer from the
caller's generator (`layer_seeds`) and each layer builds its masks from a
generator seeded with it (`seeded_generator`), so that a layer recomputed
under activation checkpointing (torch.utils.checkpoint restores the global
RNG, not a generator passed in by hand) draws the same masks again.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.ops import dropout as dropout_ops
from unilm_tpu_torch.ops.collectives import tensor_parallel


def get_activation(name: str, dtype=None) -> Callable:
    """Activation zoo. 'gelu' is exact erf-GELU except under bf16 compute,
    where the JAX package swaps in the tanh approximation
    (unilm_tpu/core/layers.py get_activation); the same rule, and the same
    UNILM_TPU_EXACT_GELU override, apply here so bf16 runs of the two
    packages compute the same function."""
    if (
        name == "gelu"
        and dtype == torch.bfloat16
        and not os.environ.get("UNILM_TPU_EXACT_GELU")
    ):
        name = "gelu_tanh"
    return _ACTIVATIONS[name]


_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}

GATED_ACTIVATIONS = {"swiglu": "silu", "geglu": "gelu", "geglu_new": "gelu_new"}


class Dense(nn.Linear):
    """nn.Linear in `param_dtype` computing in `dtype`. `init_scale` is the
    xavier-uniform multiplier the JAX module initialises this projection
    with (scaled_init in unilm_tpu/core/layers.py)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 dtype, param_dtype, init_scale: float = 1.0, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype
        self.init_scale = init_scale
        self.tensor_split = None

    def split_over_tensor(self, kind: str, group) -> None:
        """Compute as one rank of a `kind` ("column" or "row") parallel
        projection over `group` (ops/collectives.py `tensor_parallel`):
        `weight` (and a column's `bias`) now hold this rank's block of
        output or input features (parallel/sharding.py)."""
        self.tensor_split = (kind, group)

    def forward(self, x: torch.Tensor, whole: bool = True) -> torch.Tensor:
        """`whole=False` under a tensor split: a column's output, or a
        row's input, is this rank's block of features."""
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tensor_split is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        w = self.weight.to(dt)
        return tensor_parallel(lambda xp, bp: F.linear(xp, w, bp), x.to(dt),
                               b, *self.tensor_split, whole=whole)


class Norm(nn.Module):
    """LayerNorm or RMSNorm (cfg.norm_type), float32 statistics, output in
    the compute dtype: cfg.dtype, or `dtype` where given (float32 for a
    flax norm left at dtype=None, whose output promotes to its float32
    params)."""

    def __init__(self, cfg: TransformerConfig, dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        dim = cfg.embed_dim if dim is None else dim
        self.rms = cfg.norm_type == "rmsnorm"
        self.eps = cfg.layernorm_eps
        self.compute_dtype = cfg.dtype if dtype is None else dtype
        self.weight = nn.Parameter(
            torch.ones(dim, device=device, dtype=cfg.param_dtype))
        if self.rms:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(
                torch.zeros(dim, device=device, dtype=cfg.param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rms:
            xf = x.float()
            y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
            y = y * self.weight.float()
        elif x.dtype == self.weight.dtype:
            # torch's layer_norm keeps float32 statistics for bf16 inputs
            # and rounds once at the end: one kernel, no upcast copies
            y = F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                             self.eps)
        else:
            y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                             self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


def make_norm(cfg: TransformerConfig, dim: Optional[int] = None,
              device=None, dtype=None) -> Norm:
    """LayerNorm or RMSNorm over `dim` (default embed_dim)."""
    return Norm(cfg, dim, device=device, dtype=dtype)


class LayerScale(nn.Module):
    """Learned per-channel residual scale `gamma` (BEiT's LayerScale,
    unilm_tpu/core/layers.py:59): x * gamma in x's dtype; float32 params."""

    def __init__(self, dim: int, init_value: float = 1e-5, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value),
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout in training: where(keep, x / (1 - rate), 0) in x's
    dtype with keep from ops/dropout.py's `draw_keep`; zeros at rate 1; the
    identity at rate 0 or without `rng` (evaluation)."""
    if rate == 0.0 or rng is None:
        return x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if rate == 1.0:
        return zero.expand_as(x)
    keep = dropout_ops.draw_keep(x.shape, rate, rng, x.device)
    return torch.where(keep, x / (1.0 - rate), zero)


def training_rng(module: nn.Module, generator: Optional[torch.Generator]
                 ) -> Optional[torch.Generator]:
    """The generator a model's own dropout sites draw from: `generator` in a
    training forward, None at evaluation (`dropout` is then the identity)."""
    return generator if module.training else None


def layer_seeds(generator: torch.Generator, n: int) -> list:
    """n seeds drawn from `generator`, one per layer of a stack (one host
    read for the whole stack)."""
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


def seeded_generator(seed: Optional[int],
                     device) -> Optional[torch.Generator]:
    """A fresh generator on `device` seeded with `seed` (None: None): a
    layer's dropout masks come from it, so a recompute draws them again."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class DropPath(nn.Module):
    """Stochastic depth per sample (unilm_tpu/core/layers.py:41): in
    training, `where(keep, x / (1 - rate), 0)` in x's dtype with one keep
    flag per sample; the identity outside training or at rate 0.

    The flags are not drawn here: the caller draws every flag of a step
    before the forward (`Encoder.draw_drop_path`, from an explicit
    `torch.Generator`) and passes this call's `keep` [B] bool, so that an
    activation-checkpointed layer sees the same flags when it is
    recomputed (torch.utils.checkpoint restores the global RNG state, not a
    generator passed in by hand)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if keep is None:
            raise ValueError(
                "DropPath in training needs the pre-drawn keep flags of its "
                "call (Encoder.draw_drop_path)")
        keep = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def make_dense(cfg: TransformerConfig, in_features: int, features: int, *,
               init_scale: float = 1.0, use_kernel: bool = True,
               device=None) -> nn.Module:
    """Dense projection factory: int8 weight-only `QuantDense` when
    cfg.quant_weights (conversion-only weights; `use_kernel=False` keeps it
    on the plain version), else `Dense`. Unlike the JAX factory, a scanned
    stack keeps the kernel (see ops/quant.py)."""
    if cfg.quant_weights:
        from unilm_tpu_torch.ops.quant import QuantDense

        return QuantDense(in_features, features, bias=cfg.use_bias,
                          dtype=cfg.dtype, use_kernel=use_kernel,
                          device=device)
    return Dense(in_features, features, bias=cfg.use_bias, dtype=cfg.dtype,
                 param_dtype=cfg.param_dtype, init_scale=init_scale,
                 device=device)


def head_dense(in_features: int, features: int, dtype=torch.float32,
               bias: bool = True, device=None) -> Dense:
    """A flax nn.Dense head over float32 params computing in `dtype`
    (float32 for a flax Dense left at dtype=None); `init_weights_` draws
    it normal(fan_in^-0.5), flax's lecun-normal scale."""
    d = Dense(in_features, features, bias=bias, dtype=dtype,
              param_dtype=torch.float32, device=device)
    d.init_std = in_features ** -0.5
    return d


class FeedForward(nn.Module):
    """fc1 -> act -> dropout(activation_dropout) -> (ffn_layernorm if
    subln) -> fc2 -> dropout(dropout), or the gated variant (torchscale
    FeedForwardNetwork). The two dropouts draw from `rng` (none: eval)."""

    def __init__(self, cfg: TransformerConfig, init_scale: float = 1.0,
                 use_kernel: bool = True, device=None):
        super().__init__()
        E, Fd = cfg.embed_dim, cfg.ffn_dim
        self.gated = cfg.activation in GATED_ACTIVATIONS
        self.act = get_activation(
            GATED_ACTIVATIONS.get(cfg.activation, cfg.activation), cfg.dtype)
        dense = lambda i, o: make_dense(cfg, i, o, init_scale=init_scale,
                                        use_kernel=use_kernel, device=device)
        self.fc1 = dense(E, Fd)
        if self.gated:
            self.fc3 = dense(E, Fd)
        if cfg.subln:
            self.ffn_layernorm = make_norm(cfg, Fd, device=device)
        self.fc2 = dense(Fd, E)
        self.activation_dropout, self.dropout = (cfg.activation_dropout,
                                                 cfg.dropout)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        # split over `tensor` without the sub-LN (a norm over every
        # feature): the hidden stays this rank's block of features, and
        # its activation dropout draws that block's masks
        kw = ({"whole": False} if getattr(self.fc1, "tensor_split", None)
              and not hasattr(self, "ffn_layernorm") else {})
        if self.gated:
            h = self.act(self.fc1(x, **kw)) * self.fc3(x, **kw)
        else:
            h = self.act(self.fc1(x, **kw))
        h = dropout(h, self.activation_dropout, rng)
        if hasattr(self, "ffn_layernorm"):
            h = self.ffn_layernorm(h)
        return dropout(self.fc2(h, **kw), self.dropout, rng)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every Dense (xavier-uniform * init_scale, or normal(0, init_std)
    where set; zero bias), Norm (ones/zeros) and embedding
    (normal(0, init_std)) under `module`, and every module with an
    `init_params_(generator)` method, from `generator`, at the scales of
    the JAX initialisers."""
    for m in module.modules():
        if isinstance(m, Dense):
            if getattr(m, "init_std", None) is not None:
                m.weight.normal_(0.0, m.init_std, generator=generator)
            else:
                fan_out, fan_in = m.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out)) * m.init_scale
                m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Norm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, getattr(m, "init_std", 1.0),
                             generator=generator)
        elif hasattr(m, "init_params_"):
            # modules with parameters of their own kind (core/moe.py's
            # stacked experts, the router's expert embeddings)
            m.init_params_(generator)


def same_padding(n: int, kernel: int, stride: int) -> tuple:
    """flax's "SAME" padding of one spatial dim of size n: (low, high) with
    low + high = max((ceil(n / stride) - 1) stride + kernel - n, 0) and
    low = total // 2 (lax.padtype_to_pads). Odd totals pad one more at
    the end, so a 3x3 stride-2 conv over an even size pads (0, 1), not
    torch's symmetric (1, 1)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class ConvNHWC(nn.Conv2d):
    """flax nn.Conv with "SAME" padding over NHWC activations with a torch
    OIHW weight (convert/from_jax.py maps the flax HWIO kernel), at any
    stride, computing in the weight's dtype (flax promotes a bf16 input to
    its float32 params). Stride 1 with an odd kernel pads k // 2 on each
    side inside the conv; any other geometry pads `same_padding` with
    F.pad before an unpadded conv, so odd and even sizes both give flax's
    output. `dtype`: the compute dtype of a flax Conv given one (None:
    the weight's). `init_params_` draws flax's lecun-normal scale,
    normal(fan_in^-0.5), and zero bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 bias: bool = True, stride: int = 1, dtype=None,
                 device=None):
        inner = stride == 1 and kernel % 2 == 1
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel // 2 if inner else 0, bias=bias,
                         device=device)
        self.inner_pad = inner
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        if not self.inner_pad:
            k, s = self.kernel_size[0], self.stride[0]
            (ht, hb), (wl, wr) = (same_padding(n, k, s) for n in x.shape[2:])
            x = F.pad(x, (wl, wr, ht, hb))
        if dt == self.weight.dtype:
            y = super().forward(x)
        else:
            y = self._conv_forward(x, self.weight.to(dt), None if self.bias
                                   is None else self.bias.to(dt))
        return y.permute(0, 2, 3, 1)

    def init_params_(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.weight[0].numel() ** -0.5,
                            generator=generator)
        if self.bias is not None:
            self.bias.zero_()


def conv_transpose_padding(kernel: int, stride: int) -> tuple:
    """flax nn.ConvTranspose's "SAME" padding (lax `_conv_transpose_padding`)
    of the stride-dilated input: (low, high), summing to kernel + stride -
    2, so that the output is n * stride."""
    total = kernel + stride - 2
    low = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return low, total - low


class ConvTransposeNHWC(nn.ConvTranspose2d):
    """flax nn.ConvTranspose with "SAME" padding over NHWC activations: an
    upsampling by `stride` (default: the kernel size), output n * stride.
    The torch weight is [I, O, kh, kw] and scatters (out[s i + a] +=
    in[i] w[a]); flax correlates the dilated input, padded by
    `conv_transpose_padding`, with its [kh, kw, I, O] kernel, so the torch
    weight is that kernel transposed and spatially flipped
    (convert/from_jax.py), and torch's `padding` is kernel - 1 - low (k = 4,
    s = 2: 1). A high side longer than the low one is torch's
    `output_padding`; a shorter one is cropped from the end. Computes in
    the weight's dtype; `init_params_` as `ConvNHWC`'s."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: Optional[int] = None, device=None):
        stride = kernel if stride is None else stride
        low, high = conv_transpose_padding(kernel, stride)
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel - 1 - low,
                         output_padding=max(high - low, 0), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_h, n_w = x.shape[1] * self.stride[0], x.shape[2] * self.stride[1]
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        return super().forward(x)[:, :, :n_h, :n_w].permute(0, 2, 3, 1)

    def init_params_(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[0] * self.weight[0, 0].numel()
        self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        self.bias.zero_()


class GroupNormNHWC(nn.GroupNorm):
    """flax nn.GroupNorm (epsilon 1e-6) over NHWC activations."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6,
                 device=None):
        super().__init__(groups, channels, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def init_params_(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
