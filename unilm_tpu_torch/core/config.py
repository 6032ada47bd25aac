"""Unified transformer configuration (port of unilm_tpu/core/config.py).

Same fields and the same `__post_init__` rules as the JAX
`TransformerConfig`, so a config written for one package constructs in the
other. The TPU-only VMEM tiling knobs (`flash_block_q`/`flash_block_k`)
stay as fields for that reason but no code path of this package reads
them; `remat_policy` "full" is per-layer torch.utils.checkpoint and the
other policies raise, as `seq_axis` does. Dtypes are torch dtypes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    # --- dimensions -------------------------------------------------------
    vocab_size: int = 0
    embed_dim: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    head_dim: Optional[int] = None  # default embed_dim // num_heads

    # --- regularization ---------------------------------------------------
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    drop_path_rate: float = 0.0

    # --- architecture switches (Magneto core) ------------------------------
    activation: str = "gelu"  # gelu | relu | swiglu | geglu | geglu_new
    normalize_before: bool = True  # pre-LN (False = post-LN)
    deepnorm: bool = False
    subln: bool = False
    bert_init: bool = False
    multiway: bool = False
    layernorm_eps: float = 1e-5
    norm_type: str = "layernorm"  # layernorm | rmsnorm
    use_bias: bool = True
    attn_scale: Optional[float] = None  # None = head_dim**-0.5

    # --- positional schemes -------------------------------------------------
    rel_pos_buckets: int = 0
    max_rel_pos: int = 0
    xpos_rel_pos: bool = False
    xpos_scale_base: int = 512
    scale_length: int = 2048

    # --- embedding front-end -------------------------------------------------
    max_positions: int = 1024
    learned_pos: bool = True
    no_scale_embedding: bool = True
    layernorm_embedding: bool = False
    share_input_output_embed: bool = False
    no_output_layer: bool = False

    # --- MoE -------------------------------------------------------------------
    moe_freq: int = 0
    moe_experts: int = 0
    moe_top: int = 2
    moe_capacity_factor: float = 1.0
    moe_eval_capacity_factor: float = 2.0
    moe_gate_dim: int = 0
    moe_second_expert_policy: str = "random"

    # --- attention implementation ----------------------------------------------
    remat: bool = False
    remat_policy: str = "full"  # "full" per-layer checkpoint; "dots" raises
    # use_flash=True sends CUDA tensors through the hand-written kernels
    # (ops/flash_attention.py, ops/paged_attention.py); False keeps every
    # device on the plain torch attention — the reference the kernels are
    # timed and checked against.
    use_flash: bool = True
    seq_axis: Any = None  # sequence-parallel mesh axis; raises (slice 9)
    window_size: int = 0
    flash_block_q: int = 512  # TPU VMEM tiling; unread
    flash_block_k: int = 1024  # TPU VMEM tiling; unread
    quant_weights: bool = False
    kv_cache_dtype: str = "model"  # "model" | "int8"
    scan_layers: bool = False

    # --- compute dtypes ----------------------------------------------------------
    dtype: Any = torch.float32  # activation dtype
    param_dtype: Any = torch.float32

    # --- encoder-decoder ---------------------------------------------------------
    is_encoder_decoder: bool = False

    def __post_init__(self):
        if self.deepnorm and self.subln:
            raise ValueError("deepnorm and subln are mutually exclusive")
        if self.deepnorm and self.normalize_before:
            object.__setattr__(self, "normalize_before", False)
        if self.subln and not self.normalize_before:
            object.__setattr__(self, "normalize_before", True)
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.embed_dim // self.num_heads)

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    @property
    def deepnorm_alpha(self) -> float:
        if not self.deepnorm:
            return 1.0
        if self.is_encoder_decoder:
            return float(3 * self.num_layers) ** 0.25
        return float(2 * self.num_layers) ** 0.25

    @property
    def deepnorm_init_div(self) -> float:
        if not self.deepnorm:
            return 1.0
        if self.is_encoder_decoder:
            return float(12 * self.num_layers) ** 0.25
        return float(8 * self.num_layers) ** 0.25

    @property
    def subln_init_mul(self) -> float:
        if not self.subln:
            return 1.0
        if self.is_encoder_decoder:
            return math.sqrt(math.log(3 * self.num_layers))
        return math.sqrt(math.log(2 * self.num_layers))
