"""Flax param tree -> torch state_dict, by module path.

The inverse of the naming in unilm_tpu/convert/common.py:14-51 (which maps
torch `{prefix}.weight/bias` to flax): the input is a flax param tree given
as nested dicts of numpy arrays (e.g. `jax.device_get(params)`), looped
(`decoder/layers_i`) or stacked (`decoder/layers` with a leading layer
axis, the scan_layers form). Leaves map as

- Dense `kernel` [in, out] -> `weight` [out, in];
- QuantDense `kernel_i8` [in, out] int8 -> `weight_i8` [out, in], and its
  `scale` [out] f32 -> `scale` (ops/quant.py);
- LayerNorm / RMSNorm `scale` -> `weight`;
- Embed `embedding` -> `weight`;
- `bias` -> `bias`;
- a Conv `kernel` [p, p, C, E] of a patch projection (`.../proj`) ->
  `weight` [E, p*p*C], flattened in (kh, kw, C) order as
  core/embedding.py's patchify reads it; any other Conv kernel (HWIO:
  the CLIP tower's `conv1`, `DalleEncoder`'s and `DiscreteVAE`'s convs)
  -> `weight` [O, I, kh, kw], the layout of `F.conv2d`;
- params that keep their name: LayerScale `gamma`, `cls_token`,
  `mask_token`, `pos_embed`, `relative_position_bias_table`,
  `latent_query`, the CLIP tower's `class_embedding` and
  `positional_embedding`, LayoutLMv3's bias tables `rel_pos_bias`,
  `rel_pos_x_bias`, `rel_pos_y_bias` (LayoutLMv2's too), TrOCR's
  `dist_token` and the decoder's learned position table `embed_positions`,
  the RE head's `biaffine` [R, h + 1, h + 1], an MoE router's
  `gate_expert_embeddings` [E, gate_dim] and `gate_temperature` (a
  scalar), the T5 bias table `relative_attention_bias`, WavLM's
  `rel_attn_embed` and `gru_rel_pos_const`, the Diff Transformer's
  `lambda_{q,k}{1,2}`, SpeechLM's `mask_emb`, SpeechT5's `dec_pos` and
  the FCOS head's per-level `scales`;
- a ConvTranspose `kernel` [kh, kw, I, O] (the detection adapters
  `fpn1_deconv1`, `fpn1_deconv2`, `fpn2_deconv`, the segmentation
  adapters `up4`, `up2`, the mask head's `deconv`) -> `weight`
  [I, O, kh, kw] spatially flipped, torch's `ConvTranspose2d` layout:
  flax correlates the stride-dilated input with its kernel where torch
  scatters each input through its weight (the inverse of
  unilm_tpu/convert/detection.py `conv_transpose_nhwc`); the rule goes by
  the module's name, as a flax ConvTranspose kernel has a Conv kernel's
  rank (the rcnn adapters' E -> E 2x2 kernels would load unflipped
  without an error);
- `FrozenBN`'s `scale` / `bias` -> `weight` / `bias` and its statistics
  `mean` / `var` -> the buffers `running_mean` / `running_var`
  (models/rcnn.py);
- a 1-D Conv `kernel` [K, I, O] (WavLM's feature extractor and
  positional conv, SpeechT5's postnet) -> `weight` [O, I, K], the layout
  of `F.conv1d` (a 3-D kernel under `experts` is an MoE expert's);
- an MoE layer's vmapped `experts` (each leaf with a leading expert
  axis: `kernel` [E, in, out] -> `weight` [E, out, in]) and its `gate`
  Dense, by the rules above (core/moe.py names them alike);
- a stacked `layers` subtree -> one module per layer (`layers.{i}`),
  `layers_{i}` -> `layers.{i}`.

Multiway trees (BEiT-3, VLMo) map by the same rules: each expert pair's
`A` / `B` subtrees and `ffn_A` / `ffn_B` are modules of those names in
core/multiway.py and core/transformer.py. A second collection, the
`ema` one of BEiT-2's quantizer (`quantize/embedding`,
`quantize/cluster_size`), holds buffers: its leaves keep their names
(`load_flax_params(model, params, ema=...)`).

TrOCR's tree (`vit/...`, `text_decoder/...` with each layer's
`encoder_attn` and `encoder_attn_layer_norm`, looped or stacked, and the
int8 `output_projection` of `quantize_trocr_decoder`) and YOCO's tree
(`embed_tokens/embedding`, `self_{i}/{q,k,v,g,out}_proj`,
`self_{i}/gt_proj`, `self_norm{1,2}_{i}/scale`, `self_ffn_{i}/fc{1,2,3}`,
`kv_norm`, `global_{k,v}`, `cross_{i}/*`, `cross_norm{1,2}_{i}`,
`cross_ffn_{i}`, `final_norm`) map by these rules alone: the port's
models/trocr.py and models/yoco.py register their modules under the flax
names. So do the Document AI trees: LayoutLM's `x/y/h/w_position_
embeddings`, MarkupLM's `xpath_embeddings/tag_emb_{i}` / `subs_emb_{i}`,
and LayoutLMv2's backbone `visual/conv_{i}` (HWIO kernels -> OIHW
`Conv2d`) and `visual/gn_{i}` (GroupNorm `scale` -> `weight`); and the
detection and segmentation trees (models/rcnn.py, detection.py,
detection_head.py, segmentation.py: HWIO conv kernels -> OIHW, the flax
auto-names `ConvBNReLU_{i}/Conv_0`, `GroupNorm_0` kept as module names).
The rcnn box head's `fc1` loads unchanged: the port flattens the pooled
[R, 7, 7, C] in JAX's (h, w, c) order.

No jax import: bfloat16 leaves (ml_dtypes arrays) are reinterpreted bit
for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}
_SAME = {"gamma", "cls_token", "mask_token", "pos_embed",
         "relative_position_bias_table", "latent_query", "rel_pos_bias",
         "rel_pos_x_bias", "rel_pos_y_bias", "dist_token", "embed_positions",
         "class_embedding", "positional_embedding", "biaffine",
         "gate_expert_embeddings", "gate_temperature",
         "relative_attention_bias", "rel_attn_embed", "gru_rel_pos_const",
         "lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2", "mask_emb",
         "dec_pos", "scales"}
# flax ConvTranspose modules by name (a kernel of a Conv kernel's rank)
_CONV_TRANSPOSE = {"fpn1_deconv1", "fpn1_deconv2", "fpn2_deconv", "up4",
                   "up2", "deconv"}


def to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_QUANT_LEAF = {"kernel_i8": "weight_i8", "scale": "scale", "bias": "bias"}


def _leaf(name: str, value: np.ndarray, quant: bool, conv: str) -> tuple:
    """`conv`: "" for a leaf that is no Conv kernel, else its torch
    layout: "flat" or "oihw" for a 4-D kernel [p, p, C, E] (with a leading
    layer axis when stacked, 5-D), "iohw_flip" for a ConvTranspose kernel
    [kh, kw, I, O], "oik" for a 1-D one [K, I, O]."""
    if name in _SAME and not quant:
        return name, value
    table = _QUANT_LEAF if quant else _LEAF
    if name not in table:
        raise KeyError(f"unmapped flax leaf {name!r}")
    if conv == "oik":  # [K, I, O] -> [O, I, K]
        return table[name], np.transpose(value, (2, 1, 0))
    if conv == "oihw":  # [p, p, C, E] -> [E, C, p, p]
        return table[name], np.transpose(value, (3, 2, 0, 1))
    if conv == "iohw_flip":  # [kh, kw, I, O] -> [I, O, kh, kw], flipped
        return table[name], np.transpose(value, (2, 3, 0, 1))[..., ::-1, ::-1]
    if conv:  # [(L,) p, p, C, E] -> [(L,) E, p*p*C]
        value = value.reshape(*value.shape[:-4], -1, value.shape[-1])
    if name in ("kernel", "kernel_i8"):
        value = np.swapaxes(value, -1, -2)  # [(L,) in, out] -> [(L,) out, in]
    return table[name], value


def flax_to_state_dict(params: Mapping, ema: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree (and an `ema` collection of buffers,
    whose leaves keep their names) into the port's state_dict names."""
    out: Dict[str, torch.Tensor] = {}
    if ema is not None:
        _buffers(ema, "", out)

    def walk(tree: Mapping, prefix: str, stacked: bool):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                if key == "layers":
                    walk(val, f"{prefix}layers.{{i}}.", True)
                elif key.startswith("layers_") and key[7:].isdigit():
                    walk(val, f"{prefix}layers.{key[7:]}.", stacked)
                else:
                    walk(val, f"{prefix}{key}.", stacked)
                continue
            arr = np.asarray(val)
            conv = ""
            if key == "kernel" and arr.ndim - int(stacked) == 4:
                conv = ("flat" if prefix.endswith("proj.") else
                        "iohw_flip" if prefix.split(".")[-2]
                        in _CONV_TRANSPOSE else "oihw")
            elif (key == "kernel" and arr.ndim - int(stacked) == 3
                  and not stacked and ".experts." not in f".{prefix}"):
                conv = "oik"
            name, arr = _leaf(key, arr, "kernel_i8" in tree, conv)
            path = f"{prefix}{name}"
            if stacked:
                for i in range(arr.shape[0]):
                    out[path.format(i=i)] = to_tensor(arr[i])
            else:
                out[path] = to_tensor(arr)

    walk(params, "", False)
    return out


def _buffers(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            _buffers(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = to_tensor(val)


def load_flax_params(model: torch.nn.Module, params: Mapping,
                     ema: Optional[Mapping] = None) -> None:
    """Copy a flax param tree, and the `ema` collection where the model
    has one, into `model` (strict: every leaf of the trees and every
    parameter and persistent buffer of the model must be matched)."""
    sd = flax_to_state_dict(params, ema)
    model.load_state_dict(sd, strict=True)
