"""LayoutLMv3 checkpoints -> the port's `LayoutLMv3For*` state_dict (port of
unilm_tpu/convert/layoutlmv3.py `convert_layoutlmv3`).

HF transformers state dicts (`layoutlmv3.*` prefix) and the reference
layoutlmft checkpoints (the same key names without the prefix). Torch
Linear weights keep their [out, in] layout; the relative-bias Linears
(`encoder.rel_pos_bias`, `rel_pos_x_bias`, `rel_pos_y_bias`, [H, bins])
become the [bins, H] tables; the patch Conv2d becomes core/embedding.py's
flattened projection.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from unilm_tpu_torch.convert.common import linear, norm, patch_proj, tensor
from unilm_tpu_torch.models.layoutlmv3 import LayoutLMv3Config


def convert_layoutlmv3(sd: Mapping, cfg: LayoutLMv3Config
                       ) -> Dict[str, torch.Tensor]:
    sd = dict(sd)
    p = "layoutlmv3." if any(k.startswith("layoutlmv3.") for k in sd) else ""
    m = "layoutlmv3."
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        src, dst = f"{p}encoder.layer.{i}", f"{m}encoder.layers.{i}"
        for a, b in (("query", "q_proj"), ("key", "k_proj"),
                     ("value", "v_proj")):
            linear(sd, f"{src}.attention.self.{a}", f"{dst}.self_attn.{b}", out)
        linear(sd, f"{src}.attention.output.dense",
               f"{dst}.self_attn.out_proj", out)
        norm(sd, f"{src}.attention.output.LayerNorm",
             f"{dst}.self_attn_layer_norm", out)
        linear(sd, f"{src}.intermediate.dense", f"{dst}.ffn.fc1", out)
        linear(sd, f"{src}.output.dense", f"{dst}.ffn.fc2", out)
        norm(sd, f"{src}.output.LayerNorm", f"{dst}.final_layer_norm", out)
    for name in ("word_embeddings", "token_type_embeddings",
                 "position_embeddings"):
        out[f"{m}{name}.weight"] = tensor(sd[f"{p}embeddings.{name}.weight"])
    for name in ("x_position_embeddings", "y_position_embeddings",
                 "h_position_embeddings", "w_position_embeddings"):
        out[f"{m}spatial.{name}.weight"] = tensor(
            sd[f"{p}embeddings.{name}.weight"])
    norm(sd, f"{p}embeddings.LayerNorm", f"{m}emb_LayerNorm", out)
    for name in ("rel_pos_bias", "rel_pos_x_bias", "rel_pos_y_bias"):
        key = f"{p}encoder.{name}.weight"
        if key in sd:
            out[f"{m}{name}"] = tensor(sd[key]).t().contiguous()
    if f"{p}cls_token" in sd:
        out[f"{m}cls_token"] = tensor(sd[f"{p}cls_token"])
        out[f"{m}pos_embed"] = tensor(sd[f"{p}pos_embed"])
        patch_proj(sd, f"{p}patch_embed.proj", f"{m}patch_embed.proj", out)
        norm(sd, f"{p}norm", f"{m}visual_norm", out)
        norm(sd, f"{p}LayerNorm", f"{m}LayerNorm", out)
    if "classifier.weight" in sd:
        linear(sd, "classifier", "classifier", out)
    elif "classifier.dense.weight" in sd:
        linear(sd, "classifier.dense", "classifier.dense", out)
        linear(sd, "classifier.out_proj", "classifier.out_proj", out)
    if "qa_outputs.weight" in sd:
        linear(sd, "qa_outputs", "qa_outputs", out)
    return out
