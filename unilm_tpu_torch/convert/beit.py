"""BEiT / DiT checkpoints -> the port's `BeitForImageClassification` or
`BeitForMaskedImageModeling` state_dict (port of unilm_tpu/convert/beit.py
`convert_beit`, `_from_timm` :28, `_from_hf` :92).

Two serialisations of the family:
- HF `BeitForImageClassification` / `BeitModel` state dicts (`beit.*`);
- reference timm-style checkpoints (beit/modeling_finetune.py names:
  cls_token, patch_embed.proj, blocks.i.attn.qkv + q_bias/v_bias,
  gamma_1/gamma_2, rel_pos_bias tables), which DiT releases use too; a
  pretraining checkpoint (beit/modeling_pretrain.py: `lm_head`, its
  `norm`, `mask_token`, the shared `rel_pos_bias`) maps onto the MIM
  model's `norm` and `lm_head`, as the JAX converter maps it (:84-88).

Torch Linear weights keep their [out, in] layout. The patch-embedding
Conv2d weight [E, C, p, p] becomes `proj.weight` [E, p*p*C] in (kh, kw, C)
order (core/embedding.py). BEiT packs q/k/v with no key bias; the key
bias is zero, which the softmax ignores.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from unilm_tpu_torch.convert.common import linear, norm, patch_proj, tensor
from unilm_tpu_torch.models.beit import BeitConfig


PATCH_PROJ = "backbone.embeddings.patch_embed.proj"


def convert_beit(sd: Mapping, cfg: BeitConfig) -> Dict[str, torch.Tensor]:
    """A timm/unilm or HF BEiT state_dict -> the state_dict of
    `BeitForImageClassification(cfg)`, or of
    `BeitForMaskedImageModeling(cfg)` for a timm pretraining checkpoint
    (one with `lm_head`)."""
    sd = dict(sd)
    if any(k.startswith("beit.") for k in sd):
        return _from_hf(sd, cfg)
    return _from_timm(sd, cfg)


def _from_timm(sd: Mapping, cfg: BeitConfig) -> Dict[str, torch.Tensor]:
    E = cfg.embed_dim
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        p, d = f"blocks.{i}", f"backbone.encoder.layers.{i}"
        norm(sd, f"{p}.norm1", f"{d}.self_attn_layer_norm", out)
        norm(sd, f"{p}.norm2", f"{d}.final_layer_norm", out)
        qkv = tensor(sd[f"{p}.attn.qkv.weight"])
        zeros = torch.zeros(E)
        biases = (sd.get(f"{p}.attn.q_bias"), None, sd.get(f"{p}.attn.v_bias"))
        for name, w, b in zip(("q_proj", "k_proj", "v_proj"),
                              qkv.split(E, dim=0), biases):
            out[f"{d}.self_attn.{name}.weight"] = w.contiguous()
            out[f"{d}.self_attn.{name}.bias"] = (tensor(b) if b is not None
                                                 else zeros.clone())
        linear(sd, f"{p}.attn.proj", f"{d}.self_attn.out_proj", out)
        linear(sd, f"{p}.mlp.fc1", f"{d}.ffn.fc1", out)
        linear(sd, f"{p}.mlp.fc2", f"{d}.ffn.fc2", out)
        if f"{p}.gamma_1" in sd:
            out[f"{d}.gamma_1.gamma"] = tensor(sd[f"{p}.gamma_1"])
            out[f"{d}.gamma_2.gamma"] = tensor(sd[f"{p}.gamma_2"])
        key = f"{p}.attn.relative_position_bias_table"
        if key in sd:
            out[f"backbone.rel_pos_bias_{i}.relative_position_bias_table"] = (
                tensor(sd[key]))
    out["backbone.embeddings.cls_token"] = tensor(sd["cls_token"])
    patch_proj(sd, "patch_embed.proj", PATCH_PROJ, out)
    if "mask_token" in sd:
        out["backbone.embeddings.mask_token"] = tensor(sd["mask_token"])
    if "pos_embed" in sd:
        out["backbone.pos_embed"] = tensor(sd["pos_embed"])
    if "rel_pos_bias.relative_position_bias_table" in sd:
        out["backbone.rel_pos_bias.relative_position_bias_table"] = tensor(
            sd["rel_pos_bias.relative_position_bias_table"])
    if "norm.weight" in sd:
        norm(sd, "norm", "backbone.encoder.layer_norm", out)
    if "fc_norm.weight" in sd:
        norm(sd, "fc_norm", "fc_norm", out)
    if "head.weight" in sd:
        linear(sd, "head", "head", out)
    if "lm_head.weight" in sd:  # pretraining: `norm` is the MIM head's
        linear(sd, "lm_head", "lm_head", out)
        norm(sd, "norm", "norm", out)
        for k in ("weight", "bias"):
            out.pop(f"backbone.encoder.layer_norm.{k}", None)
    return out


def _from_hf(sd: Mapping, cfg: BeitConfig) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        p, d = f"beit.encoder.layer.{i}", f"backbone.encoder.layers.{i}"
        a = f"{p}.attention.attention"
        norm(sd, f"{p}.layernorm_before", f"{d}.self_attn_layer_norm", out)
        norm(sd, f"{p}.layernorm_after", f"{d}.final_layer_norm", out)
        linear(sd, f"{a}.query", f"{d}.self_attn.q_proj", out)
        linear(sd, f"{a}.key", f"{d}.self_attn.k_proj", out)  # bias 0
        linear(sd, f"{a}.value", f"{d}.self_attn.v_proj", out)
        linear(sd, f"{p}.attention.output.dense", f"{d}.self_attn.out_proj",
                out)
        linear(sd, f"{p}.intermediate.dense", f"{d}.ffn.fc1", out)
        linear(sd, f"{p}.output.dense", f"{d}.ffn.fc2", out)
        if f"{p}.lambda_1" in sd:
            out[f"{d}.gamma_1.gamma"] = tensor(sd[f"{p}.lambda_1"])
            out[f"{d}.gamma_2.gamma"] = tensor(sd[f"{p}.lambda_2"])
        key = f"{a}.relative_position_bias.relative_position_bias_table"
        if key in sd:
            out[f"backbone.rel_pos_bias_{i}.relative_position_bias_table"] = (
                tensor(sd[key]))
    out["backbone.embeddings.cls_token"] = tensor(sd["beit.embeddings.cls_token"])
    patch_proj(sd, "beit.embeddings.patch_embeddings.projection", PATCH_PROJ, out)
    if "beit.embeddings.mask_token" in sd:
        out["backbone.embeddings.mask_token"] = tensor(
            sd["beit.embeddings.mask_token"])
    if "beit.embeddings.position_embeddings" in sd:
        out["backbone.pos_embed"] = tensor(sd["beit.embeddings.position_embeddings"])
    shared = "beit.encoder.relative_position_bias.relative_position_bias_table"
    if shared in sd:
        out["backbone.rel_pos_bias.relative_position_bias_table"] = tensor(
            sd[shared])
    if "beit.layernorm.weight" in sd:
        norm(sd, "beit.layernorm", "backbone.encoder.layer_norm", out)
    if "beit.pooler.layernorm.weight" in sd:
        norm(sd, "beit.pooler.layernorm", "fc_norm", out)
    if "classifier.weight" in sd:
        linear(sd, "classifier", "head", out)
    return out
