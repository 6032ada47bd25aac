"""TrOCR checkpoints: an HF VisionEncoderDecoder state dict (a DeiT/ViT
encoder and the TrOCR decoder) -> the port's `TrOCRModel` state_dict
(port of unilm_tpu/convert/trocr.py `_vit_encoder` :16, `_decoder` :50,
`convert_trocr` :81, the equivalent of the reference's RoBERTa ->
decoder state-dict surgery).

Torch Linear weights keep their [out, in] layout; the patch-embedding
Conv2d weight [E, C, p, p] becomes `proj.weight` [E, p*p*C] in (kh, kw, C)
order (core/embedding.py). The distillation token, the decoder's final
LayerNorm (pre-LN variants), `layernorm_embedding`, the untied
`output_projection` and `enc_to_dec_proj` are copied where the
checkpoint has them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from unilm_tpu_torch.convert.common import linear, norm, patch_proj, tensor
from unilm_tpu_torch.models.trocr import TrOCRConfig

_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")


def _vit_encoder(sd: Mapping, cfg: TrOCRConfig, out: Dict) -> None:
    for i in range(cfg.enc_layers):
        p, d = f"encoder.encoder.layer.{i}", f"vit.encoder.layers.{i}"
        norm(sd, f"{p}.layernorm_before", f"{d}.self_attn_layer_norm", out)
        norm(sd, f"{p}.layernorm_after", f"{d}.final_layer_norm", out)
        for src, dst in (("attention.attention.query", "q_proj"),
                         ("attention.attention.key", "k_proj"),
                         ("attention.attention.value", "v_proj"),
                         ("attention.output.dense", "out_proj")):
            linear(sd, f"{p}.{src}", f"{d}.self_attn.{dst}", out)
        linear(sd, f"{p}.intermediate.dense", f"{d}.ffn.fc1", out)
        linear(sd, f"{p}.output.dense", f"{d}.ffn.fc2", out)
    norm(sd, "encoder.layernorm", "vit.encoder.layer_norm", out)
    emb = "encoder.embeddings"
    out["vit.cls_token"] = tensor(sd[f"{emb}.cls_token"])
    out["vit.pos_embed"] = tensor(sd[f"{emb}.position_embeddings"])
    if f"{emb}.distillation_token" in sd:
        out["vit.dist_token"] = tensor(sd[f"{emb}.distillation_token"])
    patch_proj(sd, f"{emb}.patch_embeddings.projection",
               "vit.patch_embed.proj", out)


def _decoder(sd: Mapping, cfg: TrOCRConfig, out: Dict) -> None:
    pre, dst = "decoder.model.decoder", "text_decoder"
    for i in range(cfg.dec_layers):
        p, d = f"{pre}.layers.{i}", f"{dst}.decoder.layers.{i}"
        for block in ("self_attn", "encoder_attn"):
            for n in _ATTN:
                linear(sd, f"{p}.{block}.{n}", f"{d}.{block}.{n}", out)
            norm(sd, f"{p}.{block}_layer_norm", f"{d}.{block}_layer_norm",
                 out)
        linear(sd, f"{p}.fc1", f"{d}.ffn.fc1", out)
        linear(sd, f"{p}.fc2", f"{d}.ffn.fc2", out)
        norm(sd, f"{p}.final_layer_norm", f"{d}.final_layer_norm", out)
    if f"{pre}.layer_norm.weight" in sd:  # pre-LN variants (trocr-small)
        norm(sd, f"{pre}.layer_norm", f"{dst}.decoder.layer_norm", out)
    out[f"{dst}.embed_tokens.weight"] = tensor(sd[f"{pre}.embed_tokens.weight"])
    out[f"{dst}.embed_positions"] = tensor(sd[f"{pre}.embed_positions.weight"])
    if f"{pre}.layernorm_embedding.weight" in sd:
        norm(sd, f"{pre}.layernorm_embedding", f"{dst}.layernorm_embedding",
             out)
    if "decoder.output_projection.weight" in sd:
        linear(sd, "decoder.output_projection", f"{dst}.output_projection",
               out, bias=False)


def convert_trocr(sd: Mapping, cfg: TrOCRConfig) -> Dict[str, torch.Tensor]:
    """An HF VisionEncoderDecoder state dict -> the state_dict of
    `TrOCRModel(cfg)` (float32 tensors on the CPU)."""
    sd = dict(sd)
    out: Dict[str, torch.Tensor] = {}
    _vit_encoder(sd, cfg, out)
    _decoder(sd, cfg, out)
    if "enc_to_dec_proj.weight" in sd:
        linear(sd, "enc_to_dec_proj", "enc_to_dec_proj", out)
    return out
