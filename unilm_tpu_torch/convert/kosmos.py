"""Kosmos-2 / Kosmos-2.5 converters (port of unilm_tpu/convert/kosmos.py:
`convert_pix2struct_vision` :18, `convert_clip_visual` :46,
`convert_unigpt` :80 with the connector's map): a fairseq checkpoint's
`gpt_model.decoder.*`, `img_model.*` and `img_connector.*` tensors
become a flax-layout numpy tree, which convert/from_jax.load_flax_params
(or flax_to_state_dict) takes into the port's UniGPT."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from unilm_tpu_torch.convert.common import dense, embed, layernorm, t2n


def _rms(sd: Mapping, prefix: str) -> Dict:
    return {"scale": t2n(sd[f"{prefix}.weight"])}


def convert_pix2struct_vision(sd: Mapping, num_layers: int,
                              prefix: str = "") -> Dict:
    """HF Pix2StructVisionModel state dict -> Pix2StructVisionEncoder
    params."""
    layers = {}
    for i in range(num_layers):
        p = f"{prefix}encoder.layer.{i}"
        layers[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": dense(sd, f"{p}.attention.query", bias=False),
                "k_proj": dense(sd, f"{p}.attention.key", bias=False),
                "v_proj": dense(sd, f"{p}.attention.value", bias=False),
                "out_proj": dense(sd, f"{p}.attention.output", bias=False),
            },
            "self_attn_layer_norm": _rms(sd, f"{p}.pre_attention_layer_norm"),
            "ffn": {
                "fc1": dense(sd, f"{p}.mlp.wi_0", bias=False),
                "fc3": dense(sd, f"{p}.mlp.wi_1", bias=False),
                "fc2": dense(sd, f"{p}.mlp.wo", bias=False),
            },
            "final_layer_norm": _rms(sd, f"{p}.pre_mlp_layer_norm"),
        }
    return {
        "patch_projection": dense(sd, f"{prefix}embeddings.patch_projection"),
        "row_embedder": embed(sd, f"{prefix}embeddings.row_embedder.weight"),
        "column_embedder": embed(
            sd, f"{prefix}embeddings.column_embedder.weight"),
        "encoder": layers,
        "layernorm": _rms(sd, f"{prefix}layernorm"),
    }


def convert_clip_visual(sd: Mapping, num_layers: int,
                        prefix: str = "visual.") -> Dict:
    """open_clip / CLIP visual tower (Kosmos-2's ClipVisualOnly) ->
    ClipVisionEncoder params; each block's packed in_proj [3E, E] splits
    into q/k/v."""
    layers = {}
    for i in range(num_layers):
        p = f"{prefix}transformer.resblocks.{i}"
        w = t2n(sd[f"{p}.attn.in_proj_weight"])  # [3E, E] packed
        b = t2n(sd[f"{p}.attn.in_proj_bias"])
        qw, kw, vw = np.split(w, 3, axis=0)
        qb, kb, vb = np.split(b, 3, axis=0)
        layers[f"layers_{i}"] = {
            "self_attn_layer_norm": layernorm(sd, f"{p}.ln_1"),
            "final_layer_norm": layernorm(sd, f"{p}.ln_2"),
            "self_attn": {
                "q_proj": {"kernel": qw.T, "bias": qb},
                "k_proj": {"kernel": kw.T, "bias": kb},
                "v_proj": {"kernel": vw.T, "bias": vb},
                "out_proj": dense(sd, f"{p}.attn.out_proj"),
            },
            "ffn": {
                "fc1": dense(sd, f"{p}.mlp.c_fc"),
                "fc2": dense(sd, f"{p}.mlp.c_proj"),
            },
        }
    return {
        # torch Conv2d [O, I, kh, kw] -> flax Conv [kh, kw, I, O]
        "conv1": {"kernel": t2n(sd[f"{prefix}conv1.weight"]).transpose(
            2, 3, 1, 0)},
        "class_embedding": t2n(sd[f"{prefix}class_embedding"]),
        "positional_embedding": t2n(sd[f"{prefix}positional_embedding"]),
        "ln_pre": layernorm(sd, f"{prefix}ln_pre"),
        "ln_post": layernorm(sd, f"{prefix}ln_post"),
        "transformer": layers,
    }


def convert_unigpt(sd: Mapping, cfg, pix2struct_layers: int = 0,
                   clip_layers: int = 0) -> Dict:
    """fairseq Kosmos checkpoint ('model' state dict) -> UniGPT params.

    Key layout of kosmos-2.5's models/{gpt,unigpt}.py: UniGPTmodel holds
    gpt_model / img_model / img_connector, and GPTmodel's decoder is the
    torchscale LMDecoder, so checkpoints name gpt_model.decoder.layers.N.*;
    a standalone GPTmodel dict uses bare decoder.*."""
    pix2struct_layers = pix2struct_layers or getattr(
        cfg.pix2struct, "num_layers", 18)
    clip_layers = clip_layers or getattr(cfg.clip, "num_layers", 24)
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    sd = {k.removeprefix("gpt_model."): v for k, v in sd.items()}
    dec = "decoder."

    layers = {}
    for i in range(cfg.num_layers):
        p = f"{dec}layers.{i}"
        layer = {
            "self_attn": {
                n: dense(sd, f"{p}.self_attn.{n}")
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "self_attn_layer_norm": layernorm(sd, f"{p}.self_attn_layer_norm"),
            "ffn": {
                "fc1": dense(sd, f"{p}.ffn.fc1"),
                "fc2": dense(sd, f"{p}.ffn.fc2"),
            },
            "final_layer_norm": layernorm(sd, f"{p}.final_layer_norm"),
        }
        if f"{p}.ffn.ffn_layernorm.weight" in sd:  # subln
            layer["ffn"]["ffn_layernorm"] = layernorm(
                sd, f"{p}.ffn.ffn_layernorm")
        if f"{p}.self_attn.inner_attn_ln.weight" in sd:
            layer["self_attn"]["inner_attn_ln"] = layernorm(
                sd, f"{p}.self_attn.inner_attn_ln")
        layers[f"layers_{i}"] = layer
    if f"{dec}layer_norm.weight" in sd:
        layers["layer_norm"] = layernorm(sd, f"{dec}layer_norm")

    params = {
        "embed_tokens": embed(sd, f"{dec}embed_tokens.weight"),
        "decoder": layers,
    }
    if (f"{dec}output_projection.weight" in sd
            and not cfg.share_input_output_embed):
        params["output_projection"] = dense(sd, f"{dec}output_projection",
                                            bias=False)
    if f"{dec}embed_positions.weight" in sd and cfg.learned_pos:
        params["embed_positions"] = embed(sd, f"{dec}embed_positions.weight")
    # torchscale's TextEmbedding subclasses nn.Embedding: segment_emb.weight
    if f"{dec}segment_emb.weight" in sd:
        params["segment_emb"] = embed(sd, f"{dec}segment_emb.weight")

    if any(k.startswith("img_model.") for k in sd):
        if cfg.image_tower == "pix2struct":
            params["img_model"] = convert_pix2struct_vision(
                sd, pix2struct_layers, prefix="img_model.")
        else:
            params["img_model"] = convert_clip_visual(
                sd, clip_layers, prefix="img_model.visual.")
    if "img_connector.dense.weight" in sd:
        params["img_connector"] = {
            "dense": dense(sd, "img_connector.dense"),
            "latent_query": t2n(sd["img_connector.latent_query"]),
            "x_attn": {
                n: dense(sd, f"img_connector.x_attn.{n}")
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
        }
    return params
