"""LayoutLM v1 and MarkupLM checkpoints in HF format (port of
unilm_tpu/convert/docai.py: `convert_layoutlm` :33, `convert_markuplm` :53).

An HF `LayoutLMFor*` / `MarkupLMFor*` state dict (with or without its
`layoutlm.` / `markuplm.` prefix) becomes a flax-layout numpy tree, which
convert/from_jax.load_flax_params (or flax_to_state_dict) takes into the
port's models/layoutlm.py and models/markuplm.py, as convert/kosmos.py's
trees do. The BERT encoder's query/key/value/output Linears become the
Encoder's q/k/v/out projections; the classifier and the QA head are
taken where the state dict has them.
"""

from __future__ import annotations

from typing import Dict, Mapping

from unilm_tpu_torch.convert.common import dense, embed, layernorm


def _bert_encoder(sd: Mapping, prefix: str, num_layers: int) -> Dict:
    layers = {}
    for i in range(num_layers):
        p = f"{prefix}encoder.layer.{i}"
        layers[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": dense(sd, f"{p}.attention.self.query"),
                "k_proj": dense(sd, f"{p}.attention.self.key"),
                "v_proj": dense(sd, f"{p}.attention.self.value"),
                "out_proj": dense(sd, f"{p}.attention.output.dense"),
            },
            "self_attn_layer_norm": layernorm(sd, f"{p}.attention.output.LayerNorm"),
            "ffn": {
                "fc1": dense(sd, f"{p}.intermediate.dense"),
                "fc2": dense(sd, f"{p}.output.dense"),
            },
            "final_layer_norm": layernorm(sd, f"{p}.output.LayerNorm"),
        }
    return layers


def convert_layoutlm(sd: Mapping, cfg) -> Dict:
    sd = dict(sd)
    p = "layoutlm." if any(k.startswith("layoutlm.") for k in sd) else ""
    model = {
        "word_embeddings": embed(sd, f"{p}embeddings.word_embeddings.weight"),
        "position_embeddings": embed(sd, f"{p}embeddings.position_embeddings.weight"),
        "x_position_embeddings": embed(sd, f"{p}embeddings.x_position_embeddings.weight"),
        "y_position_embeddings": embed(sd, f"{p}embeddings.y_position_embeddings.weight"),
        "h_position_embeddings": embed(sd, f"{p}embeddings.h_position_embeddings.weight"),
        "w_position_embeddings": embed(sd, f"{p}embeddings.w_position_embeddings.weight"),
        "token_type_embeddings": embed(sd, f"{p}embeddings.token_type_embeddings.weight"),
        "emb_LayerNorm": layernorm(sd, f"{p}embeddings.LayerNorm"),
        "encoder": _bert_encoder(sd, p, cfg.num_layers),
    }
    params = {"layoutlm": model}
    if "classifier.weight" in sd:
        params["classifier"] = dense(sd, "classifier")
    return params


def convert_markuplm(sd: Mapping, cfg) -> Dict:
    sd = dict(sd)
    p = "markuplm." if any(k.startswith("markuplm.") for k in sd) else ""
    xp = {
        "xpath_unitseq2_inner": dense(
            sd, f"{p}embeddings.xpath_embeddings.xpath_unitseq2_inner"
        ),
        "inner2emb": dense(sd, f"{p}embeddings.xpath_embeddings.inner2emb"),
    }
    for i in range(cfg.max_depth):
        xp[f"tag_emb_{i}"] = embed(
            sd, f"{p}embeddings.xpath_embeddings.xpath_tag_sub_embeddings.{i}.weight"
        )
        xp[f"subs_emb_{i}"] = embed(
            sd, f"{p}embeddings.xpath_embeddings.xpath_subs_sub_embeddings.{i}.weight"
        )
    model = {
        "word_embeddings": embed(sd, f"{p}embeddings.word_embeddings.weight"),
        "position_embeddings": embed(sd, f"{p}embeddings.position_embeddings.weight"),
        "token_type_embeddings": embed(sd, f"{p}embeddings.token_type_embeddings.weight"),
        "emb_LayerNorm": layernorm(sd, f"{p}embeddings.LayerNorm"),
        "xpath_embeddings": xp,
        "encoder": _bert_encoder(sd, p, cfg.num_layers),
    }
    params = {"markuplm": model}
    if "classifier.weight" in sd:
        params["classifier"] = dense(sd, "classifier")
    if "qa_outputs.weight" in sd:
        params["qa_outputs"] = dense(sd, "qa_outputs")
    return params
