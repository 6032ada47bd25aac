"""WavLM converter: an HF `WavLMModel` state dict -> the flax-layout tree
that `convert.from_jax.load_flax_params` loads into models/wavlm.py (port
of unilm_tpu/convert/wavlm.py `convert_wavlm` :12).

HF keeps the positional conv under torch's weight norm
(`parametrizations.weight.original0` = g [1, 1, K], `original1` = v
[O, I/g, K], weight[:, :, k] = g[k] v[:, :, k] / ||v[:, :, k]||, the norm
over the output and input channels, weight_norm's dim=2): the fold gives
the plain kernel. Conv1d weights [O, I, K] become flax kernels [K, I, O].
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from unilm_tpu_torch.convert.common import dense, layernorm, t2n


def convert_wavlm(sd: Mapping, cfg) -> Dict:
    sd = dict(sd)
    p = "wavlm." if any(k.startswith("wavlm.") for k in sd) else ""
    fe = {f"conv_{i}": {"kernel": t2n(
        sd[f"{p}feature_extractor.conv_layers.{i}.conv.weight"]
    ).transpose(2, 1, 0)} for i in range(len(cfg.conv_dim))}
    fe["group_norm"] = layernorm(
        sd, f"{p}feature_extractor.conv_layers.0.layer_norm")
    pc = f"{p}encoder.pos_conv_embed.conv"
    g = t2n(sd[f"{pc}.parametrizations.weight.original0"])
    v = t2n(sd[f"{pc}.parametrizations.weight.original1"])
    norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0, keepdims=True)
    w = v * (g[0] / norm)[None]  # [O, I/g, K]
    params = {
        "feature_extractor": fe,
        "fp_layer_norm": layernorm(sd, f"{p}feature_projection.layer_norm"),
        "fp_projection": dense(sd, f"{p}feature_projection.projection"),
        "pos_conv_embed": {"conv": {"kernel": w.transpose(2, 1, 0),
                                    "bias": t2n(sd[f"{pc}.bias"])}},
        "encoder_layer_norm": layernorm(sd, f"{p}encoder.layer_norm"),
        "rel_attn_embed": t2n(
            sd[f"{p}encoder.layers.0.attention.rel_attn_embed.weight"]),
    }
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layers.{i}"
        params[f"attn_{i}"] = {
            **{n: dense(sd, f"{lp}.attention.{n}")
               for n in ("q_proj", "k_proj", "v_proj", "out_proj",
                         "gru_rel_pos_linear")},
            "gru_rel_pos_const": t2n(sd[f"{lp}.attention.gru_rel_pos_const"]),
        }
        params[f"ln1_{i}"] = layernorm(sd, f"{lp}.layer_norm")
        params[f"fc1_{i}"] = dense(sd, f"{lp}.feed_forward.intermediate_dense")
        params[f"fc2_{i}"] = dense(sd, f"{lp}.feed_forward.output_dense")
        params[f"ln2_{i}"] = layernorm(sd, f"{lp}.final_layer_norm")
    return params
