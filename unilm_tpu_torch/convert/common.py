"""Helpers shared by the checkpoint converters.

State-dict direction (the BEiT and LayoutLMv3 converters): copies in
float32 on the CPU, Linear and norm pairs, and the patch-embedding Conv2d
as core/embedding.py's flattened projection.

Flax-layout direction (convert/kosmos.py, which builds a tree for
convert/from_jax.load_flax_params): copies of unilm_tpu/convert/common.py
`t2n`, `dense`, `layernorm` and `embed`, giving numpy leaves."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def tensor(x) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).contiguous()


def linear(sd: Mapping, src: str, dst: str, out: Dict,
           bias: bool = True) -> None:
    """`{src}.weight/bias` -> `{dst}.weight/bias` (a missing bias is 0)."""
    w = tensor(sd[f"{src}.weight"])
    out[f"{dst}.weight"] = w
    if bias:
        b = sd.get(f"{src}.bias")
        out[f"{dst}.bias"] = tensor(b) if b is not None else torch.zeros(w.shape[0])


def norm(sd: Mapping, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.weight"] = tensor(sd[f"{src}.weight"])
    out[f"{dst}.bias"] = tensor(sd[f"{src}.bias"])


def patch_proj(sd: Mapping, src: str, dst: str, out: Dict) -> None:
    """Conv2d [E, C, kh, kw] -> `{dst}.weight` [E, kh*kw*C] in (kh, kw, C)
    order (core/embedding.py's patchify), `{dst}.bias`."""
    w = tensor(sd[f"{src}.weight"])
    out[f"{dst}.weight"] = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()
    b = sd.get(f"{src}.bias")
    out[f"{dst}.bias"] = tensor(b) if b is not None else torch.zeros(w.shape[0])


def t2n(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy())


def dense(sd: Mapping, prefix: str, bias: bool = True) -> Dict:
    """torch nn.Linear '{prefix}.weight/bias' -> flax Dense {kernel, bias}
    (a missing bias is zeros)."""
    out = {"kernel": t2n(sd[f"{prefix}.weight"]).T}
    if bias:
        b = sd.get(f"{prefix}.bias")
        out["bias"] = (t2n(b) if b is not None
                       else np.zeros(out["kernel"].shape[1], np.float32))
    return out


def layernorm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": t2n(sd[f"{prefix}.weight"]),
            "bias": t2n(sd[f"{prefix}.bias"])}


def embed(sd: Mapping, key: str) -> Dict:
    return {"embedding": t2n(sd[key])}
