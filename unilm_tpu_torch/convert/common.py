"""Torch state-dict helpers shared by the checkpoint converters (the port's
counterpart of unilm_tpu/convert/common.py, which maps to flax): copies in
float32 on the CPU, Linear and norm pairs, and the patch-embedding Conv2d
as core/embedding.py's flattened projection."""

from __future__ import annotations

from typing import Dict, Mapping

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
