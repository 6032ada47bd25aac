"""OpenAI DALL-E encoder weights -> the port's `DalleEncoder` (port of
unilm_tpu/convert/dalle.py).

The released encoder.pkl (beit/dall_e/encoder.py) names its convolutions
blocks.input, blocks.group_N.block_M.{id_path, res_path.conv_K} and
blocks.output.conv, each a Conv2d with `.w` [O, I, k, k] and `.b` [O].
The port's convolutions keep that OIHW layout (models/dalle_vae.py), so
each maps onto `{name}.weight` / `{name}.bias` unchanged, in float32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from unilm_tpu_torch.models.dalle_vae import DalleEncoderConfig


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.array(t, dtype=np.float32))


def _conv(sd: Mapping, src: str, dst: str, out: Dict) -> None:
    out[f"{dst}.weight"] = _tensor(sd[f"{src}.w"])
    out[f"{dst}.bias"] = _tensor(sd[f"{src}.b"])


def convert_dalle_encoder(sd: Mapping,
                          cfg: Optional[DalleEncoderConfig] = None
                          ) -> Dict[str, torch.Tensor]:
    """A dall_e Encoder's state dict (torch tensors or a plain name ->
    array mapping) -> the state dict of `DalleEncoder(cfg)`."""
    cfg = cfg or DalleEncoderConfig()
    out: Dict[str, torch.Tensor] = {}
    _conv(sd, "blocks.input", "input", out)
    for gi in range(1, cfg.group_count + 1):
        for bi in range(1, cfg.n_blk_per_group + 1):
            p, d = f"blocks.group_{gi}.block_{bi}", f"group_{gi}_block_{bi}"
            for k in range(1, 5):
                _conv(sd, f"{p}.res_path.conv_{k}", f"{d}.conv_{k}", out)
            if f"{p}.id_path.w" in sd:
                _conv(sd, f"{p}.id_path", f"{d}.id_path", out)
    _conv(sd, "blocks.output.conv", "output", out)
    return out
