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
- a stacked `layers` subtree -> one module per layer (`layers.{i}`),
  `layers_{i}` -> `layers.{i}`.

No jax import: bfloat16 leaves (ml_dtypes arrays) are reinterpreted bit
for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}


def to_tensor(a) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_QUANT_LEAF = {"kernel_i8": "weight_i8", "scale": "scale", "bias": "bias"}


def _leaf(name: str, value: np.ndarray, quant: bool) -> tuple:
    table = _QUANT_LEAF if quant else _LEAF
    if name not in table:
        raise KeyError(f"unmapped flax leaf {name!r}")
    if name in ("kernel", "kernel_i8"):
        value = np.swapaxes(value, -1, -2)  # [(L,) in, out] -> [(L,) out, in]
    return table[name], value


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten a flax param tree into the port's state_dict names."""
    out: Dict[str, torch.Tensor] = {}

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
            name, arr = _leaf(key, np.asarray(val), "kernel_i8" in tree)
            path = f"{prefix}{name}"
            if stacked:
                for i in range(arr.shape[0]):
                    out[path.format(i=i)] = to_tensor(arr[i])
            else:
                out[path] = to_tensor(arr)

    walk(params, "", False)
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy a flax param tree into `model` (strict: every leaf of the tree
    and every parameter of the model must be matched)."""
    sd = flax_to_state_dict(params)
    model.load_state_dict(sd, strict=True)
