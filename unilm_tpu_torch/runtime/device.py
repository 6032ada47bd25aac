"""The device an entry point runs on.

Entry points (`cli/train_gpt.py`, `cli/run_class_finetuning.py`,
`runtime/serving.ServingEngine`) run on the card unless the caller asks
for the CPU: "cuda" is their default, and asking for it on a host without
a visible card raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """torch.device(name); raises RuntimeError for a CUDA device when
    torch.cuda.is_available() is False."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is False; pass --device cpu (device='cpu') to run on the CPU")
    return dev
