"""Progress logging (port of unilm_tpu/runtime/logging.py: `JsonlLogger`
and `find_nonfinite`, the two the train CLI uses; the TensorBoard, W&B
and watchdog sinks are not ported)."""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Mapping, Optional

import torch


class JsonlLogger:
    """One JSON object per line: tag, step, wall time and the stats."""

    def __init__(self, path: Optional[str] = None, stream=None):
        self._fh = open(path, "a") if path else (stream or sys.stdout)

    def log(self, stats: Dict, step: int, tag: str = "train"):
        rec = {"tag": tag, "step": step, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in stats.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()


def find_nonfinite(tensors: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """NanDetector equivalent (fairseq/nan_detector.py): the number of
    NaN/Inf elements of each tensor of a state dict that has any."""
    bad = {}
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            n = int((~torch.isfinite(t)).sum())
            if n:
                bad[name] = n
    return bad
