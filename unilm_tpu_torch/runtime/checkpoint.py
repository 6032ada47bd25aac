"""Checkpoint manager: model + optimizer + step + data-stream state,
keep-last rotation (port of unilm_tpu/runtime/checkpoint.py, whose
contract is fairseq/checkpoint_utils.py's; its keep-best rotation, which
no caller uses, is not ported).

Built on torch.save. Directory layout: <dir>/step_<N>/{state.pt,
extra.json}; `extra.json` holds the step, the data-stream position
(CheckpointableIterator.getstate(), JSON) and metrics. A step exists only
once it is committed: both files are written into a temporary directory,
`step_<N>.tmp.<pid>`, which is then renamed to `step_<N>` in one atomic
step. A crash mid-save leaves only a temporary directory, which
`all_steps` ignores and `restore` therefore skips, falling back to the
previous step; a later save's rotation removes it.

The JAX manager writes its arrays asynchronously (orbax) and `wait()`
barriers on that write; here `save` returns after the rename, so `wait()`
has nothing to wait for and is kept for the caller's contract.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, (tuple, np.ndarray)):
        return list(o)
    if isinstance(o, torch.Tensor):
        return o.item() if o.numel() == 1 else o.tolist()
    raise TypeError(str(type(o)))


class CheckpointManager:
    """Directory layout: <dir>/step_<N>/{state.pt, extra.json}."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.keep_last = keep_last

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}")

    def _complete(self, step: int) -> bool:
        path = self._step_dir(step)
        return all(os.path.exists(os.path.join(path, f))
                   for f in ("state.pt", "extra.json"))

    def all_steps(self, include_incomplete: bool = False):
        steps = []
        for name in os.listdir(self.dir):
            parts = name.split("_")
            if len(parts) == 2 and parts[0] == "step" and parts[1].isdigit():
                steps.append(int(parts[1]))
        if not include_incomplete:
            steps = [s for s in steps if self._complete(s)]
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, data_state: Any = None,
             metrics: Optional[dict] = None) -> None:
        """Write `state` (anything torch.save takes, e.g.
        TrainState.state_dict()) and the JSON extras, then commit."""
        path = self._step_dir(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        extra = {"step": step, "data_state": data_state,
                 "metrics": metrics or {}}
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f, default=_json_default)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._rotate()

    def _rotate(self):
        """keep-last-N rotation; leftover temporary directories of crashed
        saves go too."""
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp." in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
        steps = self.all_steps(include_incomplete=True)
        keep = set(steps[-self.keep_last:] if self.keep_last else steps)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None, map_location=None):
        """(state, data_state, metrics) of `step` or of the latest complete
        step, or None if there is none."""
        steps = [step] if step is not None else list(reversed(
            self.all_steps()))
        for s in steps:
            if not self._complete(s):
                continue
            path = self._step_dir(s)
            state = torch.load(os.path.join(path, "state.pt"),
                               map_location=map_location, weights_only=False)
            with open(os.path.join(path, "extra.json")) as f:
                extra = json.load(f)
            return state, extra.get("data_state"), extra.get("metrics", {})
        return None
