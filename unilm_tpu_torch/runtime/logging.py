"""Progress logging sinks (port of unilm_tpu/runtime/logging.py:
`JsonlLogger` :14, `TensorboardLogger` :25, `WandbLogger` :56,
`StepWatchdog` :80, `MultiLogger` :143 and `find_nonfinite` :152).

fairseq's json / tensorboard / W&B progress wrappers
(progress_bar.py:331-445), beit's TensorboardLogger and fairseq's
DistributedTimeoutWrapper as a step watchdog. The TensorBoard sink uses
torch.utils.tensorboard and the W&B sink `wandb`; each is a no-op when
its library is absent or fails to start, as in JAX.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
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


class TensorboardLogger:
    """Scalars `tag/key` into a torch.utils.tensorboard SummaryWriter; a
    no-op when tensorboard is absent."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        except Exception:
            self._writer = None

    def log(self, stats: Dict, step: int, tag: str = "train"):
        if self._writer is None:
            return
        for k, v in stats.items():
            try:
                self._writer.add_scalar(f"{tag}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self):
        if self._writer is not None:
            self._writer.flush()


class WandbLogger:
    """Weights & Biases sink (fairseq's WandBProgressBar); a no-op when
    wandb is not installed or not configured."""

    def __init__(self, project: str, run_name: Optional[str] = None,
                 config: Optional[Dict] = None):
        self._run = None
        try:
            import wandb

            self._run = wandb.init(project=project, name=run_name,
                                   config=config or {})
        except Exception:
            self._run = None

    def log(self, stats: Dict, step: int, tag: str = "train"):
        if self._run is None:
            return
        self._run.log({f"{tag}/{k}": v for k, v in stats.items()}, step=step)

    def flush(self):
        pass


class StepWatchdog:
    """Hung-step watchdog: a daemon thread calls `on_timeout` when `beat()`
    has not been called for `timeout_s` (a wedged collective or kernel
    that would hang the job). The default action logs and SIGTERMs the
    process, so the launcher restarts it from the last checkpoint."""

    def __init__(self, timeout_s: float, on_timeout=None):
        self.timeout_s = timeout_s
        self._on_timeout = on_timeout or self._default_action
        self._last = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def _default_action(self):
        print(f"StepWatchdog: no heartbeat for {self.timeout_s}s; killing "
              "the process for a restart from the checkpoint",
              file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGTERM)

    def start(self):
        self._last = time.monotonic()
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _watch(self):
        while not self._stop.wait(min(self.timeout_s / 4.0, 1.0)):
            if (self._last is not None
                    and time.monotonic() - self._last > self.timeout_s):
                self._on_timeout()
                return

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class MultiLogger:
    """Fans a log call out to every sink given (None entries dropped)."""

    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log(self, stats: Dict, step: int, tag: str = "train"):
        for lg in self.loggers:
            lg.log(stats, step, tag)


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
