"""Tracing and profiling spans (port of unilm_tpu/runtime/profiling.py:
`named_scope` :19, `trace_annotation` :25, `profile` :30, `StepTimer`
:44).

The reference wraps train_inner, the gradient reduction, clipping and the
optimizer in torch.autograd.profiler.record_function spans and emits NVTX
under --profile (fairseq_cli/train.py:375, 600). Here a named scope and a
host span are both `torch.profiler.record_function`; `profile(logdir)`
records a torch.profiler trace of the CPU and, where there is one, the
card, written as a Chrome trace under `logdir`; `StepTimer` synchronises
the card before it reads the clock at either end of a span, so a span
holds the device work launched in it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def named_scope(name: str):
    """A span around the ops issued within, in profiler timelines."""
    return torch.profiler.record_function(name)


def trace_annotation(name: str):
    """A host-side span for the profiler timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile(logdir: Optional[str]):
    """`with profile(dir):` records a trace of the block into
    dir/trace.json (Chrome format); None records nothing. Yields the
    torch.profiler.profile (or None)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock span totals for the train loop (fairseq's train_wall /
    reduce meters); the card is synchronised at both ends of a span."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        _sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        _sync()
        self.totals[name] = (self.totals.get(name, 0.0)
                             + time.perf_counter() - t0)
