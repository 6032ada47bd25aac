"""Scoped metric aggregation and meters (port of
unilm_tpu/runtime/metrics.py: `AverageMeter` :18, `SpeedMeter` :32,
`SmoothedValue` :49, `aggregate` :99, `log_scalar` / `log_speed` /
`log_derived` :125-140, `get_smoothed_values` :143 and `reset_meters`).

fairseq/logging/metrics.py's nested aggregate() scopes, log_scalar with
weights, log_speed and log_derived, and beit's SmoothedValue. The meters
are host-side: a caller logs Python floats (a train step's metrics are
read off the card once per step), and nothing here reduces across
processes.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.weight = 0.0

    def update(self, value: float, weight: float = 1.0):
        self.sum += value * weight
        self.weight += weight

    @property
    def avg(self) -> float:
        return self.sum / self.weight if self.weight else 0.0


class SpeedMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.perf_counter()
        self.n = 0.0

    def update(self, n: float = 1.0):
        self.n += n

    @property
    def avg(self) -> float:
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0


class SmoothedValue:
    """Windowed median / average and the global average (beit/utils.py)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / self.count if self.count else 0.0


class _Aggregator:
    def __init__(self, name: str):
        self.name = name
        self.meters: Dict[str, object] = {}
        self.derived: Dict[str, Callable] = {}

    def get_smoothed_values(self) -> Dict[str, float]:
        out = {k: m.avg for k, m in self.meters.items()}
        for k, fn in self.derived.items():
            out[k] = fn(out)
        return out


_STACK: List[_Aggregator] = [_Aggregator("default")]
_NAMED: Dict[str, _Aggregator] = {"default": _STACK[0]}


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Nested scopes: every log_* call goes to each aggregator on the
    stack (fairseq metrics.aggregate); `new_root` hides the outer ones."""
    agg = _Aggregator(name or f"anon_{len(_NAMED)}")
    if name:
        _NAMED[name] = agg
    saved = None
    if new_root:
        saved = _STACK[:]
        _STACK.clear()
        _STACK.append(_Aggregator("default"))
    _STACK.append(agg)
    try:
        yield agg
    finally:
        _STACK.remove(agg)
        if new_root:
            _STACK.clear()
            _STACK.extend(saved)


def log_scalar(key: str, value: float, weight: float = 1.0):
    for agg in list(_STACK):
        agg.meters.setdefault(key, AverageMeter()).update(float(value),
                                                          weight)


def log_speed(key: str, n: float):
    for agg in list(_STACK):
        agg.meters.setdefault(key, SpeedMeter()).update(n)


def log_derived(key: str, fn: Callable[[Dict[str, float]], float]):
    for agg in list(_STACK):
        agg.derived[key] = fn


def get_smoothed_values(name: str = "default") -> Dict[str, float]:
    return _NAMED[name].get_smoothed_values()


def reset_meters(name: str = "default"):
    if name in _NAMED:
        _NAMED[name].meters.clear()
        _NAMED[name].derived.clear()
