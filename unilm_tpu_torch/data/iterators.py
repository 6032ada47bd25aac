"""Checkpointable stream iterators the train CLI uses (port of the
matching part of unilm_tpu/data/iterators.py).

Every iterator has getstate()/setstate(state), and setstate(getstate())
reproduces the exact remaining stream, so the data position is part of a
training checkpoint. States survive a JSON round trip (checkpoints store
them as JSON) and are the JAX iterators' states."""

from __future__ import annotations

import random
from typing import Any, Callable, Sequence


def _rng_state(s):
    """A random.Random state that went through JSON (lists) back to the
    tuple form random.Random.setstate requires."""
    if isinstance(s, (list, tuple)) and len(s) == 3:
        return (s[0], tuple(s[1]), s[2])
    return s


class InfinitePermutationSourceIterator:
    """Infinite stream of reshuffled permutations of `source_items`. State
    = the rng state at the start of the current permutation and the index
    within it."""

    def __init__(self, source_items: Sequence, seed: int = 0):
        if not source_items:
            raise ValueError("source_items must not be empty")
        self._items = list(source_items)
        self._seed = seed
        self.setstate(None)

    def getstate(self):
        return {"random_state": self._base_state, "index": self._index}

    def setstate(self, state):
        self._random = random.Random(self._seed)
        if state and state["random_state"] is not None:
            self._random.setstate(_rng_state(state["random_state"]))
        self._base_state = self._random.getstate()
        self._index = state["index"] if state else 0
        self._perm = list(self._items)
        self._random.shuffle(self._perm)

    def __next__(self):
        n = len(self._items)
        while self._index >= n:
            self._index -= n
            self._base_state = self._random.getstate()
            # shuffle a fresh copy, so setstate(base_state) regenerates
            # the same permutation
            self._perm = list(self._items)
            self._random.shuffle(self._perm)
        item = self._perm[self._index]
        self._index += 1
        return item


class MapIterator:
    def __init__(self, source, transform: Callable):
        self._source = source
        self._fn = transform

    def getstate(self) -> Any:
        return self._source.getstate()

    def setstate(self, state) -> None:
        self._source.setstate(state)

    def __next__(self):
        return self._fn(next(self._source))


class FixedBatchIterator:
    """Lists of `batch_size` consecutive items; a short last batch is
    dropped."""

    def __init__(self, source, batch_size: int):
        self._source = source
        self._bs = batch_size

    def getstate(self) -> Any:
        return self._source.getstate()

    def setstate(self, state) -> None:
        self._source.setstate(state)

    def __next__(self):
        return [next(self._source) for _ in range(self._bs)]
