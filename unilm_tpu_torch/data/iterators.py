"""Checkpointable stream iterators the train CLI uses (port of the
matching part of unilm_tpu/data/iterators.py: `CheckpointableIterator`
:29, `InfinitePermutationSourceIterator`, `MapIterator`,
`SelectManyIterator` :164, `BufferedShuffleIterator` :218,
`FixedBatchIterator`).

Every iterator has getstate()/setstate(state), and setstate(getstate())
reproduces the exact remaining stream, so the data position is part of a
training checkpoint. States survive a JSON round trip (checkpoints store
them as JSON) and are the JAX iterators' states."""

from __future__ import annotations

import random
from typing import Any, Callable, List, Sequence


def _rng_state(s):
    """A random.Random state that went through JSON (lists) back to the
    tuple form random.Random.setstate requires."""
    if isinstance(s, (list, tuple)) and len(s) == 3:
        return (s[0], tuple(s[1]), s[2])
    return s


class CheckpointableIterator:
    """Protocol: __iter__/__next__ + getstate/setstate."""

    def __iter__(self):
        return self

    def __next__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def getstate(self) -> Any:
        raise NotImplementedError

    def setstate(self, state: Any) -> None:
        raise NotImplementedError


class InfinitePermutationSourceIterator(CheckpointableIterator):
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


class MapIterator(CheckpointableIterator):
    def __init__(self, source, transform: Callable):
        self._source = source
        self._fn = transform

    def getstate(self) -> Any:
        return self._source.getstate()

    def setstate(self, state) -> None:
        self._source.setstate(state)

    def __next__(self):
        return self._fn(next(self._source))


class SelectManyIterator(CheckpointableIterator):
    """flat_map with exact resume: state = (the source's state before the
    current expansion, items yielded from it)."""

    def __init__(self, source, collection_selector=None):
        self._source = source
        self._fn = collection_selector or (lambda x: x)
        self.setstate(None)

    def getstate(self):
        if self._pos >= len(self._buffer):
            return {"source_state": self._source.getstate(), "yielded": 0}
        return {"source_state": self._buffer_src_state, "yielded": self._pos}

    def setstate(self, state):
        if state:
            self._source.setstate(state["source_state"])
        self._buffer: List = []
        self._pos = 0
        self._buffer_src_state = self._source.getstate()
        if state and state["yielded"]:
            self._advance_buffer()
            self._pos = state["yielded"]

    def _advance_buffer(self):
        self._buffer_src_state = self._source.getstate()
        self._buffer = list(self._fn(next(self._source)))
        self._pos = 0

    def __next__(self):
        while self._pos >= len(self._buffer):
            self._advance_buffer()
        item = self._buffer[self._pos]
        self._pos += 1
        return item


class BufferedShuffleIterator(CheckpointableIterator):
    """Buffered shuffle; the buffer is part of the state."""

    def __init__(self, source, buffer_size: int, seed: int = 0):
        self._source = source
        self._size = buffer_size
        self._seed = seed
        self.setstate(None)

    def getstate(self):
        return {"source_state": self._source.getstate(),
                "buffer": list(self._buffer),
                "random_state": self._random.getstate()}

    def setstate(self, state):
        self._random = random.Random(self._seed)
        if state:
            self._source.setstate(state["source_state"])
            self._buffer = list(state["buffer"])
            self._random.setstate(_rng_state(state["random_state"]))
        else:
            self._buffer = []
        self._exhausted = False

    def __next__(self):
        while not self._exhausted and len(self._buffer) < self._size:
            try:
                self._buffer.append(next(self._source))
            except StopIteration:
                self._exhausted = True
        if not self._buffer:
            raise StopIteration
        idx = self._random.randrange(len(self._buffer))
        item = self._buffer[idx]
        self._buffer[idx] = self._buffer[-1]
        self._buffer.pop()
        return item


class FixedBatchIterator(CheckpointableIterator):
    """Lists of `batch_size` consecutive items. When a finite source ends
    mid-batch, the short last batch is dropped, as the port's training
    streams want; the JAX iterator yields it (its `drop_last=False`)."""

    def __init__(self, source, batch_size: int):
        self._source = source
        self._bs = batch_size

    def getstate(self) -> Any:
        return self._source.getstate()

    def setstate(self, state: Any) -> None:
        self._source.setstate(state)

    def __next__(self):
        return [next(self._source) for _ in range(self._bs)]
