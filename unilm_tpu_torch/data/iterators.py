"""Checkpointable stream iterators (port of unilm_tpu/data/iterators.py:
`CheckpointableIterator` :29, `NativeCheckpointableIterator` :48,
`InfinitePermutationSourceIterator` :70, `ChunkedSourceIterator` :125,
`MapIterator` :149, `SelectManyIterator` :164, `ZipIterator` :201,
`BufferedShuffleIterator` :218, `FixedBatchIterator` :261,
`BucketedReadaheadBatchIterator` :284, `PrefetchIterator` :375 and
`EpochBatchIterator` :449, with its own copy of unilm_tpu/native's
`batch_by_size`).

Every iterator has getstate()/setstate(state), and setstate(getstate())
reproduces the exact remaining stream, so the data position is part of a
training checkpoint. States survive a JSON round trip (checkpoints store
them as JSON) and are the JAX iterators' states."""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


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

    def close(self):
        pass


class NativeCheckpointableIterator(CheckpointableIterator):
    """A finite re-iterable collection; state = the items consumed."""

    def __init__(self, iterable: Sequence):
        self._iterable = iterable
        self.setstate(None)

    def getstate(self):
        return {"num_items_yielded": self._n}

    def setstate(self, state):
        self._n = state["num_items_yielded"] if state else 0
        self._iterator = iter(self._iterable)
        for _ in range(self._n):
            next(self._iterator)

    def __next__(self):
        item = next(self._iterator)
        self._n += 1
        return item


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


def _split_evenly(n: int, k: int) -> List[int]:
    base, rem = divmod(n, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


class ChunkedSourceIterator(CheckpointableIterator):
    """One pass over items, sharded contiguously across instances."""

    def __init__(self, source_items: Sequence, num_instances: int = 1,
                 instance_rank: int = 0):
        chunks = _split_evenly(len(source_items), num_instances)
        start = sum(chunks[:instance_rank])
        self._items = list(source_items[start:start + chunks[instance_rank]])
        self.setstate(None)

    def getstate(self):
        return {"pos": self._pos}

    def setstate(self, state):
        self._pos = state["pos"] if state else 0

    def __next__(self):
        if self._pos >= len(self._items):
            raise StopIteration
        item = self._items[self._pos]
        self._pos += 1
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


class ZipIterator(CheckpointableIterator):
    """Tuples of one item from each source; state = their states."""

    def __init__(self, *sources: CheckpointableIterator):
        self._sources = sources

    def getstate(self):
        return [s.getstate() for s in self._sources]

    def setstate(self, state):
        if state is None:
            state = [None] * len(self._sources)
        for s, st in zip(self._sources, state):
            s.setstate(st)

    def __next__(self):
        return tuple(next(s) for s in self._sources)


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


class BucketedReadaheadBatchIterator(CheckpointableIterator):
    """Token-based dynamic batching over a sorted read-ahead window
    (infinibatch's; kosmos LMLoader._batchify). State = the source and rng
    states before the current window and the batches consumed from it; a
    resume refills and reshuffles the window deterministically."""

    def __init__(self, source: CheckpointableIterator, read_ahead: int,
                 key: Callable[[Any], int],
                 batch_size_tokens: Optional[int] = None,
                 batch_size: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0):
        if (batch_size_tokens is None) == (batch_size is None):
            raise ValueError("give one of batch_size_tokens / batch_size")
        self._source = source
        self._read_ahead = read_ahead
        self._key = key
        self._bst = batch_size_tokens
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self.setstate(None)

    def getstate(self):
        return {"source_state": self._window_src_state,
                "random_state": self._window_rng_state,
                "batches_consumed": self._consumed}

    def setstate(self, state):
        self._random = random.Random(self._seed)
        if state:
            if state["random_state"] is not None:
                self._random.setstate(_rng_state(state["random_state"]))
            self._source.setstate(state["source_state"])
        self._window_src_state = self._source.getstate()
        self._window_rng_state = self._random.getstate()
        self._batches: List = []
        self._consumed = 0
        if state and state["batches_consumed"]:
            self._fill_window()
            self._consumed = state["batches_consumed"]

    def _fill_window(self):
        self._window_src_state = self._source.getstate()
        self._window_rng_state = self._random.getstate()
        items = []
        try:
            for _ in range(self._read_ahead):
                items.append(next(self._source))
        except StopIteration:
            pass
        if not items:
            raise StopIteration
        items.sort(key=self._key, reverse=True)
        batches: List[List] = []
        if self._bs is not None:
            for i in range(0, len(items), self._bs):
                batches.append(items[i:i + self._bs])
        else:
            cur: List = []
            cur_max = 0
            for it in items:
                k = self._key(it)
                new_max = max(cur_max, k)
                if cur and new_max * (len(cur) + 1) > self._bst:
                    batches.append(cur)
                    cur, new_max = [], k
                cur.append(it)
                cur_max = new_max
            if cur:
                batches.append(cur)
        if self._shuffle:
            self._random.shuffle(batches)
        self._batches = batches
        self._consumed = 0

    def __next__(self):
        if self._consumed >= len(self._batches):
            self._fill_window()
        batch = self._batches[self._consumed]
        self._consumed += 1
        return batch


class PrefetchIterator(CheckpointableIterator):
    """Background-thread prefetch. Each queued item carries the source's
    state after producing it, so getstate() is the consumer's position,
    not the producer's read-ahead."""

    def __init__(self, source: CheckpointableIterator, buffer_size: int = 16):
        self._source = source
        self._buffer_size = buffer_size
        self._thread = None
        self._last_state = source.getstate()
        self._restart()

    def _restart(self):
        import queue
        import threading

        self._stop_thread()
        self._queue = queue.Queue(maxsize=self._buffer_size)
        self._stop = threading.Event()

        def worker():
            try:
                while not self._stop.is_set():
                    try:
                        item = next(self._source)
                    except StopIteration:
                        self._queue.put(("stop", None))
                        return
                    self._queue.put(("item", (item, self._source.getstate())))
            except Exception as e:  # handed to the consumer
                self._queue.put(("error", e))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._started = False

    def _stop_thread(self):
        import queue

        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
        self._thread = None

    def getstate(self):
        return self._last_state

    def setstate(self, state):
        self._stop_thread()
        self._source.setstate(state)
        self._last_state = state
        self._restart()

    def __next__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        kind, payload = self._queue.get()
        if kind == "stop":
            raise StopIteration
        if kind == "error":
            raise payload
        item, state = payload
        self._last_state = state
        return item

    def close(self):
        self._stop_thread()


def batch_by_size(lengths: np.ndarray, max_tokens: int = 0,
                  max_sentences: int = 0,
                  bsz_multiple: int = 1) -> List[np.ndarray]:
    """Index arrays grouping `lengths` (in the given order) into batches
    bounded by the padded token count and the sentence count (fairseq's
    data_utils_fast; the numpy body of unilm_tpu/native's)."""
    lengths = np.ascontiguousarray(lengths, np.int64)
    n = len(lengths)
    batches, start, cur_max = [], 0, 0
    for i in range(n):
        new_max = max(cur_max, int(lengths[i]))
        count = i - start + 1
        overflow = ((max_tokens and new_max * count > max_tokens
                     and count > 1)
                    or (max_sentences and count > max_sentences))
        if overflow:
            close = i - start
            if bsz_multiple > 1 and close > bsz_multiple:
                close -= close % bsz_multiple
            batches.append(np.arange(start, start + close))
            start += close
            cur_max = int(lengths[start:i + 1].max())
        else:
            cur_max = new_max
    if start < n:
        batches.append(np.arange(start, n))
    return batches


class EpochBatchIterator:
    """Resumable epoch-based batching over a map-style dataset (fairseq
    EpochBatchIterator / CountingIterator): a deterministic shuffle per
    epoch, length-sorted `batch_by_size` buckets, and state_dict /
    load_state_dict carrying (epoch, batches consumed)."""

    def __init__(self, dataset, key, max_tokens=0, max_sentences=0, seed=1,
                 shuffle=True):
        self._dataset = dataset
        self._key = key
        self._max_tokens = max_tokens
        self._max_sentences = max_sentences
        self._seed = seed
        self._shuffle = shuffle
        self.epoch = 1
        self._consumed = 0

    def _batches_for_epoch(self, epoch):
        n = len(self._dataset)
        order = np.arange(n)
        if self._shuffle:
            np.random.RandomState(self._seed + epoch).shuffle(order)
        lengths = np.asarray([self._key(self._dataset[int(i)])
                              for i in order])
        # sort within the shuffled order for tight padding, fairseq-style
        srt = np.argsort(lengths, kind="stable")
        order = order[srt]
        batches = batch_by_size(lengths[srt], max_tokens=self._max_tokens,
                                max_sentences=self._max_sentences)
        out = [order[b] for b in batches]
        if self._shuffle:
            np.random.RandomState(self._seed + epoch + 57).shuffle(out)
        return out

    def next_epoch_itr(self):
        batches = self._batches_for_epoch(self.epoch)
        start = self._consumed

        def gen():
            for i in range(start, len(batches)):
                self._consumed = i + 1
                yield [self._dataset[int(j)] for j in batches[i]]
            self.epoch += 1
            self._consumed = 0

        return gen()

    def state_dict(self):
        return {"epoch": self.epoch, "consumed": self._consumed}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self._consumed = state["consumed"]
