"""Binarized mmap token dataset and token-block packing (port of
unilm_tpu/data/indexed_dataset.py).

A corpus is a .bin file of concatenated token arrays plus a .idx file:
a magic string, a little-endian uint32 header length, a JSON header
{"dtype", "n"}, then int64 sizes [n] and int64 byte pointers [n + 1].
Documents are read through np.memmap, so a host streams a corpus without
loading it. The writer stores int32 tokens; the reader takes the dtype
the header names."""

from __future__ import annotations

import json
import struct
from typing import Iterable, List

import numpy as np

_MAGIC = b"UNILMTPU_IDX1\x00"


class MMapIndexedDataset:
    def __init__(self, path_prefix: str):
        with open(path_prefix + ".idx", "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"{path_prefix}.idx: bad index file")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            self.dtype = np.dtype(header["dtype"])
            n = header["n"]
            self.sizes = np.frombuffer(f.read(8 * n), np.int64)
            self.pointers = np.frombuffer(f.read(8 * (n + 1)), np.int64)
        self._data = np.memmap(path_prefix + ".bin", dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        start = self.pointers[i] // self.dtype.itemsize
        return np.asarray(self._data[start:start + self.sizes[i]])


def build_indexed_dataset(path_prefix: str,
                          sequences: Iterable) -> MMapIndexedDataset:
    """Write `sequences` as an int32 corpus at `path_prefix` and open it."""
    dtype = np.dtype(np.int32)
    sizes = []
    with open(path_prefix + ".bin", "wb") as f:
        for s in sequences:
            arr = np.ascontiguousarray(s, dtype=dtype)
            f.write(arr.tobytes())
            sizes.append(len(arr))
    sizes = np.asarray(sizes, np.int64)
    pointers = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes * dtype.itemsize, out=pointers[1:])
    header = json.dumps({"dtype": dtype.name, "n": len(sizes)}).encode()
    with open(path_prefix + ".idx", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(sizes.tobytes())
        f.write(pointers.tobytes())
    return MMapIndexedDataset(path_prefix)


class TokenBlockIterator:
    """Packs a stream of documents, each followed by `eod`, into fixed
    int32 blocks of `block_size` tokens. State = the source's state and
    the carried tokens."""

    def __init__(self, source, block_size: int, eod: int):
        self._source = source
        self._block = block_size
        self._eod = eod
        self._carry: List[int] = []

    def getstate(self):
        return {"source_state": self._source.getstate(),
                "carry": list(self._carry)}

    def setstate(self, state):
        self._source.setstate(state["source_state"])
        self._carry = list(state["carry"])

    def __next__(self) -> np.ndarray:
        while len(self._carry) < self._block:
            self._carry.extend(int(t) for t in next(self._source))
            self._carry.append(self._eod)
        out = np.asarray(self._carry[:self._block], np.int32)
        self._carry = self._carry[self._block:]
        return out
