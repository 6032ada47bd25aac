"""Webdataset-style tar-shard streaming (port of
unilm_tpu/data/webdataset.py: DiT RVL-CDIP classification input).

Samples live in POSIX tar shards as `<key>.<ext>` member groups (e.g.
`0001.png` + `0001.cls`), streamed without unpacking to disk. The
pipeline is built on the port's data/iterators.py (the
CheckpointableIterator algebra), so the stream position (shard
permutation, offset within a shard, shuffle buffer) checkpoints and
resumes exactly; images decode with PIL; batches are fixed-shape numpy
arrays. A copy of JAX's module with the port's iterators.
"""

from __future__ import annotations

import io
import tarfile
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from unilm_tpu_torch.data import iterators as it


def read_tar_shard(path: str) -> List[Dict[str, bytes]]:
    """Group tar members by key prefix: 'a/b/0001.png' -> key 'a/b/0001',
    field 'png' (webdataset grouping convention)."""
    samples: Dict[str, Dict[str, bytes]] = {}
    order: List[str] = []
    with tarfile.open(path) as tf:
        for m in tf:
            if not m.isfile() or "." not in m.name:
                continue
            key, ext = m.name.rsplit(".", 1)
            data = tf.extractfile(m).read()
            if key not in samples:
                samples[key] = {"__key__": key.encode()}
                order.append(key)
            samples[key][ext.lower()] = data
    return [samples[k] for k in order]


def decode_image(data: bytes, image_size: Optional[int] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    if image_size:
        img = img.resize((image_size, image_size))
    return np.asarray(img, np.float32) / 255.0


def decode_cls(data: bytes) -> int:
    return int(data.decode().strip())


def webdataset_stream(
    shard_paths: Sequence[str],
    *,
    decode: Optional[Callable[[Dict[str, bytes]], Dict]] = None,
    image_size: int = 224,
    image_ext: str = "png;jpg;jpeg",
    label_ext: str = "cls",
    seed: int = 0,
    shuffle_buffer: int = 256,
    infinite: bool = True,
) -> it.CheckpointableIterator:
    """Streaming samples from tar shards; default decode yields
    {'image': [H,W,3] float32, 'label': int} (the rvlcdip_wds layout)."""
    exts = image_ext.split(";")

    def default_decode(raw: Dict[str, bytes]) -> Dict:
        img = None
        for e in exts:
            if e in raw:
                img = decode_image(raw[e], image_size)
                break
        out = {"__key__": raw["__key__"].decode()}
        if img is not None:
            out["image"] = img
        if label_ext in raw:
            out["label"] = decode_cls(raw[label_ext])
        return out

    if infinite:
        src = it.InfinitePermutationSourceIterator(list(shard_paths), seed=seed)
    else:
        src = it.ChunkedSourceIterator(list(shard_paths))
    samples = it.SelectManyIterator(src, read_tar_shard)
    if shuffle_buffer > 1:
        samples = it.BufferedShuffleIterator(samples, shuffle_buffer, seed=seed + 1)
    return it.MapIterator(samples, decode or default_decode)


class _FilterIterator(it.CheckpointableIterator):
    """Drop samples missing required fields (tar groups routinely carry
    metadata-only keys); state passes through to the source."""

    def __init__(self, source, required):
        self._source = source
        self._required = tuple(required)

    def getstate(self):
        return {"source": self._source.getstate()}

    def setstate(self, state):
        self._source.setstate(state["source"] if state else None)

    def __next__(self):
        while True:
            s = next(self._source)
            if all(r in s for r in self._required):
                return s


def classification_batches(
    stream: it.CheckpointableIterator, batch_size: int
) -> it.CheckpointableIterator:
    """-> checkpointable {'images' [B,H,W,3], 'labels' [B]} batches."""
    stream = _FilterIterator(stream, ("image", "label"))
    batches = it.FixedBatchIterator(stream, batch_size)  # drops a short tail

    def collate(samples):
        return {
            "images": np.stack([s["image"] for s in samples]),
            "labels": np.asarray([s["label"] for s in samples], np.int32),
        }

    return it.MapIterator(batches, collate)


def write_tar_shard(path: str, samples: Sequence[Dict[str, bytes]]) -> None:
    """Write samples (dicts of field -> bytes, plus '__key__') into a tar
    shard — fixture helper mirroring wds.TarWriter."""
    with tarfile.open(path, "w") as tf:
        for s in samples:
            key = s["__key__"].decode() if isinstance(s["__key__"], bytes) else s["__key__"]
            for ext, data in s.items():
                if ext == "__key__":
                    continue
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
