"""Streaming vision-language pretraining data, the Kosmos-2 input pipe
(port of unilm_tpu/data/vl_loaders.py).

Grounded image-caption shards (Kosmos-2's laion2b_obj_loader): each
object's boxes become `<phrase>..</phrase><object><patch_index_xxxx>..
</object>` markup after its phrase, tokenized into an LM row with an
`<image>` placeholder span; interleaved text-image documents likewise.
Every sample is a fixed [T] row with a boolean splice mask, and the
whole pipeline is a checkpointable iterator (data/iterators.py), so the
stream position is part of a training checkpoint. On the same shards and
seed the batches and states equal the JAX package's.

Tokenizer: text ids [0, text_vocab) from tiktoken's cl100k_base or raw
UTF-8 bytes, then the specials and the quantized-grid location tokens
above them. The port never downloads: "auto" takes cl100k_base only when
its file is already in tiktoken's cache (`cl100k_if_cached`), else the
bytes; "tiktoken" raises when it is not cached. "spm" (or "auto" with an
`spm_path`) reads a sentencepiece model through data/spm.py, Kosmos-2's
own text path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unilm_tpu_torch.data import iterators as it
from unilm_tpu_torch.data.grounding import box_tokens

SPECIAL_TOKENS = [
    "<s>", "</s>", "<pad>", "<image>", "</image>", "<ocr>", "<md>",
    "<grounding>", "<phrase>", "</phrase>", "<object>", "</object>",
    "</delimiter_of_multi_objects/>",
]

# tiktoken's source of cl100k_base, used here only as its cache key
_CL100K_BLOB = ("https://openaipublic.blob.core.windows.net/encodings/"
                "cl100k_base.tiktoken")


def cl100k_if_cached():
    """tiktoken's cl100k_base when its file is already in tiktoken's cache
    (TIKTOKEN_CACHE_DIR, DATA_GYM_CACHE_DIR or the temp dir's
    data-gym-cache), else None: tiktoken would fetch a missing file."""
    try:
        import tiktoken
    except ImportError:
        return None
    cache = os.environ.get("TIKTOKEN_CACHE_DIR",
                           os.environ.get("DATA_GYM_CACHE_DIR"))
    if cache is None:
        cache = os.path.join(tempfile.gettempdir(), "data-gym-cache")
    key = hashlib.sha1(_CL100K_BLOB.encode()).hexdigest()
    if not cache or not os.path.exists(os.path.join(cache, key)):
        return None
    return tiktoken.get_encoding("cl100k_base")


class VLTokenizer:
    """Text tokenizer + grounding vocabulary: text ids, then
    SPECIAL_TOKENS, then <patch_index_0000>.. for the quantized grid.

    backend: "auto" (an spm model where `spm_path` is given, else
    cl100k_base if cached, else bytes), "tiktoken" (cl100k_base; raises
    when it is not cached), "bytes", or "spm" (the sentencepiece model at
    `spm_path`, data/spm.py: the Kosmos-2 SpmLmLoader's text ids)."""

    def __init__(self, quantized_size: int = 32, backend: str = "auto",
                 spm_path: Optional[str] = None):
        if backend not in ("auto", "tiktoken", "bytes", "spm"):
            raise ValueError(f"unknown tokenizer backend {backend!r}")
        self.quantized_size = quantized_size
        self._enc = self._spm = None
        if backend == "spm" or (backend == "auto" and spm_path):
            from unilm_tpu_torch.data.spm import SentencePieceModel

            if not spm_path:
                raise ValueError("backend 'spm' needs spm_path")
            self._spm = SentencePieceModel.from_file(spm_path)
        elif backend != "bytes":
            self._enc = cl100k_if_cached()
        if backend == "tiktoken" and self._enc is None:
            raise RuntimeError(
                "tiktoken's cl100k_base is not in its cache (this package "
                "never downloads it); use backend 'bytes' or 'auto'")
        self.text_vocab = (self._spm.vocab_size if self._spm
                           else self._enc.n_vocab if self._enc else 256)
        self.special_to_id = {
            s: self.text_vocab + i for i, s in enumerate(SPECIAL_TOKENS)}
        self.loc_base = self.text_vocab + len(SPECIAL_TOKENS)
        self.vocab_size = self.loc_base + quantized_size * quantized_size
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}

    def token(self, name: str) -> int:
        return self.special_to_id[name]

    def loc_token(self, cell: int) -> int:
        return self.loc_base + cell

    def encode_text(self, text: str) -> List[int]:
        if self._spm:
            return self._spm.encode(text)
        if self._enc:
            return self._enc.encode(text, disallowed_special=())
        return list(text.encode("utf-8"))

    def decode_text(self, ids: Sequence[int]) -> str:
        ids = [i for i in ids if i < self.text_vocab]
        if self._spm:
            return self._spm.decode(ids)
        if self._enc:
            return self._enc.decode(ids)
        return bytes(ids).decode("utf-8", errors="replace")

    _MARKUP = re.compile("|".join(re.escape(s) for s in SPECIAL_TOKENS)
                         + r"|<patch_index_(\d{4,})>")

    def encode_grounded(self, text: str) -> List[int]:
        """Text with special/location markup: specials become their ids,
        the spans between them go through the text tokenizer."""
        out: List[int] = []
        pos = 0
        for m in self._MARKUP.finditer(text):
            if m.start() > pos:
                out.extend(self.encode_text(text[pos:m.start()]))
            if m.group(1) is not None:
                out.append(self.loc_token(int(m.group(1))))
            else:
                out.append(self.special_to_id[m.group(0)])
            pos = m.end()
        if pos < len(text):
            out.extend(self.encode_text(text[pos:]))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        """Inverse of encode_grounded (the markup restored)."""
        parts: List[str] = []
        buf: List[int] = []

        def flush():
            if buf:
                parts.append(self.decode_text(buf))
                buf.clear()

        for i in ids:
            if i < self.text_vocab:
                buf.append(int(i))
            elif i >= self.loc_base:
                flush()
                parts.append(f"<patch_index_{i - self.loc_base:04d}>")
            else:
                flush()
                parts.append(self.id_to_special.get(int(i), ""))
        flush()
        return "".join(parts)


def insert_grounding_markup(caption: str, objects: Sequence[Dict],
                            quantized_size: int = 32) -> str:
    """objects: [{"span": [start, end), "boxes": [[x0,y0,x1,y1] norm..]}].
    Wraps each span as <phrase>..</phrase><object>loc tokens</object>,
    several boxes joined by </delimiter_of_multi_objects/>; a span that
    overlaps an earlier one is skipped."""
    spans = sorted(objects, key=lambda o: o["span"][0])
    out, pos = ["<grounding>"], 0
    for o in spans:
        s, e = o["span"]
        if s < pos:
            continue
        out.append(caption[pos:s])
        toks = "</delimiter_of_multi_objects/>".join(
            box_tokens(tuple(b), quantized_size)[len("<object>"):
                                                 -len("</object>")]
            for b in o["boxes"])
        out.append(f"<phrase>{caption[s:e]}</phrase><object>{toks}</object>")
        pos = e
    out.append(caption[pos:])
    return "".join(out)


def load_image(path: Optional[str], image_root: str, image_size: int,
               key: str = "") -> np.ndarray:
    """[H, W, 3] float32 in [0, 1] (PIL, resized to image_size); a
    pseudo-image seeded from the md5 of the path (or `key`) when the file
    is missing."""
    full = os.path.join(image_root, path) if (path and image_root) else path
    if full and os.path.exists(full):
        from PIL import Image

        img = Image.open(full).convert("RGB").resize((image_size, image_size))
        return np.asarray(img, np.float32) / 255.0
    seed = int(hashlib.md5((path or key).encode()).hexdigest()[:8], 16)
    rng = np.random.RandomState(seed)
    return rng.rand(image_size, image_size, 3).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class VLSampleSpec:
    tokens_per_sample: int = 256
    image_tokens: int = 64  # latent queries spliced per image
    image_size: int = 224
    max_images: int = 1  # > 1 for interleaved documents
    quantized_size: int = 32


def assemble_sample(tok: VLTokenizer, spec: VLSampleSpec,
                    segments: Sequence[Tuple[str, object]]
                    ) -> Optional[Dict[str, np.ndarray]]:
    """segments: ("text", ids) | ("image", [H, W, 3] array) in order ->
    {tokens [T], img_mask [T], segs [T], loss_mask [T], images
    [max_images, H, W, 3], n_images}, or None when no image and no text
    token fit. An image that does not fit is skipped, so later text still
    packs."""
    T = spec.tokens_per_sample
    bos, eos = tok.token("<s>"), tok.token("</s>")
    boi, eoi = tok.token("<image>"), tok.token("</image>")
    pad = tok.token("<pad>")
    tokens, img_mask, segs, loss = [bos], [False], [0], [False]
    images: List[np.ndarray] = []
    n_text = 0

    def put(t, m, s, l):
        tokens.append(t)
        img_mask.append(m)
        segs.append(s)
        loss.append(l)

    for kind, payload in segments:
        if kind == "image":
            need = 2 + spec.image_tokens
            if len(images) >= spec.max_images or len(tokens) + need + 1 > T:
                continue
            put(boi, False, 1, False)
            for _ in range(spec.image_tokens):
                put(pad, True, 1, False)
            put(eoi, False, 1, False)
            images.append(payload)
        else:
            for t in payload:
                if len(tokens) + 1 >= T:
                    break
                put(int(t), False, 0, True)
                n_text += 1
    if len(tokens) < T:
        put(eos, False, 0, True)
    if not images or n_text == 0:
        return None
    n = T - len(tokens)
    img_arr = np.zeros((spec.max_images, spec.image_size, spec.image_size, 3),
                       np.float32)
    for i, im in enumerate(images):
        img_arr[i] = im
    return {
        "tokens": np.asarray(tokens + [pad] * n, np.int32),
        "img_mask": np.asarray(img_mask + [False] * n, bool),
        "segs": np.asarray(segs + [0] * n, np.int32),
        "loss_mask": np.asarray(loss + [False] * n, bool),
        "images": img_arr,
        "n_images": np.int32(len(images)),
    }


def _jsonl_reader(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(l) for l in f if l.strip()]


def _record_stream(shard_paths, seed: int, shuffle_buffer: int, build):
    src = it.InfinitePermutationSourceIterator(list(shard_paths), seed=seed)
    lines = it.SelectManyIterator(src, _jsonl_reader)
    lines = it.BufferedShuffleIterator(lines, shuffle_buffer, seed=seed + 1)
    return _SkipNoneIterator(it.MapIterator(lines, build))


def laion_obj_stream(shard_paths: Sequence[str], tok: VLTokenizer,
                     spec: VLSampleSpec, *, image_root: str = "",
                     seed: int = 0, shuffle_buffer: int = 256
                     ) -> it.CheckpointableIterator:
    """Grounded image-caption samples. Shard lines: {"caption": str,
    "image": str|null, "objects": [{"span": [s, e], "boxes":
    [[x0,y0,x1,y1]..]}]}."""

    def build(rec):
        caption = rec.get("caption", "")
        text = insert_grounding_markup(caption, rec.get("objects", []),
                                       spec.quantized_size)
        img = load_image(rec.get("image"), image_root, spec.image_size,
                         key=caption)
        ids = tok.encode_grounded(text)
        return assemble_sample(tok, spec, [("image", img), ("text", ids)])

    return _record_stream(shard_paths, seed, shuffle_buffer, build)


def interleaved_stream(shard_paths: Sequence[str], tok: VLTokenizer,
                       spec: VLSampleSpec, *, image_root: str = "",
                       seed: int = 0, shuffle_buffer: int = 64
                       ) -> it.CheckpointableIterator:
    """Interleaved text-image documents. Shard lines: {"segments":
    [{"text": str} | {"image": str}]}."""

    def build(rec):
        segs = []
        for s in rec.get("segments", []):
            if "image" in s:
                segs.append(("image", load_image(s["image"], image_root,
                                                 spec.image_size)))
            elif "text" in s:
                segs.append(("text", tok.encode_text(s["text"])))
        return assemble_sample(tok, spec, segs)

    return _record_stream(shard_paths, seed, shuffle_buffer, build)


class _SkipNoneIterator(it.CheckpointableIterator):
    """Drops the samples the assembler rejected."""

    def __init__(self, source: it.CheckpointableIterator):
        self._source = source

    def getstate(self):
        return {"source": self._source.getstate()}

    def setstate(self, state):
        self._source.setstate(state["source"] if state else None)

    def __next__(self):
        while True:
            x = next(self._source)
            if x is not None:
                return x


def vl_batch_stream(sample_stream: it.CheckpointableIterator,
                    batch_size: int) -> it.CheckpointableIterator:
    """Fixed-size batches of stacked arrays (a short last batch is
    dropped)."""

    def collate(samples):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    return it.MapIterator(it.FixedBatchIterator(sample_stream, batch_size),
                          collate)
