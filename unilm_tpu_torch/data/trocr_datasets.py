"""TrOCR dataset loaders: SROIE line crops, IAM/STR gt files, synthetic
lines (a copy of unilm_tpu/data/trocr_datasets.py: `OCRExample` :26,
`load_sroie` :44, `load_gt_file` :76, `synthetic_ocr_dataset` :98,
`spm_tokenizer` :114, `CharTokenizer` :126, `ocr_batches` :146).

Examples are resized to a fixed square and batches pad their labels to a
fixed length. PIL is imported only inside the functions that read or draw
images, not with the module. `spm_tokenizer` reads a sentencepiece model
through the native reader, data/spm.py.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Iterator, List, Sequence

import numpy as np


@dataclasses.dataclass
class OCRExample:
    image: np.ndarray  # [H, W, 3] float32 [0, 1]
    text: str
    image_id: int = 0


def _open_rgb(path):
    from PIL import Image

    return Image.open(path).convert("RGB")


def _resize_np(img, img_size: int) -> np.ndarray:
    return np.asarray(img.resize((img_size, img_size)), np.float32) / 255.0


def load_sroie(root_dir: str, img_size: int = 384) -> List[OCRExample]:
    """SROIE Task-2 layout: '<stem>.jpg' (or .png) + '<stem>.txt' lines
    'x1,y1,x2,y2,x3,y3,x4,y4,text'; each line is cropped to its
    quadrangle's bounding box."""
    out, k = [], 0
    for jpg in sorted(glob.glob(os.path.join(root_dir, "*.jpg"))) + sorted(
            glob.glob(os.path.join(root_dir, "*.png"))):
        txt = os.path.splitext(jpg)[0] + ".txt"
        if not os.path.exists(txt):
            continue
        im = _open_rgb(jpg)
        with open(txt, encoding="utf8") as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                parts = line.split(",", maxsplit=8)
                if len(parts) < 9:
                    continue
                quad = list(map(int, parts[:8]))
                xs, ys = quad[0::2], quad[1::2]
                box = (min(xs), min(ys), max(xs), max(ys))
                if box[2] <= box[0] or box[3] <= box[1]:
                    continue
                out.append(OCRExample(_resize_np(im.crop(box), img_size),
                                      parts[8], k))
                k += 1
    return out


def load_gt_file(gt_path: str, image_subdir: str = "image",
                 img_size: int = 384) -> List[OCRExample]:
    """'<image>\\t<text>' per line (the STR/IAM/Receipt53K recipes);
    images relative to the gt file's directory, joined with image_subdir
    when set."""
    root = os.path.dirname(os.path.abspath(gt_path))
    out = []
    with open(gt_path, encoding="utf8") as f:
        for k, line in enumerate(f):
            line = line.rstrip("\n")
            if not line:
                continue
            name, text = line.split("\t", 1)
            path = (os.path.join(root, image_subdir, name) if image_subdir
                    else os.path.join(root, name))
            out.append(OCRExample(_resize_np(_open_rgb(path), img_size),
                                  text, k))
    return out


def synthetic_ocr_dataset(n: int, img_size: int = 64, seed: int = 0,
                          charset: str = "0123456789") -> List[OCRExample]:
    """PIL-rendered text lines (a stand-in for IAM/SROIE in tests)."""
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        text = "".join(rng.choice(list(charset), size=rng.randint(3, 8)))
        img = Image.new("RGB", (img_size * 2, img_size // 2), (255, 255, 255))
        ImageDraw.Draw(img).text((4, 4), text, fill=(0, 0, 0))
        out.append(OCRExample(_resize_np(img, img_size), text, i))
    return out


def spm_tokenizer(model_path: str):
    """The reference TrOCR text path: a sentencepiece model (`unilm3-cased`)
    through the native reader, data/spm.py. Returns an `SpmTokenizer`, whose
    interface is CharTokenizer's, so `ocr_batches` and the eval CLI run
    their loop on it (cli/trocr_eval.py --spm <model>)."""
    from unilm_tpu_torch.data.spm import SpmTokenizer

    return SpmTokenizer.from_file(model_path)


class CharTokenizer:
    """Minimal char-level target vocabulary (tests, synthetic runs):
    bos 0, eos 1, pad 2, then the lowercase charset."""

    def __init__(self, charset: str = "0123456789abcdefghijklmnopqrstuvwxyz "):
        self.bos, self.eos, self.pad = 0, 1, 2
        self.chars = list(charset)
        self.c2i = {c: i + 3 for i, c in enumerate(self.chars)}
        self.vocab_size = len(self.chars) + 3

    def encode(self, text: str) -> List[int]:
        return [self.c2i[c] for c in text.lower() if c in self.c2i]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.chars[i - 3] for i in ids
                       if 3 <= int(i) < self.vocab_size)


def ocr_batches(examples: List[OCRExample], tokenizer, batch_size: int,
                max_len: int = 32, shuffle: bool = False,
                seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """-> {'images' [B, H, W, 3], 'labels' [B, L] (bos .. eos, pad),
    'texts'}; a short last batch is dropped."""
    idx = np.arange(len(examples))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        chunk = [examples[j] for j in idx[i:i + batch_size]]
        labels = np.full((batch_size, max_len), tokenizer.pad, np.int32)
        for bi, e in enumerate(chunk):
            ids = ([tokenizer.bos] + tokenizer.encode(e.text)[:max_len - 2]
                   + [tokenizer.eos])
            labels[bi, :len(ids)] = ids
        yield {"images": np.stack([e.image for e in chunk]),
               "labels": labels, "texts": [e.text for e in chunk]}
