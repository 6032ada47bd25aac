"""OCR image augmentations (a copy of unilm_tpu/data/ocr_aug.py: the ops
:22-65 and `OCRAugment` :68).

TrOCR's RandAugment-style geometric and degradation pipeline
(trocr/data_aug.py): rotation, shear, perspective, blur, noise and a
downscale round trip, host-side PIL and numpy ops composed from seeded
generators and applied before the encoder transform. On the same image and
seed the output equals the JAX package's pixel for pixel. Pillow is
imported inside the ops (`_pil`), not with the module.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


def _pil():
    from PIL import Image, ImageFilter

    return Image, ImageFilter


def rotate(img, rng, max_deg=4.0):
    Image, _ = _pil()
    return img.rotate(rng.uniform(-max_deg, max_deg), resample=2, fillcolor=(255, 255, 255))


def shear(img, rng, max_shear=0.3):
    Image, _ = _pil()
    s = rng.uniform(-max_shear, max_shear)
    return img.transform(img.size, Image.AFFINE, (1, s, 0, 0, 1, 0), resample=2,
                         fillcolor=(255, 255, 255))


def perspective(img, rng, scale=0.05):
    Image, _ = _pil()
    w, h = img.size
    dx = lambda: rng.uniform(-scale, scale) * w
    dy = lambda: rng.uniform(-scale, scale) * h
    # simple projective jitter via QUAD transform
    quad = (dx(), dy(), dx(), h + dy(), w + dx(), h + dy(), w + dx(), dy())
    return img.transform(img.size, Image.QUAD, quad, resample=2,
                         fillcolor=(255, 255, 255))


def gaussian_blur(img, rng, max_radius=1.5):
    _, ImageFilter = _pil()
    return img.filter(ImageFilter.GaussianBlur(rng.uniform(0, max_radius)))


def gaussian_noise(img, rng, max_sigma=10.0):
    Image, _ = _pil()
    arr = np.asarray(img).astype(np.float32)
    arr = arr + rng.normal(0, rng.uniform(0, max_sigma), arr.shape)
    return Image.fromarray(np.uint8(arr.clip(0, 255)))


def downscale_up(img, rng, min_factor=0.5):
    Image, _ = _pil()
    w, h = img.size
    f = rng.uniform(min_factor, 1.0)
    small = img.resize((max(int(w * f), 1), max(int(h * f), 1)), 2)
    return small.resize((w, h), 2)


ALL_OPS = [rotate, shear, perspective, gaussian_blur, gaussian_noise, downscale_up]


class OCRAugment:
    """Apply n randomly chosen ops (RandAugment style, trocr task.py
    --preprocess RA2)."""

    def __init__(self, n_ops: int = 2, seed: Optional[int] = None,
                 ops: Optional[List] = None):
        self.n = n_ops
        self.ops = ops or ALL_OPS
        self.rng = np.random.RandomState(seed)
        self.pyrng = random.Random(seed)

    def __call__(self, img):
        for op in self.pyrng.sample(self.ops, min(self.n, len(self.ops))):
            img = op(img, self.rng)
        return img
