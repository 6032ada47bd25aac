"""Image preprocessing on the host, numpy and PIL (the port's own copy of
unilm_tpu/data/transforms.py: `resize` :36, `center_crop` :42, `to_numpy`
:50, `normalize` :56, `eval_transform` :60, `pix2struct_patches` :200).

The same arithmetic as the JAX package's copy, so the two give the same
arrays for the same image. PIL is imported inside the functions that need
it: a host that only runs the models (the GPU machine) may lack it. The
train-time transforms (random resized crop, flip, mixup/cutmix) come with
the BEiT fine-tuning slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)

# PIL resampling codes, by name
_INTERP = {"bilinear": 2, "bicubic": 3, "lanczos": 1, "nearest": 0}


def resize(img, size: Tuple[int, int], interpolation: str = "bicubic"):
    """PIL.Image -> PIL.Image resized to (h, w)."""
    return img.resize((size[1], size[0]), _INTERP[interpolation])


def center_crop(img, size: Tuple[int, int]):
    w, h = img.size
    th, tw = size
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return img.crop((left, top, left + tw, top + th))


def to_numpy(img) -> np.ndarray:
    """PIL -> float32 [H, W, 3] in [0, 1]."""
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def normalize(arr: np.ndarray, mean=IMAGENET_DEFAULT_MEAN,
              std=IMAGENET_DEFAULT_STD) -> np.ndarray:
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def eval_transform(img, input_size: int = 224,
                   crop_pct: Optional[float] = None,
                   interpolation: str = "bicubic",
                   mean=IMAGENET_DEFAULT_MEAN,
                   std=IMAGENET_DEFAULT_STD) -> np.ndarray:
    """BEiT's eval transform: resize the shorter side to
    input_size / crop_pct, center crop, normalize. Returns [H, W, 3]
    float32 NHWC."""
    if crop_pct is None:
        crop_pct = 224 / 256 if input_size <= 224 else 1.0
    scale_size = int(math.floor(input_size / crop_pct))
    w, h = img.size
    if w < h:
        ow = scale_size
        oh = int(scale_size * h / w)
    else:
        oh = scale_size
        ow = int(scale_size * w / h)
    img = resize(img, (oh, ow), interpolation)
    img = center_crop(img, (input_size, input_size))
    return normalize(to_numpy(img), mean, std)


def pix2struct_patches(image: np.ndarray, max_patches: int = 4096,
                       patch_size: int = 16) -> np.ndarray:
    """HF Pix2StructImageProcessor.extract_flattened_patches equivalent
    for a [H, W, 3] float image in [0, 1]: standardize, scale so that
    rows * cols <= max_patches with the aspect kept, cut 16x16 patches,
    prepend (row+1, col+1), zero-pad to max_patches. Returns
    [max_patches, 2 + 3 * patch_size**2] float32."""
    from PIL import Image

    h, w = image.shape[:2]
    x = image.astype(np.float32)
    x = (x - x.mean()) / max(float(x.std()), 1e-6)

    scale = math.sqrt(max_patches * (patch_size / h) * (patch_size / w))
    nrows = max(min(int(math.floor(scale * h / patch_size)), max_patches), 1)
    ncols = max(min(int(math.floor(scale * w / patch_size)), max_patches), 1)
    while nrows * ncols > max_patches:
        if nrows >= ncols:
            nrows -= 1
        else:
            ncols -= 1
    rh, rw = nrows * patch_size, ncols * patch_size

    # bilinear resize via PIL on the standardized array
    lo, hi = x.min(), x.max()
    denom = max(hi - lo, 1e-6)
    img8 = Image.fromarray(np.uint8(255 * (x - lo) / denom))
    img8 = img8.resize((rw, rh), 2)
    xr = np.asarray(img8, np.float32) / 255.0 * denom + lo

    patches = xr.reshape(nrows, patch_size, ncols, patch_size, 3)
    patches = patches.transpose(0, 2, 1, 3, 4).reshape(nrows * ncols, -1)
    rows = np.repeat(np.arange(nrows), ncols) + 1
    cols = np.tile(np.arange(ncols), nrows) + 1
    out = np.zeros((max_patches, 2 + patches.shape[1]), np.float32)
    out[: nrows * ncols, 0] = rows
    out[: nrows * ncols, 1] = cols
    out[: nrows * ncols, 2:] = patches
    return out
