"""Image preprocessing (the port's own copy of unilm_tpu/data/transforms.py:
`resize` :36, `center_crop` :42, `to_numpy` :50, `normalize` :56,
`eval_transform` :60, `RandomResizedCropWithTwoPic` :85, `random_hflip`
:140, `mixup_cutmix` :147, `pix2struct_patches` :200).

The host transforms are numpy and PIL with the same arithmetic as the
JAX package's, so the two give the same arrays for the same image (and
the crop the same boxes under one seeded `random.Random`). PIL is imported
inside the functions that need it: a host that only runs the models (the
GPU machine) may lack it.

`mixup_cutmix` is a pure JAX function of a PRNG key there. Here it is
split in two: `draw_mixup_cutmix` takes the random choices (the branch,
both beta draws, the box centre) from a `torch.Generator`, and
`apply_mixup_cutmix` is the deterministic rest on the device, which given
JAX's draws gives JAX's output. The reference draws the box centre's row
and column from one key, so cy == cx whenever H == W; the draw keeps that
(one uniform for both).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Tuple

import numpy as np
import torch

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


class RandomResizedCropWithTwoPic:
    """beit/transforms.py:67: one random crop (area in `scale`, log-uniform
    aspect in `ratio`, 10 tries, then a centre crop) rendered at `size`
    and, with `second_size`, again at that size. Returns float32 [H, W, 3]
    in [0, 1] (or the pair): no flip and no normalize, as the reference's
    fine-tuning CLI feeds it (ROADMAP Queue 3). `rng` defaults to an
    unseeded random.Random, as there."""

    def __init__(self, size: int, second_size: Optional[int] = None,
                 scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation: str = "bicubic",
                 second_interpolation: str = "lanczos",
                 rng: Optional[random.Random] = None):
        self.size = size
        self.second_size = second_size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation
        self.second_interpolation = second_interpolation
        self.rng = rng or random.Random()

    def get_params(self, img):
        """(top, left, height, width) of the crop box."""
        w, h = img.size
        area = h * w
        for _ in range(10):
            target_area = self.rng.uniform(*self.scale) * area
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(self.rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = self.rng.randint(0, w - cw)
                top = self.rng.randint(0, h - ch)
                return top, left, ch, cw
        # fallback: centre crop
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def __call__(self, img):
        top, left, ch, cw = self.get_params(img)
        crop = img.crop((left, top, left + cw, top + ch))
        first = resize(crop, (self.size, self.size), self.interpolation)
        if self.second_size is None:
            return to_numpy(first)
        second = resize(crop, (self.second_size, self.second_size),
                        self.second_interpolation)
        return to_numpy(first), to_numpy(second)


def random_hflip(img, rng: random.Random, arr2=None, p: float = 0.5):
    """PIL image flipped left-right with probability p."""
    if rng.random() < p:
        from PIL import Image

        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


@dataclasses.dataclass(frozen=True)
class MixDraw:
    """The random choices of one `mixup_cutmix` call: the branch, the two
    beta draws (float32 values) and the cutmix box centre."""

    use_cutmix: bool
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int


def _gamma(shape: float, g: torch.Generator) -> float:
    """One Gamma(shape, 1) draw from `g` (Marsaglia and Tsang; for
    shape < 1, Gamma(shape + 1) * U^(1 / shape))."""
    boost = 1.0
    if shape < 1.0:
        boost = float(torch.rand((), generator=g)) ** (1.0 / shape)
        shape += 1.0
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=g))
        v = (1.0 + c * x) ** 3
        if v <= 0:
            continue
        u = float(torch.rand((), generator=g))
        if math.log(max(u, 1e-300)) < (0.5 * x * x + d - d * v
                                       + d * math.log(v)):
            return d * v * boost


def _beta(alpha: float, g: torch.Generator) -> float:
    a, b = _gamma(alpha, g), _gamma(alpha, g)
    return float(np.float32(a / (a + b)))


def draw_mixup_cutmix(generator: torch.Generator, height: int, width: int,
                      mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                      switch_prob: float = 0.5) -> MixDraw:
    """The random part of `mixup_cutmix` from a CPU `torch.Generator`:
    cutmix with probability switch_prob, lam_mix ~ Beta(mixup_alpha,
    mixup_alpha), lam_cut ~ Beta(cutmix_alpha, cutmix_alpha), and the box
    centre from ONE uniform u (cy = floor(u H), cx = floor(u W)), which
    keeps the reference's cy == cx for square images."""
    use_cutmix = float(torch.rand((), generator=generator)) < switch_prob
    lam_mix = _beta(mixup_alpha, generator)
    lam_cut = _beta(cutmix_alpha, generator)
    u = float(torch.rand((), generator=generator))
    return MixDraw(use_cutmix, lam_mix, lam_cut, min(int(u * height),
                                                     height - 1),
                   min(int(u * width), width - 1))


def apply_mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, draw: MixDraw,
                       label_smoothing: float = 0.1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part of the reference's `mixup_cutmix` on images
    [B, H, W, C] (float32) and labels [B]: sample i pairs with B-1-i; mixup
    blends by lam_mix, cutmix pastes the pair's box (half-size
    floor(H sqrt(1 - lam_cut)) / 2 around (cy, cx), clipped to the image)
    and takes lam = 1 - box area / (H W); soft targets are the smoothed
    one-hots (off = s / n, on = 1 - s + off) blended by lam. Scalars are
    float32, as in JAX. Returns (mixed images, soft targets [B, n])."""
    B, H, W, _ = images.shape
    flipped = images.flip(0)
    one = np.float32(1.0)
    if draw.use_cutmix:
        cut_rat = np.sqrt(one - np.float32(draw.lam_cut))
        ch, cw = int(np.float32(H) * cut_rat), int(np.float32(W) * cut_rat)
        y0, y1 = (min(max(draw.cy + s * (ch // 2), 0), H) for s in (-1, 1))
        x0, x1 = (min(max(draw.cx + s * (cw // 2), 0), W) for s in (-1, 1))
        mixed = images.clone()
        mixed[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
        lam = one - np.float32((y1 - y0) * (x1 - x0)) / np.float32(H * W)
    else:
        lam = np.float32(draw.lam_mix)
        mixed = images * float(lam) + flipped * float(one - lam)
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    y1h = torch.nn.functional.one_hot(labels.long(), num_classes).float() * (
        on - off) + off
    soft = y1h * float(lam) + y1h.flip(0) * float(one - lam)
    return mixed, soft


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
