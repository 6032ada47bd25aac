"""Blockwise masking for masked-image-modeling pretraining (the port's own
copy of unilm_tpu/data/masking.py, which is numpy only; the port imports
nothing of the JAX package).

Same algorithm as beit/masking_generator.py:29-92: blocks sampled by area
and aspect until `num_masking_patches` are masked, with an explicit
np.random.Generator so the masks are seedable. The same generator state
gives the JAX package's masks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np


class MaskingGenerator:
    def __init__(
        self,
        input_size: Union[int, Tuple[int, int]],
        num_masking_patches: int,
        min_num_patches: int = 4,
        max_num_patches: Optional[int] = None,
        min_aspect: float = 0.3,
        max_aspect: Optional[float] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (
            num_masking_patches if max_num_patches is None else max_num_patches
        )
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.rng = rng or np.random.default_rng()

    def _mask(self, mask: np.ndarray, max_mask_patches: int) -> int:
        delta = 0
        for _ in range(10):
            # np.Generator.uniform requires low <= high (python's
            # random.uniform swaps silently; the reference relies on that)
            lo = min(self.min_num_patches, max_mask_patches)
            hi = max(self.min_num_patches, max_mask_patches)
            target_area = self.rng.uniform(lo, hi)
            aspect = math.exp(self.rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = int(self.rng.integers(0, self.height - h + 1))
                left = int(self.rng.integers(0, self.width - w + 1))
                region = mask[top: top + h, left: left + w]
                num_masked = int(region.sum())
                if 0 < h * w - num_masked <= max_mask_patches:
                    delta = int((region == 0).sum())
                    region[:] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self) -> np.ndarray:
        """One [height, width] int64 mask, 1 = masked."""
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        count = 0
        while count < self.num_masking_patches:
            max_mask = min(self.num_masking_patches - count,
                           self.max_num_patches)
            delta = self._mask(mask, max_mask)
            if delta == 0:
                break
            count += delta
        return mask
