"""Port parity for the OCR augmentations (data/ocr_aug.py): every op and
OCRAugment's seeded draws give JAX's image pixel for pixel (the same PIL
and numpy calls from generators seeded alike). Exact."""

import numpy as np
import pytest

from unilm_tpu.data import ocr_aug as jaug
from unilm_tpu_torch.data import ocr_aug as taug

Image = pytest.importorskip("PIL.Image")


def _line(seed=0, size=(96, 32)):
    """A text-line-like RGB image: dark strokes on white."""
    rng = np.random.RandomState(seed)
    arr = np.full((size[1], size[0], 3), 255, np.uint8)
    for _ in range(12):
        x, y = rng.randint(0, size[0] - 8), rng.randint(4, size[1] - 8)
        arr[y:y + rng.randint(2, 8), x:x + rng.randint(1, 6)] = rng.randint(
            0, 80)
    return Image.fromarray(arr)


@pytest.mark.parametrize("op", [f.__name__ for f in jaug.ALL_OPS])
def test_each_op_matches_jax(op):
    img = _line(1)
    got = getattr(taug, op)(img, np.random.RandomState(5))
    want = getattr(jaug, op)(img, np.random.RandomState(5))
    assert got.size == want.size == img.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed,n_ops", [(0, 2), (1, 2), (7, 3), (42, 6)])
def test_ocr_augment_matches_jax(seed, n_ops):
    """A stream of images through one OCRAugment each: the ops it samples
    and their parameters follow the seed, image after image."""
    ta, ja = taug.OCRAugment(n_ops, seed=seed), jaug.OCRAugment(n_ops,
                                                                 seed=seed)
    assert [f.__name__ for f in taug.ALL_OPS] == [f.__name__
                                                  for f in jaug.ALL_OPS]
    for i in range(4):
        img = _line(10 + i)
        np.testing.assert_array_equal(np.asarray(ta(img)),
                                      np.asarray(ja(img)))
