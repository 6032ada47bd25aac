"""Kosmos-2 grounding utilities (port of unilm_tpu/data/grounding.py):
bbox <-> location-token conversion on the quantized 32x32 patch-index
grid, the `<object>` markup of a box, and parsing generated markup back
into phrase/bbox pairs (Kosmos-2's demo/decode_string.py)."""

from __future__ import annotations

import re
from typing import List, Tuple


def box_to_patch_indices(
    box: Tuple[float, float, float, float], quantized_size: int = 32
) -> Tuple[int, int]:
    """Normalized (x0,y0,x1,y1) in [0,1] -> (top-left, bottom-right) cell ids
    on the quantized grid (row-major)."""
    x0, y0, x1, y1 = box
    q = quantized_size
    ul_x = min(int(x0 * q), q - 1)
    ul_y = min(int(y0 * q), q - 1)
    lr_x = min(max(int(x1 * q - 1e-6), ul_x), q - 1)
    lr_y = min(max(int(y1 * q - 1e-6), ul_y), q - 1)
    return ul_y * q + ul_x, lr_y * q + lr_x


def patch_indices_to_box(
    ul_idx: int, lr_idx: int, quantized_size: int = 32
) -> Tuple[float, float, float, float]:
    """Inverse: cell ids -> normalized (x0,y0,x1,y1) using cell corners."""
    q = quantized_size
    ul_y, ul_x = divmod(ul_idx, q)
    lr_y, lr_x = divmod(lr_idx, q)
    return (ul_x / q, ul_y / q, (lr_x + 1) / q, (lr_y + 1) / q)


def box_tokens(box, quantized_size: int = 32) -> str:
    ul, lr = box_to_patch_indices(box, quantized_size)
    return f"<object><patch_index_{ul:04d}><patch_index_{lr:04d}></object>"


_PAIR = re.compile(r"<patch_index_(\d{4,})><patch_index_(\d{4,})>")


def parse_grounded_text(
    text: str, quantized_size: int = 32
) -> Tuple[str, List[Tuple[str, List[Tuple[float, float, float, float]]]]]:
    """demo/decode_string.py equivalent: returns (clean_text, entities) where
    entities = [(phrase, [bbox, ...])]; bboxes normalized to [0,1]."""
    entities = []
    for m in re.finditer(
        r"<phrase>(.*?)</phrase><object>(.*?)</object>", text, re.DOTALL
    ):
        phrase = m.group(1)
        boxes = []
        for pm in _PAIR.finditer(m.group(2)):
            ul, lr = int(pm.group(1)), int(pm.group(2))
            boxes.append(patch_indices_to_box(ul, lr, quantized_size))
        if boxes:
            entities.append((phrase, boxes))
    clean = re.sub(r"</?(phrase|object)>", "", text)
    clean = re.sub(r"<patch_index_\d{4,}>", "", clean)
    clean = clean.replace("</delimiter_of_multi_objects/>", " ")
    clean = re.sub(r"\s+", " ", clean).strip()
    return clean, entities
