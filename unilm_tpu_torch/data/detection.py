"""Detection data: COCO-json loading, synthetic fixtures and batching (a
numpy copy of unilm_tpu/data/detection.py: `DetectionExample` :22,
`load_coco_json` :29, `synthetic_detection_dataset` :74, `pad_batch`
:114 and `batches` :133).

The reference's detectron2 dataset plumbing for DiT detection
(dit/object_detection/ditod/mytrainer.py's loaders over
register_coco_instances of PubLayNet / ICDAR), with every batch of one
shape: images resized to a fixed square, the ground truth padded to
max_boxes with a validity mask. Arrays stay numpy; the CLI moves a batch
to its device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DetectionExample:
    image: np.ndarray          # [H, W, 3] float32 in [0, 1]
    boxes: np.ndarray          # [M, 4] xyxy pixels (resized coords)
    labels: np.ndarray         # [M] int
    image_id: int = 0


def load_coco_json(
    json_path: str,
    image_root: str,
    *,
    img_size: int = 224,
) -> List[DetectionExample]:
    """Minimal COCO-format reader (images/annotations/categories). Boxes are
    COCO xywh -> xyxy, rescaled to the square img_size. Images load via PIL
    if available, else zeros (annotation-only pipelines/tests)."""
    with open(json_path) as f:
        coco = json.load(f)
    cats = sorted(c["id"] for c in coco.get("categories", []))
    cat_to_idx = {cid: i for i, cid in enumerate(cats)}
    anns_by_img: Dict[int, list] = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)

    out = []
    for im in coco["images"]:
        w, h = im["width"], im["height"]
        sx, sy = img_size / w, img_size / h
        boxes, labels = [], []
        for a in anns_by_img.get(im["id"], []):
            x, y, bw, bh = a["bbox"]
            boxes.append([x * sx, y * sy, (x + bw) * sx, (y + bh) * sy])
            labels.append(cat_to_idx[a["category_id"]])
        path = os.path.join(image_root, im["file_name"]) if image_root else None
        if path and os.path.exists(path):
            from PIL import Image

            img = Image.open(path).convert("RGB").resize((img_size, img_size))
            image = np.asarray(img, np.float32) / 255.0
        else:
            image = np.zeros((img_size, img_size, 3), np.float32)
        out.append(
            DetectionExample(
                image=image,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
                image_id=im["id"],
            )
        )
    return out


def synthetic_detection_dataset(
    n: int,
    *,
    img_size: int = 224,
    num_classes: int = 3,
    max_objects: int = 4,
    seed: int = 0,
) -> List[DetectionExample]:
    """Colored-rectangle fixtures: each object is an axis-aligned rectangle
    whose fill intensity encodes its class — learnable by a tiny detector
    and exactly scorable (cf. the reference's unit-test pattern of scripted
    fixtures, edgelm/tests/utils.py:60)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        img = np.full((img_size, img_size, 3), 0.1, np.float32)
        m = rng.randint(1, max_objects + 1)
        boxes, labels = [], []
        for _ in range(m):
            bw = rng.randint(img_size // 8, img_size // 2)
            bh = rng.randint(img_size // 8, img_size // 2)
            x0 = rng.randint(0, img_size - bw)
            y0 = rng.randint(0, img_size - bh)
            c = rng.randint(num_classes)
            color = np.zeros(3, np.float32)
            color[c % 3] = 0.4 + 0.6 * ((c // 3) + 1) / ((num_classes // 3) + 1)
            img[y0 : y0 + bh, x0 : x0 + bw] = color
            boxes.append([x0, y0, x0 + bw, y0 + bh])
            labels.append(c)
        out.append(
            DetectionExample(
                image=img,
                boxes=np.asarray(boxes, np.float32),
                labels=np.asarray(labels, np.int32),
                image_id=i,
            )
        )
    return out


def pad_batch(
    examples: List[DetectionExample], max_boxes: int = 64
) -> Dict[str, np.ndarray]:
    """Static-shape batch: images [B,H,W,3], boxes [B,M,4], labels [B,M],
    valid [B,M]."""
    B = len(examples)
    H, W, _ = examples[0].image.shape
    images = np.stack([e.image for e in examples])
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    labels = np.zeros((B, max_boxes), np.int32)
    valid = np.zeros((B, max_boxes), bool)
    for i, e in enumerate(examples):
        m = min(len(e.boxes), max_boxes)
        boxes[i, :m] = e.boxes[:m]
        labels[i, :m] = e.labels[:m]
        valid[i, :m] = True
    return {"images": images, "boxes": boxes, "labels": labels, "valid": valid}


def batches(
    examples: List[DetectionExample],
    batch_size: int,
    *,
    max_boxes: int = 64,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    idx = np.arange(len(examples))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for i in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
        chunk = [examples[j] for j in idx[i : i + batch_size]]
        if len(chunk) < batch_size and drop_last:
            break
        yield pad_batch(chunk, max_boxes)
