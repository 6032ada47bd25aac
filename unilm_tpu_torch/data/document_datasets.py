"""Document-AI dataset readers: FUNSD, CORD, XFUND (the port's own copy of
unilm_tpu/data/document_datasets.py, which imports no JAX).

Capability-equivalent of layoutlmv3/layoutlmft/data/{funsd,cord,xfund}.py:
reads the public dataset layouts into a uniform example dict
{words, bboxes (segment-level, 0-1000 normalized), labels, image(path)};
FUNSD examples also carry each word's segment index (`segments`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

FUNSD_LABELS = ["O", "B-HEADER", "I-HEADER", "B-QUESTION", "I-QUESTION",
                "B-ANSWER", "I-ANSWER"]

CORD_LABELS = [
    "O", "B-MENU.NM", "B-MENU.NUM", "B-MENU.UNITPRICE", "B-MENU.CNT",
    "B-MENU.DISCOUNTPRICE", "B-MENU.PRICE", "B-MENU.ITEMSUBTOTAL",
    "B-MENU.VATYN", "B-MENU.ETC", "B-MENU.SUB.NM", "B-MENU.SUB.UNITPRICE",
    "B-MENU.SUB.CNT", "B-MENU.SUB.PRICE", "B-MENU.SUB.ETC",
    "B-VOID_MENU.NM", "B-VOID_MENU.PRICE", "B-SUB_TOTAL.SUBTOTAL_PRICE",
    "B-SUB_TOTAL.DISCOUNT_PRICE", "B-SUB_TOTAL.SERVICE_PRICE",
    "B-SUB_TOTAL.OTHERSVC_PRICE", "B-SUB_TOTAL.TAX_PRICE", "B-SUB_TOTAL.ETC",
    "B-TOTAL.TOTAL_PRICE", "B-TOTAL.TOTAL_ETC", "B-TOTAL.CASHPRICE",
    "B-TOTAL.CHANGEPRICE", "B-TOTAL.CREDITCARDPRICE", "B-TOTAL.EMONEYPRICE",
    "B-TOTAL.MENUTYPE_CNT", "B-TOTAL.MENUQTY_CNT",
]

XFUND_LABELS = ["O", "B-QUESTION", "I-QUESTION", "B-ANSWER", "I-ANSWER",
                "B-HEADER", "I-HEADER"]


def normalize_bbox(box, w, h):
    return [
        max(0, min(1000, int(1000 * box[0] / w))),
        max(0, min(1000, int(1000 * box[1] / h))),
        max(0, min(1000, int(1000 * box[2] / w))),
        max(0, min(1000, int(1000 * box[3] / h))),
    ]


def _image_size(path: str):
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def _segment_box(words):
    xs = [c for x in words for c in (x["box"][0], x["box"][2])]
    ys = [c for x in words for c in (x["box"][1], x["box"][3])]
    return [min(xs), min(ys), max(xs), max(ys)]


def load_funsd(root: str) -> List[Dict]:
    """<root>/annotations/*.json + <root>/images/*.png (funsd.py:44-123)."""
    out = []
    ann_dir = os.path.join(root, "annotations")
    img_dir = os.path.join(root, "images")
    for fn in sorted(os.listdir(ann_dir)):
        with open(os.path.join(ann_dir, fn), encoding="utf-8") as f:
            data = json.load(f)
        img = os.path.join(img_dir, fn.replace(".json", ".png"))
        w, h = _image_size(img)
        words, bboxes, labels, segments = [], [], [], []
        for si, item in enumerate(data["form"]):
            ws = [x for x in item["words"] if x["text"].strip()]
            if not ws:
                continue
            seg = normalize_bbox(_segment_box(ws), w, h)
            label = item["label"].upper()
            for i, x in enumerate(ws):
                words.append(x["text"])
                bboxes.append(seg)
                labels.append("O" if label == "OTHER"
                              else ("B-" if i == 0 else "I-") + label)
                segments.append(si)
        out.append({"words": words, "bboxes": bboxes, "labels": labels,
                    "segments": segments, "image": img})
    return out


def load_cord(root: str) -> List[Dict]:
    """<root>/json/*.json + <root>/image/*.png (cord.py: valid_line groups;
    segment-level quad -> box)."""
    out = []
    ann_dir = os.path.join(root, "json")
    img_dir = os.path.join(root, "image")
    for fn in sorted(os.listdir(ann_dir)):
        with open(os.path.join(ann_dir, fn), encoding="utf-8") as f:
            data = json.load(f)
        img = os.path.join(img_dir, fn.replace(".json", ".png"))
        w = data.get("meta", {}).get("image_size", {}).get("width")
        h = data.get("meta", {}).get("image_size", {}).get("height")
        if not (w and h):
            w, h = _image_size(img)
        words, bboxes, labels = [], [], []
        for line in data["valid_line"]:
            ws = [x for x in line["words"] if x["text"].strip()]
            if not ws:
                continue
            quads = []
            for x in ws:
                q = x["quad"]
                quads.append({"box": [q["x1"], q["y1"], q["x3"], q["y3"]]})
            seg = normalize_bbox(_segment_box(quads), w, h)
            cat = line["category"].upper().replace("MENU.SUB_", "MENU.SUB.")
            tag = f"B-{cat}"
            label = tag if tag in CORD_LABELS else "O"
            for i, x in enumerate(ws):
                words.append(x["text"])
                bboxes.append(seg)
                labels.append(label if i == 0 or label == "O"
                              else label)  # CORD uses B- only per line token
        out.append({"words": words, "bboxes": bboxes, "labels": labels,
                    "image": img})
    return out


def load_xfund(json_path: str, image_dir: str) -> List[Dict]:
    """XFUND <lang>.<split>.json format (xfund.py): documents[].document[]
    entries with text/box/label."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    out = []
    for doc in data["documents"]:
        img = os.path.join(image_dir, doc["img"]["fname"])
        w, h = doc["img"]["width"], doc["img"]["height"]
        words, bboxes, labels = [], [], []
        for item in doc["document"]:
            ws = [x for x in item.get("words", []) if x.get("text", "").strip()]
            if not ws:
                continue
            seg = normalize_bbox(item["box"], w, h)
            label = item["label"].upper()
            for i, x in enumerate(ws):
                words.append(x["text"])
                bboxes.append(seg)
                labels.append("O" if label == "OTHER"
                              else ("B-" if i == 0 else "I-") + label)
        out.append({"words": words, "bboxes": bboxes, "labels": labels,
                    "image": img})
    return out
