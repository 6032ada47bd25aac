"""LayoutLMv3 FUNSD token classification eval (port of
unilm_tpu/cli/run_funsd.py).

    python -m unilm_tpu_torch.cli.run_funsd --data_path FUNSD/testing_data \\
        --tokenizer ./roberta-tokenizer --checkpoint layoutlmv3-funsd.pt

The FUNSD layout (<root>/annotations/*.json + <root>/images/*.png) is read
by data/document_datasets.py; words are tokenized with a local HF fast
tokenizer and labels and boxes aligned to the first subword
(`tokenize_and_align`, run_funsd_cord.py:312), with per-token segment ids
for the segment-aware 1D bias; the model runs in float32
(`LayoutLMv3Config(num_labels=7)`, as the JAX CLI) and the seqeval-style
entity P/R/F1 is reported (:421). `--checkpoint` takes an HF or layoutlmft
torch state dict (convert/layoutlmv3.py); without one the weights are
random, from `--seed`. The model runs on the card (`--device cuda`, the
default, which raises on a host without one) unless `--device cpu` asks
for the CPU.

`evaluate_batches(model, batches)` is the evaluation loop over batches of
arrays (no tokenizer, no PIL): a caller with its own encoded batches can
drive it; `main()` imports transformers and PIL where it reads the data.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from unilm_tpu_torch.convert.layoutlmv3 import convert_layoutlmv3
from unilm_tpu_torch.data.document_datasets import FUNSD_LABELS as LABELS
from unilm_tpu_torch.data.document_datasets import load_funsd
from unilm_tpu_torch.data.transforms import (IMAGENET_INCEPTION_MEAN,
                                             IMAGENET_INCEPTION_STD, normalize,
                                             resize, to_numpy)
from unilm_tpu_torch.models.layoutlmv3 import (
    LayoutLMv3Config, LayoutLMv3ForTokenClassification)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.scoring import entity_f1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("LayoutLMv3 FUNSD eval (PyTorch/CUDA)")
    p.add_argument("--data_path", required=True)
    p.add_argument("--tokenizer", required=True, help="local HF tokenizer dir")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--max_len", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--no_image", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="random weights when there is no --checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def tokenize_and_align(tok, example, max_len: int):
    """run_funsd_cord.py:312 subword alignment: label only the first
    subword. Also emits per-token segment ids for the segment-aware 1D
    bias (pre_calc_rel_mat, data_collator.py:15-25); specials/pads get -1.
    Returns (input_ids, attention_mask, bboxes, labels, segments)."""
    enc = tok(example["words"], is_split_into_words=True, truncation=True,
              max_length=max_len, padding="max_length")
    word_segs = example.get("segments")
    bboxes, labels, segs = [], [], []
    prev = None
    for wid in enc.word_ids():
        if wid is None:
            bboxes.append([0, 0, 0, 0])
            labels.append(-100)
            segs.append(-1)
        else:
            bboxes.append(example["bboxes"][wid])
            labels.append(LABELS.index(example["labels"][wid])
                          if wid != prev else -100)
            segs.append(word_segs[wid] if word_segs is not None else 0)
        prev = wid
    return (np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"]),
            np.asarray(bboxes), np.asarray(labels), np.asarray(segs))


def build_model(args, device: torch.device) -> LayoutLMv3ForTokenClassification:
    """The JAX CLI's configuration (float32, 7 labels) with weights from
    --checkpoint or random from --seed, in eval mode."""
    cfg = LayoutLMv3Config(num_labels=len(LABELS))
    model = LayoutLMv3ForTokenClassification(cfg, device=device)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        # a text-only checkpoint has no visual tower: --no_image runs it
        model.load_state_dict(convert_layoutlmv3(sd, cfg),
                              strict=not args.no_image)
    else:
        print("WARNING: random weights (no --checkpoint)")
        model.init_weights(torch.Generator(device=device).manual_seed(
            args.seed))
    return model.eval()


def funsd_batches(tok, examples, max_len: int, batch_size: int,
                  with_image: bool) -> Iterable[Dict[str, np.ndarray]]:
    """Encoded batches of FUNSD examples: input_ids, attention_mask, bbox,
    labels, segments [b, max_len(, 4)] and, with_image, images [b, 224,
    224, 3] float32 NHWC (bilinear resize, normalized to [-1, 1])."""
    from PIL import Image

    for i in range(0, len(examples), batch_size):
        chunk = examples[i:i + batch_size]
        enc = [tokenize_and_align(tok, e, max_len) for e in chunk]
        batch = {name: np.stack([e[j] for e in enc]) for j, name in enumerate(
            ("input_ids", "attention_mask", "bbox", "labels", "segments"))}
        if with_image:
            batch["images"] = np.stack([normalize(
                to_numpy(resize(Image.open(e["image"]), (224, 224),
                                "bilinear")),
                IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD)
                for e in chunk])
        yield batch


@torch.no_grad()
def evaluate_batches(model: LayoutLMv3ForTokenClassification,
                     batches) -> Tuple[np.ndarray, np.ndarray]:
    """Run `model` over batches (dicts of numpy arrays or tensors as
    `funsd_batches` yields them; `images` optional). The same-segment mask
    `valid_span` is built from `segments` on the device. Returns (logits
    [N, L, labels] float32, labels [N, L]) as numpy; both stay on their
    devices until the end, so no batch waits on the device."""
    dev = next(model.parameters()).device
    logits, labels = [], []
    for b in batches:
        seg = torch.as_tensor(b["segments"]).to(dev)
        images = b.get("images")
        if images is not None:
            images = torch.as_tensor(images).to(dev, torch.float32)
        out = model(torch.as_tensor(b["input_ids"]).to(dev, torch.long),
                    torch.as_tensor(b["bbox"]).to(dev, torch.long),
                    torch.as_tensor(b["attention_mask"]).to(dev), images,
                    seg[:, :, None] == seg[:, None, :])
        logits.append(out.float())
        labels.append(torch.as_tensor(b["labels"]))
    if not logits:
        return (np.zeros((0, 0, model.cfg.num_labels), np.float32),
                np.zeros((0, 0), np.int64))
    return (torch.cat(logits).cpu().numpy(),
            torch.cat([lab.cpu() for lab in labels]).numpy())


def score(logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Entity P/R/F1 of the argmax predictions over the labelled tokens
    (first subwords)."""
    preds = logits.argmax(-1)
    true: List[List[str]] = []
    pred: List[List[str]] = []
    for row_l, row_p in zip(labels, preds):
        keep = row_l != -100
        true.append([LABELS[x] for x in row_l[keep]])
        pred.append([LABELS[x] for x in row_p[keep]])
    return entity_f1(true, pred)


def main(argv=None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.tokenizer, use_fast=True,
                                        add_prefix_space=True)
    dev = resolve_device(args.device)
    model = build_model(args, dev)
    examples = load_funsd(args.data_path)
    print(f"{len(examples)} documents")
    t0 = time.time()
    logits, labels = evaluate_batches(model, funsd_batches(
        tok, examples, args.max_len, args.batch_size, not args.no_image))
    dt = time.time() - t0
    m = score(logits, labels)
    print(f"precision {m['precision']:.4f} recall {m['recall']:.4f} "
          f"f1 {m['f1']:.4f} ({len(examples) / max(dt, 1e-9):.1f} docs/s)")
    return m


if __name__ == "__main__":
    main()
