"""Semantic segmentation fine-tuning + mIoU eval, BEiT UperNet on ADE20K
(port of unilm_tpu/cli/train_segmentation.py).

    python -m unilm_tpu_torch.cli.train_segmentation --synthetic --eval
    python -m unilm_tpu_torch.cli.train_segmentation \\
        --image-dir ADE/images/validation --ann-dir ADE/annotations/validation \\
        --num-classes 150 --img-size 512 --eval

The JAX CLI's flags and defaults, plus `--device`: the model lives on the
card ("cuda", the default, which raises on a host without one) unless
`--device cpu` asks for the CPU. The train step is runtime/train.py
`make_train_step` over UperNet + the FCN aux head (AdamW --lr with
optax's defaults, clip 1.0); the eval is the confusion-matrix mIoU of
scoring_segmentation.py over the argmax on the device. ADE20K's
annotation pngs go through `reduce_zero_label`; --synthetic runs on
generated blob fixtures. Random weights and the batches' draws come from
--seed, as JAX's.

`build_trainer(args)` is the setup without the loop; `main()` returns
(state, eval metrics or None).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from unilm_tpu_torch.models.beit import BeitConfig
from unilm_tpu_torch.models.segmentation import (BeitForSemanticSegmentation,
                                                 UperNetConfig,
                                                 segmentation_loss)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.optim import AdamW
from unilm_tpu_torch.runtime.train import TrainState, make_train_step
from unilm_tpu_torch.scoring_segmentation import (evaluate_segmentation,
                                                  reduce_zero_label)


def synthetic_seg_dataset(n, img_size=64, num_classes=4, seed=0):
    """Blob fixtures: class = a colored rectangle's intensity."""
    rng = np.random.RandomState(seed)
    images, labels = [], []
    for _ in range(n):
        img = np.full((img_size, img_size, 3), 0.1, np.float32)
        lab = np.zeros((img_size, img_size), np.int64)
        for c in range(1, num_classes):
            w = rng.randint(img_size // 4, img_size // 2)
            h = rng.randint(img_size // 4, img_size // 2)
            x0 = rng.randint(0, img_size - w)
            y0 = rng.randint(0, img_size - h)
            img[y0:y0 + h, x0:x0 + w] = c / num_classes
            lab[y0:y0 + h, x0:x0 + w] = c
        images.append(img)
        labels.append(lab)
    return images, labels


def load_ade20k(image_dir, ann_dir, img_size):
    from PIL import Image

    images, labels = [], []
    for name in sorted(os.listdir(image_dir)):
        base = os.path.splitext(name)[0]
        ann = os.path.join(ann_dir, base + ".png")
        if not os.path.exists(ann):
            continue
        img = Image.open(os.path.join(image_dir, name)).convert("RGB")
        lab = Image.open(ann)
        images.append(
            np.asarray(img.resize((img_size, img_size)), np.float32) / 255.0)
        raw = np.asarray(lab.resize((img_size, img_size), resample=0))
        labels.append(reduce_zero_label(raw))
    return images, labels


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("BEiT UperNet segmentation (PyTorch/CUDA)")
    p.add_argument("--image-dir")
    p.add_argument("--ann-dir")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def build_config(args) -> UperNetConfig:
    """BEiT-B UperNet at --img-size (--tiny: 4 layers of width 64)."""
    kw = dict(img_size=args.img_size, use_mean_pooling=False)
    if args.tiny:
        kw.update(embed_dim=64, num_layers=4, num_heads=4, ffn_dim=128)
    beit = BeitConfig(**kw)
    return UperNetConfig(
        beit=beit, num_classes=args.num_classes,
        out_indices=tuple(min(i, beit.num_layers - 1) for i in (
            (0, 1, 2, 3) if args.tiny else (3, 5, 7, 11))),
        channels=64 if args.tiny else 512,
        aux_channels=32 if args.tiny else 256)


@dataclasses.dataclass
class Trainer:
    cfg: UperNetConfig
    model: torch.nn.Module
    step: object  # step(state, batch) -> (state, metrics)
    state: TrainState
    train: tuple  # (images, labels) lists
    val: tuple
    device: torch.device


def build_trainer(args) -> Trainer:
    """The model (random weights from --seed), the train step (AdamW --lr,
    clip 1.0), the state and the datasets of the parsed `args`."""
    dev = resolve_device(args.device)
    cfg = build_config(args)
    model = BeitForSemanticSegmentation(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(args.seed))
    if args.synthetic:
        train = synthetic_seg_dataset(args.synthetic_n, args.img_size,
                                      args.num_classes, args.seed)
        val = synthetic_seg_dataset(max(8, args.synthetic_n // 4),
                                    args.img_size, args.num_classes,
                                    args.seed + 1)
    else:
        train = load_ade20k(args.image_dir, args.ann_dir, args.img_size)
        val = train

    def loss_fn(m, batch):
        logits, aux = m(batch["images"], return_aux=True)
        return segmentation_loss(logits, batch["labels"], aux,
                                 aux_weight=cfg.aux_loss_weight)

    tx = AdamW(args.lr)
    step = make_train_step(loss_fn, tx, clip_grad_norm=1.0)
    return Trainer(cfg, model, step, TrainState.create(model, tx), train,
                   val, dev)


@torch.no_grad()
def predict(model, images: list, batch_size: int, dev) -> list:
    """The argmax class maps [H, W] of `images`, in batches of batch_size
    (the last one padded with its first image, as JAX's)."""
    was_training = model.training
    model.eval()
    preds = []
    for j in range(0, len(images), batch_size):
        chunk = images[j:j + batch_size]
        pad = batch_size - len(chunk)
        x = torch.from_numpy(np.stack(chunk + chunk[:1] * pad)).to(dev)
        pr = model(x).argmax(-1).cpu().numpy()
        preds.extend(pr[:len(chunk)])
    model.train(was_training)
    return preds


def main(argv=None):
    args = build_parser().parse_args(argv)
    tr = build_trainer(args)
    tr_imgs, tr_labs = tr.train
    state, B = tr.state, args.batch_size
    rng = np.random.RandomState(args.seed)
    for i in range(args.steps):
        idx = rng.randint(0, len(tr_imgs), B)
        batch = {
            "images": torch.from_numpy(
                np.stack([tr_imgs[j] for j in idx])).to(tr.device),
            "labels": torch.from_numpy(
                np.stack([tr_labs[j] for j in idx])).to(tr.device)}
        state, m = tr.step(state, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(m['loss']):.4f}")
    if args.eval:
        va_imgs, va_labs = tr.val
        preds = predict(tr.model, va_imgs, B, tr.device)
        res = evaluate_segmentation(preds, va_labs, args.num_classes)
        print(json.dumps({k: round(v, 4) for k, v in res.items()}))
        return state, res
    return state, None


if __name__ == "__main__":
    main()
