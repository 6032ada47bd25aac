"""BEiT / DiT image classification, the `--eval` path (port of
unilm_tpu/cli/run_class_finetuning.py:63-125).

    python -m unilm_tpu_torch.cli.run_class_finetuning --eval \\
        --model beit_base_patch16_224 --data_path /data/imagenet/val \\
        --checkpoint beit_base.pt --batch_size 128

Data: an ImageNet-style folder (one subdirectory per class) or an
RVL-CDIP folder for DiT. `--checkpoint` takes a timm/unilm or HF torch
state dict (convert/beit.py); without one the weights are random, from
`--seed`. The model runs on the card (`--device cuda`, the default, which
raises on a host without one) unless `--device cpu` asks for the CPU.

The CLI is a folder reader (`folder_batches`: PIL, `eval_transform`) and
an evaluation loop over (images, labels) batches (`evaluate_batches`),
which a caller can drive with batches of its own. Without `--eval` it
exits pointing at the training entry, `cli/train_classification.py`, as
the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterable, Tuple

import numpy as np
import torch

from unilm_tpu_torch.convert.beit import convert_beit
from unilm_tpu_torch.data.transforms import eval_transform
from unilm_tpu_torch.models import beit as beit_models
from unilm_tpu_torch.models.beit import BeitForImageClassification
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.logging import JsonlLogger
from unilm_tpu_torch.scoring import accuracy_topk

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("BEiT/DiT classification (PyTorch/CUDA)")
    p.add_argument("--model", default="beit_base_patch16_224")
    p.add_argument("--data_path", required=True)
    p.add_argument("--checkpoint", default="",
                   help="torch .pt (timm or HF format)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--nb_classes", type=int, default=0)
    p.add_argument("--crop_pct", type=float, default=None)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--max_samples", type=int, default=0)
    p.add_argument("--log_file", default="")
    p.add_argument("--seed", type=int, default=0,
                   help="random weights when there is no --checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def list_image_folder(root: str):
    """(path, class_id) pairs from the class-subdirectory layout, classes
    in sorted order."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    items = []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fn in sorted(os.listdir(cdir)):
            if os.path.splitext(fn)[1].lower() in IMG_EXTS:
                items.append((os.path.join(cdir, fn), ci))
    return items, classes


def build_model(args, device: torch.device) -> BeitForImageClassification:
    """The registry's config (bf16 unless --no-bf16, --nb_classes), with
    weights from --checkpoint or random from --seed, in eval mode."""
    cfg_fn = getattr(beit_models, args.model)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    kw = {"num_classes": args.nb_classes} if args.nb_classes else {}
    cfg = cfg_fn(dtype=dtype, **kw)
    model = BeitForImageClassification(cfg, device=device)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        for key in ("model", "module", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
        model.load_state_dict(convert_beit(sd, cfg), strict=True)
    else:
        model.init_weights(torch.Generator(device=device).manual_seed(
            args.seed))
    return model.eval()


def folder_batches(items, img_size: int, batch_size: int,
                   crop_pct=None) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """(images [b, H, W, 3] float32 normalized NHWC, labels [b]) batches
    read from (path, class_id) items with PIL."""
    from PIL import Image

    for i in range(0, len(items), batch_size):
        chunk = items[i:i + batch_size]
        imgs = np.stack([eval_transform(Image.open(p), img_size,
                                        crop_pct=crop_pct)
                         for p, _ in chunk])
        yield imgs, np.asarray([c for _, c in chunk])


@torch.no_grad()
def evaluate_batches(model: BeitForImageClassification, batches
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Run `model` over (images, labels) batches (numpy or tensors; images
    NHWC, cast to the model's dtype on its device). Returns (logits
    [N, classes] float32, labels [N]) as numpy; logits and labels stay
    where they are until the end, so no batch waits on the device."""
    dev = next(model.parameters()).device
    dtype = model.cfg.dtype
    logits, labels = [], []
    for imgs, lab in batches:
        x = torch.as_tensor(imgs).to(dev, dtype)
        logits.append(model(x).float())
        labels.append(torch.as_tensor(lab))
    if not logits:
        return np.zeros((0, model.cfg.num_classes), np.float32), np.zeros(
            (0,), np.int64)
    return (torch.cat(logits).cpu().numpy(),
            torch.cat([lab.cpu() for lab in labels]).numpy())


def evaluate(args):
    dev = resolve_device(args.device)
    model = build_model(args, dev)
    items, classes = list_image_folder(args.data_path)
    if args.max_samples:
        items = items[:args.max_samples]
    print(f"eval on {len(items)} images, {len(classes)} classes")
    logger = JsonlLogger(args.log_file) if args.log_file else None
    t0 = time.time()
    logits, labels = evaluate_batches(
        model, folder_batches(items, model.cfg.img_size, args.batch_size,
                              args.crop_pct))
    dt = time.time() - t0
    acc = accuracy_topk(logits, labels)
    stats = {**acc, "images_per_sec": len(items) / dt}
    print(f"* Acc@1 {acc['acc1']:.3f} Acc@5 {acc['acc5']:.3f} "
          f"({len(items) / dt:.1f} img/s)")
    if logger:
        logger.log(stats, 0, tag="eval")
    return stats


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.eval:
        raise SystemExit(
            "training entry: use unilm_tpu_torch.cli.train_classification")
    return evaluate(args)


if __name__ == "__main__":
    main()
