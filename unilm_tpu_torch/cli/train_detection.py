"""Detection fine-tuning + COCO-mAP eval, DiT / LayoutLMv3 detection (port
of unilm_tpu/cli/train_detection.py).

    python -m unilm_tpu_torch.cli.train_detection --synthetic --steps 200 --eval
    python -m unilm_tpu_torch.cli.train_detection --train-json coco.json \\
        --image-root imgs/ --num-classes 5 --preset dit
    # the two-stage Cascade R-CNN head, a published detectron2 checkpoint
    # through convert/detection.py:
    python -m unilm_tpu_torch.cli.train_detection --head rcnn \\
        --checkpoint dit_cascade.pth --val-json publaynet_val.json \\
        --image-root imgs/ --num-classes 5 --eval --steps 0

The JAX CLI's flags and defaults (`--head fcos|rcnn`, `--preset
dit|layoutlmv3`, `--checkpoint`, `--synthetic`, `--eval`,
`--eval-protocol`, `--tiny`, ...), plus `--device`: the model lives on the
card ("cuda", the default, which raises on a host without one) unless
`--device cpu` asks for the CPU. One train step (runtime/train.py
`make_train_step`: AdamW lr --lr with optax's defaults, clip 1.0) over
batches of one shape (data/detection.py); the eval decodes on the device
(FCOS `decode_detections`, or the rcnn graph's own post-processing) and
scores on the host (scoring_detection.py).

Randomness: random weights from --seed; the rcnn loss's sampling noise
from a generator seeded with the step's index, as JAX's key is
PRNGKey(step); the shuffle of each epoch from --seed + epoch, as JAX's.

`build_trainer(args)` is the setup without the loop: the model, the step,
the state and the datasets; `evaluate(model, val_data, args, head)` the
eval loop; `main()` returns (state, eval metrics or None).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from unilm_tpu_torch.data.detection import (batches, load_coco_json,
                                            synthetic_detection_dataset)
from unilm_tpu_torch.models.beit import BeitConfig
from unilm_tpu_torch.models.detection_head import (FCOSDetector,
                                                   decode_detections,
                                                   dit_base_detection,
                                                   fcos_loss,
                                                   layoutlmv3_base_detection)
from unilm_tpu_torch.models.rcnn import (CascadeRCNN, RCNNConfig,
                                         cascade_dit_base, rcnn_loss)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.optim import AdamW
from unilm_tpu_torch.runtime.train import TrainState, make_train_step
from unilm_tpu_torch.scoring_detection import (evaluate_detections,
                                               evaluate_icdar_table_detection,
                                               evaluate_text_detection)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DiT / LayoutLMv3 detection (PyTorch/CUDA)")
    p.add_argument("--preset", choices=["dit", "layoutlmv3"], default="dit")
    p.add_argument("--head", choices=["fcos", "rcnn"], default="fcos",
                   help="fcos = single-stage; rcnn = Cascade/Mask R-CNN "
                        "(models/rcnn.py)")
    p.add_argument("--checkpoint",
                   help="detectron2 .pth to convert (rcnn head only)")
    p.add_argument("--train-json")
    p.add_argument("--val-json")
    p.add_argument("--image-root", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-boxes", type=int, default=64)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval-protocol", default="coco",
                   choices=["coco", "icdar_table", "funsd_text"],
                   help="extra protocol metrics next to COCO mAP: ICDAR-19 "
                        "cTDaR wF1 (table detection) or FUNSD "
                        "text-detection DetEval P/R/hmean")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def build_config(args):
    """The FCOS config of --preset (--tiny: 2 layers of width 64, one tower
    conv of 32 channels)."""
    preset = (dit_base_detection if args.preset == "dit"
              else layoutlmv3_base_detection)
    kw = {}
    if args.tiny:  # test / smoke configuration
        kw = dict(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128)
    cfg = preset(img_size=args.img_size, num_classes=args.num_classes, **kw)
    if args.tiny:
        cfg = dataclasses.replace(cfg, tower_convs=1, tower_channels=32)
    return cfg


def build_rcnn_config(args) -> RCNNConfig:
    """cascade_dit_base at --img-size (--tiny: 4 layers of width 32)."""
    if args.tiny:
        beit = BeitConfig(
            img_size=args.img_size, patch_size=16, embed_dim=32, num_layers=4,
            num_heads=2, ffn_dim=64, use_abs_pos_emb=True,
            use_rel_pos_bias=False, use_mean_pooling=False, num_classes=0)
        return RCNNConfig(
            beit=beit, out_indices=(0, 1, 2, 3), fpn_channels=16,
            num_classes=args.num_classes, rpn_pre_nms_topk=64,
            rpn_post_nms_topk=32, fc_dim=32, detections_per_image=16)
    return cascade_dit_base(img_size=args.img_size,
                            num_classes=args.num_classes)


def build_model(args, dev):
    """(cfg, model) for --head, with random weights from --seed or, for
    rcnn, a --checkpoint's (a detectron2 state dict)."""
    if args.head == "rcnn":
        cfg = build_rcnn_config(args)
        model = CascadeRCNN(cfg, device=dev)
    else:
        cfg = build_config(args)
        model = FCOSDetector(cfg, device=dev)
    if args.head == "rcnn" and args.checkpoint:
        from unilm_tpu_torch.convert.detection import convert_rcnn

        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
        model.load_state_dict(convert_rcnn(sd, cfg), strict=True)
        print(f"loaded detectron2 checkpoint {args.checkpoint}")
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    return cfg, model


def datasets(args):
    """(train, val) lists of DetectionExample: --synthetic fixtures, or the
    COCO json files."""
    if args.synthetic:
        train = synthetic_detection_dataset(
            args.synthetic_n, img_size=args.img_size,
            num_classes=args.num_classes, seed=args.seed)
        val = synthetic_detection_dataset(
            max(8, args.synthetic_n // 4), img_size=args.img_size,
            num_classes=args.num_classes, seed=args.seed + 1)
        return train, val
    train = load_coco_json(args.train_json, args.image_root,
                           img_size=args.img_size)
    val = (load_coco_json(args.val_json, args.image_root,
                          img_size=args.img_size)
           if args.val_json else train)
    return train, val


def to_device(batch: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def make_loss_fn(args, cfg, dev):
    """loss_fn(model, batch) -> (loss, metrics) for make_train_step; the
    batch's "step" (an int) seeds the rcnn loss's sampling noise."""
    if args.head == "rcnn":
        def loss_fn(model, batch):
            gen = torch.Generator(device=dev).manual_seed(batch["step"])
            return rcnn_loss(model, batch["images"], batch["boxes"],
                             batch["labels"], batch["valid"], gen)
    else:
        def loss_fn(model, batch):
            out = model(batch["images"])
            return fcos_loss(out, batch["boxes"], batch["labels"],
                             batch["valid"], cfg)
    return loss_fn


@dataclasses.dataclass
class Trainer:
    cfg: object
    model: torch.nn.Module
    step: object  # step(state, batch) -> (state, metrics)
    state: TrainState
    train_data: list
    val_data: list
    device: torch.device


def build_trainer(args) -> Trainer:
    """The model, the train step (AdamW --lr, optax.adamw's defaults: b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter; clip
    1.0), the state and the datasets of the parsed `args`."""
    dev = resolve_device(args.device)
    cfg, model = build_model(args, dev)
    tx = AdamW(args.lr)
    step = make_train_step(make_loss_fn(args, cfg, dev), tx,
                           clip_grad_norm=1.0)
    train, val = datasets(args)
    return Trainer(cfg, model, step, TrainState.create(model, tx), train,
                   val, dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    tr = build_trainer(args)
    state = tr.state
    it, epoch = None, 0
    for i in range(args.steps):
        if it is None:
            it = batches(tr.train_data, args.batch_size,
                         max_boxes=args.max_boxes, shuffle=True,
                         seed=args.seed + epoch)
            epoch += 1
        try:
            batch = next(it)
        except StopIteration:
            it = None
            continue
        state, metrics = tr.step(state, {**to_device(batch, tr.device),
                                         "step": i})
        if i % 20 == 0 or i == args.steps - 1:
            extra = " ".join(
                f"{k} {float(v):.4f}" for k, v in sorted(metrics.items())
                if k not in ("loss", "grad_norm"))
            print(f"step {i}: loss {float(metrics['loss']):.4f} {extra}")
    result = None
    if args.eval:
        result = evaluate(tr.model, tr.val_data, args, head=args.head)
        print(json.dumps({k: round(v, 4) for k, v in result.items()}))
    return state, result


@torch.no_grad()
def infer(model, images: torch.Tensor, head: str, img_size: int):
    """(boxes, scores, labels, valid) of a batch of images on the model's
    device."""
    if head == "rcnn":
        out = model(images)
        return out["boxes"], out["scores"], out["classes"], out["valid"]
    return decode_detections(model(images), img_size=float(img_size))


def evaluate(model, val_data, args, head: str = "fcos") -> Dict[str, float]:
    """COCO mAP (and --eval-protocol's metrics) of `model` over val_data."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    preds, gts = [], []
    for batch in batches(val_data, args.batch_size,
                         max_boxes=args.max_boxes, drop_last=False):
        images = torch.from_numpy(batch["images"]).to(dev)
        boxes, scores, labels, valid = (
            x.cpu().numpy() for x in infer(model, images, head,
                                           args.img_size))
        for i in range(len(boxes)):
            m = valid[i]
            preds.append({"boxes": boxes[i][m], "scores": scores[i][m],
                          "labels": labels[i][m]})
            gm = batch["valid"][i]
            gts.append({"boxes": batch["boxes"][i][gm],
                        "labels": batch["labels"][i][gm]})
    model.train(was_training)
    metrics = evaluate_detections(preds, gts, args.num_classes)
    protocol = getattr(args, "eval_protocol", "coco")
    if protocol == "icdar_table":
        # ICDAR-19 cTDaR wF1: score-descending box lists
        metrics.update(evaluate_icdar_table_detection(
            [p["boxes"][np.argsort(-p["scores"], kind="stable")]
             for p in preds],
            [g["boxes"] for g in gts]))
    elif protocol == "funsd_text":
        metrics.update(evaluate_text_detection(preds, gts))
    return metrics


if __name__ == "__main__":
    main()
