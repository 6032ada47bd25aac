"""BEiT / DiT fine-tuning loop (port of unilm_tpu/cli/train_classification.py,
the engine_for_finetuning equivalent).

    python -m unilm_tpu_torch.cli.train_classification \\
        --model beit_base_patch16_224 --data_path /data/imagenet/train \\
        --batch_size 256 --clip_grad 3.0

An ImageNet-style folder (one subdirectory per class) -> the fixed-batch
permutation stream -> a random resized crop per image -> mixup/cutmix with
label smoothing -> soft-target cross entropy -> the train step (clipping,
AdamW with layer-wise LR decay over a warmup + cosine schedule, EMA of the
parameters) -> checkpoints carrying the stream's position. The flags and
defaults are the JAX CLI's, plus `--device` (the model lives on the card,
"cuda", the default, which raises on a host without one, unless
`--device cpu` asks for the CPU, where attention takes its plain path) and
`--no-bf16` (float32 compute).

Randomness: every step's crop boxes, mixup/cutmix draws and drop-path
flags come from generators seeded from (--seed, step), so a resumed run
takes the same steps as one that never stopped, and no generator state is
saved. The JAX CLI restarts its key chain from --seed on resume and crops
with an unseeded random.Random (ROADMAP Queue 3). As there, the crop is
neither flipped nor normalized, and random weights are seeded 0 whatever
--seed.

A non-finite loss stops the loop with FloatingPointError naming the
non-finite parameters. The JAX CLI has no such stop; it is kept on
purpose: a step past a NaN only spends card time and overwrites the last
good checkpoint.

`main()` is setup (`build_trainer`) plus the loop, so a caller can drive
the same model and step with batches of its own (`Trainer.make_batch`).
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unilm_tpu_torch.cli.run_class_finetuning import list_image_folder
from unilm_tpu_torch.convert.beit import convert_beit
from unilm_tpu_torch.data import iterators as it
from unilm_tpu_torch.data.transforms import (RandomResizedCropWithTwoPic,
                                             apply_mixup_cutmix,
                                             draw_mixup_cutmix)
from unilm_tpu_torch.models import beit as beit_models
from unilm_tpu_torch.models.beit import BeitForImageClassification
from unilm_tpu_torch.runtime.checkpoint import CheckpointManager
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime import metrics as M
from unilm_tpu_torch.runtime.logging import JsonlLogger, find_nonfinite
from unilm_tpu_torch.runtime.optim import cosine_schedule, create_optimizer
from unilm_tpu_torch.runtime.train import TrainState, make_train_step

# which generator a step's seed feeds
CROP, MIX, DROP_PATH = range(3)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("BEiT/DiT fine-tuning (PyTorch/CUDA)")
    p.add_argument("--model", default="beit_base_patch16_224")
    p.add_argument("--data_path", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--output_dir", default="./out")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=4e-3)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.9)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--nb_classes", type=int, default=0)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def step_seed(seed: int, step: int, stream: int) -> int:
    """The seed of generator `stream` (CROP, MIX or DROP_PATH) at `step`."""
    seq = np.random.SeedSequence([seed, step, stream])
    return int(seq.generate_state(1)[0])


def soft_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor
                       ) -> torch.Tensor:
    """Mean over the batch of -sum(targets * log_softmax(logits)), float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(soft_targets * logp).sum(-1).mean()


@dataclasses.dataclass
class Trainer:
    """What `main` loops over: the model inside `state`, the optimizer, the
    step function, the data stream and the schedule."""

    args: Any
    cfg: beit_models.BeitConfig
    model: BeitForImageClassification
    state: TrainState
    tx: Any
    loss_fn: Callable  # loss_fn(model, batch) -> (loss, {})
    step_fn: Callable
    stream: Any
    items: Sequence[Tuple[str, int]]
    sched: Callable[[int], float]
    device: torch.device
    num_classes: int
    total_steps: int

    def make_batch(self, images, labels, step: int) -> dict:
        """The step's batch from images [B, H, W, 3] float32 and labels
        [B] (numpy or tensors): both on the device, the mixup/cutmix draw
        and the drop-path seed for `step`."""
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        y = torch.as_tensor(labels).long().to(self.device)
        gen = torch.Generator().manual_seed(step_seed(self.args.seed, step,
                                                      MIX))
        mix = draw_mixup_cutmix(gen, x.shape[1], x.shape[2],
                                self.args.mixup, self.args.cutmix)
        return {"x": x, "y": y, "mix": mix,
                "seed": step_seed(self.args.seed, step, DROP_PATH)}

    def next_batch(self, step: int) -> dict:
        """The next batch of the folder stream: each image read with PIL
        and cropped with the step's seeded crop."""
        from PIL import Image

        idxs = next(self.stream)
        crop = RandomResizedCropWithTwoPic(
            self.cfg.img_size,
            rng=random.Random(step_seed(self.args.seed, step, CROP)))
        imgs = np.stack([crop(Image.open(self.items[i][0]).convert("RGB"))
                         for i in idxs])
        labels = np.asarray([self.items[i][1] for i in idxs])
        return self.make_batch(imgs, labels, step)


def build_model(args, cfg, device) -> BeitForImageClassification:
    """Weights from --checkpoint (timm/unilm or HF, convert/beit.py) or
    random from seed 0 whatever --seed, as the JAX CLI initialises with
    PRNGKey(0) (cli/run_class_finetuning.py `load_params`); --seed drives
    the data stream and the per-step draws."""
    model = BeitForImageClassification(cfg, device=device)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        for key in ("model", "module", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
        model.load_state_dict(convert_beit(sd, cfg), strict=True)
    else:
        model.init_weights(torch.Generator(device=device).manual_seed(0))
    return model


def build_trainer(args, items: Optional[List[Tuple[str, int]]] = None,
                  use_flash: bool = True) -> Trainer:
    """Model, optimizer, train step and stream for the parsed CLI `args`.
    `items` ((path, class) pairs) defaults to the --data_path folder's;
    `use_flash=False` keeps the model's attention on its plain path on the
    card too."""
    dev = resolve_device(args.device)
    if items is None:
        items, classes = list_image_folder(args.data_path)
        num_classes = args.nb_classes or len(classes)
    else:
        num_classes = args.nb_classes or 1 + max(c for _, c in items)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = dataclasses.replace(getattr(beit_models, args.model)(dtype=dtype),
                              num_classes=num_classes,
                              drop_path_rate=args.drop_path,
                              use_flash=use_flash)
    model = build_model(args, cfg, dev).train()

    steps_per_epoch = max(len(items) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.epochs
    sched = cosine_schedule(args.lr, total_steps,
                            warmup_steps=steps_per_epoch * args.warmup_epochs)
    tx = create_optimizer(list(model.named_parameters()), sched,
                          weight_decay=args.weight_decay,
                          layer_decay=args.layer_decay,
                          num_layers=cfg.num_layers)
    state = TrainState.create(model, tx, ema=args.ema_decay > 0)

    def loss_fn(m, batch):
        x, y = batch["x"], batch["y"]
        if args.mixup > 0:
            x, soft = apply_mixup_cutmix(x, y, num_classes, batch["mix"],
                                         args.label_smoothing)
        else:
            soft = F.one_hot(y, num_classes).float()
        gen = torch.Generator(device=x.device).manual_seed(batch["seed"])
        return soft_cross_entropy(m(x.to(dtype), gen), soft), {}

    step_fn = make_train_step(loss_fn, tx, ema_decay=args.ema_decay,
                              clip_grad_norm=args.clip_grad)
    stream = it.FixedBatchIterator(
        it.InfinitePermutationSourceIterator(list(range(len(items))),
                                             seed=args.seed),
        args.batch_size) if items else None
    return Trainer(args, cfg, model, state, tx, loss_fn, step_fn, stream,
                   items, sched, dev, num_classes, total_steps)


def main(argv=None):
    args = build_parser().parse_args(argv)
    tr = build_trainer(args)
    state = tr.state
    mgr = CheckpointManager(args.output_dir, keep_last=3)
    restored = mgr.restore(map_location=tr.device)
    if restored:
        sd, data_state, _ = restored
        state.load_state_dict(sd)
        if data_state:
            tr.stream.setstate(data_state)
        print(f"resumed at step {state.step}")

    logger = JsonlLogger()
    t0 = time.time()
    while state.step < tr.total_steps:
        batch = tr.next_batch(state.step)
        state, m = tr.step_fn(state, batch)
        s = state.step
        loss = float(m["loss"])
        if not np.isfinite(loss):
            bad = find_nonfinite(tr.model.state_dict())
            raise FloatingPointError(f"non-finite loss at step {s}; params: "
                                     f"{bad}")
        M.log_scalar("loss", loss)
        if s % 50 == 0:
            logger.log({"loss": loss, "gnorm": float(m["grad_norm"]),
                        "lr": float(tr.sched(s)),
                        "img_s": args.batch_size * 50 / (time.time() - t0)},
                       s)
            t0 = time.time()
        if s % args.save_every == 0:
            mgr.save(s, state.state_dict(), data_state=tr.stream.getstate(),
                     metrics={"loss": loss})
    mgr.save(state.step, state.state_dict(), data_state=tr.stream.getstate())
    mgr.wait()
    return state


if __name__ == "__main__":
    main()
