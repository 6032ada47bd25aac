"""GPT pretraining loop, text path (port of unilm_tpu/cli/train_gpt.py:88-316).

    python -m unilm_tpu_torch.cli.train_gpt --data <mmap prefix> \\
        --dim 2048 --heads 32 --ffn 8192 --vocab 65037 \\
        --batch_size 8 --update_freq 4 --fused_ce --ce_chunk 8192

Checkpointable streaming corpus (mmap binarized or raw text) -> token-block
packing -> fixed batches -> UniGPT train step (micro-batch accumulation,
clipping, polynomial-decay AdamW) -> checkpoints carrying the data-stream
position, with JSONL logging. Resume is bit-exact (model + optimizer +
stream). The flags and defaults are the JAX CLI's. The model lives on the
card when one is visible, else on the CPU (where attention takes its
plain path).

The corpus is read through unilm_tpu_torch.data, whose streams equal
unilm_tpu.data's on the same corpus and seed. `main()` is setup
(`build_trainer`) plus the loop, so a caller can drive the same model,
step and stream without the CLI's checkpoints.

Image-text pretraining (`--vl_data`, slice 5), pipeline parallelism
(`--pp_stages`) and MoE (`--moe_*`, slice 9) raise NotImplementedError
naming their ROADMAP entry.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from unilm_tpu_torch.data import iterators as it
from unilm_tpu_torch.data.dictionary import Dictionary
from unilm_tpu_torch.data.indexed_dataset import (MMapIndexedDataset,
                                                  TokenBlockIterator)
from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig
from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy
from unilm_tpu_torch.runtime.checkpoint import CheckpointManager
from unilm_tpu_torch.runtime.logging import JsonlLogger, find_nonfinite
from unilm_tpu_torch.runtime.optim import AdamW, polynomial_decay_schedule
from unilm_tpu_torch.runtime.train import (TrainState, cross_entropy_loss,
                                           make_train_step)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("GPT pretraining (PyTorch/CUDA)")
    p.add_argument("--data", default="", help="mmap prefix or text file")
    p.add_argument("--dict", default="", help="fairseq dict.txt (text input)")
    p.add_argument("--vl_data", "--vl-data", dest="vl_data", default="",
                   help="glob of grounded image-text jsonl shards")
    p.add_argument("--interleaved", action="store_true")
    p.add_argument("--image_root", default="")
    p.add_argument("--image_tokens", type=int, default=64)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--quantized_size", type=int, default=32)
    p.add_argument("--clip_dim", type=int, default=0)
    p.add_argument("--save_dir", default="./gpt_ckpt")
    p.add_argument("--tokens_per_sample", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--update_freq", type=int, default=1)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup", type=int, default=375)
    p.add_argument("--clip_norm", type=float, default=2.0)
    p.add_argument("--fused_ce", action="store_true",
                   help="chunked-vocab CE (ops/fused_ce.py): no [B,T,V] "
                        "logits tensor; recommended for vocab >= 32k")
    p.add_argument("--ce_chunk", type=int, default=8192)
    p.add_argument("--save_every", type=int, default=200)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dim", type=int, default=1536)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--ffn", type=int, default=6144)
    p.add_argument("--vocab", type=int, default=0, help="override vocab size")
    p.add_argument("--moe_freq", type=int, default=0)
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--moe_gate_loss_wt", type=float, default=0.01)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--pp_stages", type=int, default=0)
    p.add_argument("--pp_microbatches", type=int, default=0)
    return p


def build_stream(args, dictionary):
    if os.path.exists(args.data + ".idx"):
        ds = MMapIndexedDataset(args.data)
        src = it.InfinitePermutationSourceIterator(list(range(len(ds))),
                                                   seed=args.seed)
        doc_iter = it.MapIterator(src, lambda i: ds[i])
    else:  # raw text file: one doc per line
        with open(args.data, encoding="utf-8") as f:
            lines = [l.strip() for l in f if l.strip()]
        src = it.InfinitePermutationSourceIterator(lines, seed=args.seed)
        doc_iter = it.MapIterator(src, dictionary.encode_line)
    blocks = TokenBlockIterator(doc_iter, args.tokens_per_sample,
                                eod=dictionary.eos())
    return it.FixedBatchIterator(blocks, args.batch_size)


@dataclasses.dataclass
class Trainer:
    """Everything `main` loops over: the model inside `state`, the
    optimizer and the step function, the stream and the schedule."""

    args: Any
    cfg: UniGPTConfig
    model: UniGPT
    state: TrainState
    tx: AdamW
    step_fn: Callable
    stream: Any
    sched: Callable[[int], float]
    device: torch.device

    def next_batch(self) -> torch.Tensor:
        """The next [update_freq, B/update_freq, T] (or [B, T]) batch of
        token ids on the device."""
        blocks = next(self.stream)
        batch = torch.from_numpy(np.stack(blocks).astype(np.int64))
        if self.args.update_freq > 1:
            batch = batch.reshape(self.args.update_freq, -1, batch.shape[-1])
        return batch.to(self.device)


def build_trainer(args) -> Trainer:
    """Model (random weights from --seed), optimizer, train step and data
    stream for the parsed CLI `args`."""
    if args.vl_data:
        raise NotImplementedError(
            "image-text pretraining (--vl_data: CLIP tower, grounded "
            "streams) is not ported yet: ROADMAP Queue 1 slice 5")
    if args.pp_stages > 1:
        raise NotImplementedError(
            "pipeline parallelism (--pp_stages) is not ported yet: ROADMAP "
            "Queue 1 slice 9")
    if args.moe_freq or args.moe_experts:
        raise NotImplementedError(
            "MoE layers (--moe_freq/--moe_experts) are not ported yet: "
            "ROADMAP Queue 1 slice 9")
    if not args.data:
        raise ValueError("--data is required")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dictionary = Dictionary.load(args.dict) if args.dict else Dictionary()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    vocab = args.vocab or max(len(dictionary), 260)
    cfg = UniGPTConfig(
        vocab_size=vocab, embed_dim=args.dim, num_layers=args.layers,
        num_heads=args.heads, ffn_dim=args.ffn,
        max_positions=args.tokens_per_sample + 2, subln=True,
        xpos_rel_pos=True, remat=args.remat, dtype=dtype)
    model = UniGPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    stream = build_stream(args, dictionary)

    sched = polynomial_decay_schedule(args.lr, args.max_steps, args.warmup)
    tx = AdamW(sched, b1=0.9, b2=0.98, weight_decay=0.01)
    state = TrainState.create(model, tx)

    def ce(m, out, targets):
        if args.fused_ce:
            return chunked_cross_entropy(out, m.embed_tokens.weight, targets,
                                         chunk=args.ce_chunk)
        return cross_entropy_loss(out, targets)

    def loss_fn(m, batch):
        out = m(batch, return_features=args.fused_ce)
        s, n = ce(m, out[:, :-1], batch[:, 1:])
        return s / n, {"ntok": n}

    step_fn = make_train_step(
        loss_fn, tx, clip_grad_norm=args.clip_norm,
        microbatches=args.update_freq if args.update_freq > 1 else 1)
    return Trainer(args, cfg, model, state, tx, step_fn, stream, sched, dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    tr = build_trainer(args)
    state = tr.state
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params, vocab {tr.cfg.vocab_size}")

    mgr = CheckpointManager(args.save_dir, keep_last=3)
    restored = mgr.restore(map_location=tr.device)
    if restored:
        sd, data_state, _ = restored
        state.load_state_dict(sd)
        if data_state:
            tr.stream.setstate(data_state)
        print(f"resumed at step {state.step}")

    logger = JsonlLogger()
    t0 = time.time()
    while state.step < args.max_steps:
        batch = tr.next_batch()
        state, m = tr.step_fn(state, batch)
        s = state.step
        loss = float(m["loss"])
        if not np.isfinite(loss):
            bad = find_nonfinite(tr.model.state_dict())
            raise FloatingPointError(f"non-finite loss at step {s}; params: "
                                     f"{bad}")
        if s % args.log_every == 0:
            tok_s = (args.batch_size * args.tokens_per_sample * args.log_every
                     / (time.time() - t0))
            logger.log({"loss": loss, "ppl": float(np.exp(min(loss, 20))),
                        "gnorm": float(m["grad_norm"]),
                        "lr": float(tr.sched(s)), "tok_s": tok_s}, s)
            t0 = time.time()
        if s % args.save_every == 0 or s >= args.max_steps:
            mgr.save(s, state.state_dict(), data_state=tr.stream.getstate(),
                     metrics={"loss": loss})
    mgr.wait()
    print("done")


if __name__ == "__main__":
    main()
