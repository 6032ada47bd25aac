"""(Multimodal) GPT pretraining loop (port of unilm_tpu/cli/train_gpt.py:
`build_vl_stream` :40, `build_stream` :70, `main` :88-316).

    python -m unilm_tpu_torch.cli.train_gpt --data <mmap prefix> \\
        --dim 2048 --heads 32 --ffn 8192 --vocab 65037 \\
        --batch_size 8 --update_freq 4 --fused_ce --ce_chunk 8192
    python -m unilm_tpu_torch.cli.train_gpt --vl_data 'shards/*.jsonl' \\
        --dim 2048 --layers 24 --heads 32 --ffn 8192 --vocab 65037 \\
        --tokens_per_sample 512 --batch_size 2 --remat --fused_ce

Checkpointable streaming corpus (mmap binarized or raw text) -> token-block
packing -> fixed batches -> UniGPT train step (micro-batch accumulation,
clipping, polynomial-decay AdamW) -> checkpoints carrying the data-stream
position, with JSONL logging. Resume is bit-exact (model + optimizer +
stream). The flags and defaults are the JAX CLI's, plus `--device`: the
model lives on the card ("cuda", the default, which raises on a host
without one) unless `--device cpu` asks for the CPU (where attention
takes its plain path).

The corpus is read through unilm_tpu_torch.data, whose streams equal
unilm_tpu.data's on the same corpus and seed. `main()` is setup
(`build_trainer`) plus the loop, so a caller can drive the same model,
step and stream without the CLI's checkpoints.

`--vl_data` (Kosmos-2 grounded image-text pretraining): jsonl shards
(laion_obj records, or `--interleaved` documents) -> grounding markup ->
VLTokenizer ids (tiktoken's cl100k_base if cached, else bytes) ->
fixed-shape rows with an `<image>` span -> a UniGPT with the CLIP tower
(ViT-L/14 at `--image_size`, or a 2-layer tower of width `--clip_dim`),
`--image_tokens` latent queries and segment embeddings; the loss covers
the text positions only (`loss_mask`). The stream's state, shuffle
buffer included, is saved with each checkpoint.

Pipeline parallelism (`--pp_stages S`, text pretraining, dense layers,
as the JAX CLI asserts): run under torchrun; the world's ranks form a
stage x fsdp mesh (fsdp = world / S), the UniGPT decoder's layers split
over the stages (parallel/pipeline.py `PipelineGPT`, `--pp_microbatches`
GPipe microbatches, 2 S by default) with ZeRO-3 stage matrices and the
rows split over fsdp. The process group comes from torchrun's environment
(NCCL on the card, gloo on the CPU), each rank on its LOCAL_RANK card;
checkpoints go to `<save_dir>/rank<r>`.

MoE (`--moe_freq` / `--moe_experts`): every moe_freq-th layer is an X-MoE
layer (core/moe.py); the loss adds `--moe_gate_loss_wt` times the GShard
loss summed over the MoE layers (runtime/train.py `apply_with_moe_aux`,
the reference's moe_gate_loss_wt) and the step's metrics carry
`moe_overflow`. The step routes deterministically (eval capacity), as the
JAX CLI's apply does.
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
from unilm_tpu_torch.models.kosmos import (ClipVisionConfig, UniGPT,
                                           UniGPTConfig)
from unilm_tpu_torch.ops.fused_ce import chunked_cross_entropy
from unilm_tpu_torch.runtime.checkpoint import CheckpointManager
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime import metrics as M
from unilm_tpu_torch.runtime.logging import JsonlLogger, find_nonfinite
from unilm_tpu_torch.runtime.optim import AdamW, polynomial_decay_schedule
from unilm_tpu_torch.runtime.train import (TrainState, apply_with_moe_aux,
                                           cross_entropy_loss,
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def build_vl_stream(args):
    """Grounded image-text batches (Kosmos-2's laion2b_obj loader): the
    shards of the `--vl_data` glob -> (batch stream, tokenizer)."""
    import glob

    from unilm_tpu_torch.data.vl_loaders import (VLSampleSpec, VLTokenizer,
                                                 interleaved_stream,
                                                 laion_obj_stream,
                                                 vl_batch_stream)

    shards = sorted(glob.glob(args.vl_data))
    if not shards:
        raise FileNotFoundError(f"no shards match {args.vl_data}")
    tok = VLTokenizer(quantized_size=args.quantized_size)
    spec = VLSampleSpec(tokens_per_sample=args.tokens_per_sample,
                        image_tokens=args.image_tokens,
                        image_size=args.image_size, max_images=1)
    maker = interleaved_stream if args.interleaved else laion_obj_stream
    samples = maker(shards, tok, spec, image_root=args.image_root,
                    seed=args.seed)
    return vl_batch_stream(samples, args.batch_size), tok


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

    def next_batch(self):
        """The next batch on the device, with a leading [update_freq] axis
        when update_freq > 1: [B, T] token ids, or under --vl_data a dict
        of tokens, images, img_mask, segs and loss_mask."""
        blocks = next(self.stream)
        uf = self.args.update_freq

        def put(x: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "iu"
                                 else x)
            if uf > 1:
                t = t.reshape(uf, -1, *t.shape[1:])
            return t.to(self.device)

        if isinstance(blocks, dict):
            return {k: put(v) for k, v in blocks.items()}
        return put(np.stack(blocks))


def _pp_device(dev: torch.device) -> torch.device:
    """The rank's device and process group for --pp_stages (torchrun's
    environment: NCCL with LOCAL_RANK's card, or gloo on the CPU)."""
    import torch.distributed as dist

    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def build_trainer(args) -> Trainer:
    """Model (random weights from --seed), optimizer, train step and data
    stream for the parsed CLI `args`."""
    multimodal = bool(args.vl_data)
    if not multimodal and not args.data:
        raise ValueError("one of --data / --vl_data is required")
    pp = args.pp_stages > 1
    if pp and (multimodal or args.moe_freq):
        raise ValueError("--pp_stages: text-only pretraining with dense "
                         "layers (the JAX CLI's scope)")
    dev = resolve_device(args.device)
    if pp:
        dev = _pp_device(dev)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    kw = dict(embed_dim=args.dim, num_layers=args.layers,
              num_heads=args.heads, ffn_dim=args.ffn,
              max_positions=args.tokens_per_sample + 2, subln=True,
              xpos_rel_pos=True, moe_freq=args.moe_freq,
              moe_experts=args.moe_experts, remat=args.remat, dtype=dtype)
    if multimodal:
        stream, tok = build_vl_stream(args)
        clip = ClipVisionConfig(img_size=args.image_size, dtype=dtype)
        if args.clip_dim:
            clip = ClipVisionConfig(
                img_size=args.image_size, embed_dim=args.clip_dim,
                num_layers=2, num_heads=max(2, args.clip_dim // 32),
                ffn_dim=args.clip_dim * 4, dtype=dtype)
        cfg = UniGPTConfig(vocab_size=args.vocab or tok.vocab_size,
                           image_tower="clip",
                           latent_query_num=args.image_tokens, clip=clip,
                           segment_emb=True, **kw)
    else:
        dictionary = Dictionary.load(args.dict) if args.dict else Dictionary()
        cfg = UniGPTConfig(vocab_size=args.vocab or max(len(dictionary), 260),
                           **kw)
        stream = build_stream(args, dictionary)
    model = UniGPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    sync = None
    if pp:
        import torch.distributed as dist

        from unilm_tpu_torch.parallel.mesh import make_mesh
        from unilm_tpu_torch.parallel.pipeline import PipelineGPT

        S = args.pp_stages
        n = dist.get_world_size()
        if n % S:
            raise ValueError(f"{n} ranks not divisible by {S} stages")
        fsdp = n // S
        mesh = make_mesh({"stage": S, "fsdp": fsdp} if fsdp > 1
                         else {"stage": S})
        full = model
        model = PipelineGPT(cfg, S, mesh, args.pp_microbatches or 2 * S,
                            remat=args.remat,
                            fsdp_axis="fsdp" if fsdp > 1 else None,
                            device=dev)
        model.from_unigpt(full.state_dict())
        del full
        model.shard_stage()
        sync = model.grad_sync()

    sched = polynomial_decay_schedule(args.lr, args.max_steps, args.warmup)
    tx = AdamW(sched, b1=0.9, b2=0.98, weight_decay=0.01)
    state = TrainState.create(model, tx)

    def ce(m, out, targets, mask=None):
        if args.fused_ce:
            return chunked_cross_entropy(out, m.embed_tokens.weight, targets,
                                         mask, chunk=args.ce_chunk)
        return cross_entropy_loss(out, targets, mask)

    moe = args.moe_freq > 0 and args.moe_experts > 0
    wt = args.moe_gate_loss_wt

    def apply(m, *a, **k):
        """The forward, with the summed MoE gate loss and its stats for
        an MoE model (the criterion adds wt * gate loss)."""
        if moe:
            return apply_with_moe_aux(m, *a, **k)
        return m(*a, **k), 0.0, {}

    if pp:
        def loss_fn(m, batch):
            out = m.features(batch) if args.fused_ce else m.logits(batch)
            rows = m._rows(batch)
            s, n = ce(m, out[:, :-1], rows[:, 1:])
            return m.rows_mean(s / n), {"ntok": n}
    elif multimodal:
        def loss_fn(m, batch):
            tokens = batch["tokens"]
            out, aux, stats = apply(m, tokens, batch["images"][:, 0],
                                    batch["img_mask"], batch["segs"],
                                    return_features=args.fused_ce)
            # the text positions only (Kosmos-2's UniGPTLoss)
            s, n = ce(m, out[:, :-1], tokens[:, 1:],
                      batch["loss_mask"][:, 1:])
            return s / n + wt * aux, {"ntok": n, **stats}
    else:
        def loss_fn(m, batch):
            out, aux, stats = apply(m, batch, return_features=args.fused_ce)
            s, n = ce(m, out[:, :-1], batch[:, 1:])
            return s / n + wt * aux, {"ntok": n, **stats}

    step_fn = make_train_step(
        loss_fn, tx, clip_grad_norm=args.clip_norm,
        microbatches=args.update_freq if args.update_freq > 1 else 1,
        grad_sync=sync)
    return Trainer(args, cfg, model, state, tx, step_fn, stream, sched, dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    tr = build_trainer(args)
    state = tr.state
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params, vocab {tr.cfg.vocab_size}")

    save_dir = args.save_dir
    if args.pp_stages > 1:
        import torch.distributed as dist

        save_dir = os.path.join(save_dir, f"rank{dist.get_rank()}")
    mgr = CheckpointManager(save_dir, keep_last=3)
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
        M.log_scalar("loss", loss)
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
