"""Multi-rank CPU runs for the port's parallel tests: `spawn(name, world,
tmp_path, **kwargs)` starts `world` processes (torch.multiprocessing,
spawn), each joins a gloo process group through a FileStore under
`tmp_path` with one thread, runs the function `name` of this module as
`name(rank, world, **kwargs)` and saves what it returns; `spawn` returns
the ranks' results in rank order.

This module imports torch and the port only (no JAX), so a rank starts
in a few seconds; the test files compare the results with JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor


def _worker(rank, world, init_file, name, out_prefix, kwargs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        res = globals()[name](rank, world, **kwargs)
        torch.save(res, f"{out_prefix}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(name: str, world: int, tmp_path, **kwargs) -> list:
    init = os.path.join(str(tmp_path), f"{name}.init")
    prefix = os.path.join(str(tmp_path), name)
    mp.spawn(_worker, args=(world, init, name, prefix, kwargs), nprocs=world,
             join=True)
    return [torch.load(f"{prefix}.{r}.pt", weights_only=False)
            for r in range(world)]


# --------------------------------------------------------------------------- #
# ring attention
# --------------------------------------------------------------------------- #


def ring_inputs(case: str, world: int):
    """The global (q, k, v, g, mask) of a ring case, float32 numpy, from a
    seed (the parent builds the same arrays)."""
    rng = np.random.RandomState({"causal": 0, "masked": 1,
                                 "noncontig": 2}[case])
    B, H, D = (3 if case == "noncontig" else 2), 2, 16
    T = 8 * world
    q, k, v, g = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    mask = None
    if case == "masked":
        mask = rng.rand(B, T) > 0.25
    elif case == "noncontig":
        mask = np.ones((B, T), bool)
        mask[0, 8:11] = False  # left padding inside chunk 1: rows 8-10
        mask[0, 20] = False    # see no key of their own (diagonal) chunk
        mask[1, 3:5] = False
        mask[2] = False        # an example that masks every key
    return q, k, v, g, mask


def ring_cases(rank, world, cases):
    from unilm_tpu_torch.parallel.ring_attention import (ring_attention,
                                                         ring_attention_flash)

    group = dist.group.WORLD
    out = {}
    for case in cases:
        q, k, v, g, mask = ring_inputs(case, world)
        causal = case != "masked"
        Tl = q.shape[1] // world
        sl = slice(rank * Tl, (rank + 1) * Tl)
        ts = [torch.from_numpy(np.ascontiguousarray(a[:, sl])
                               ).requires_grad_() for a in (q, k, v)]
        m = None if mask is None else torch.from_numpy(
            np.ascontiguousarray(mask[:, sl]))
        o = ring_attention_flash(*ts, m, group, causal)
        (o * torch.from_numpy(np.ascontiguousarray(g[:, sl]))).sum().backward()
        out[case] = {"out": o.detach(), "dq": ts[0].grad, "dk": ts[1].grad,
                     "dv": ts[2].grad}
        if case == "causal":
            out["plain"] = ring_attention(
                *(t.detach() for t in ts), group=group, causal=True)
    return out


def seq_lm_step(rank, world, cfg_kw, steps):
    """SeqParallelLM through make_train_step on `world` ranks: the loss and
    grad norm of each step, and the parameters after them."""
    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.parallel.long_context import SeqParallelLM
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import TrainState, make_train_step

    cfg = TransformerConfig(**cfg_kw)
    lm = SeqParallelLM(cfg, group=dist.group.WORLD)
    lm.init_weights(torch.Generator().manual_seed(11))
    toks = torch.from_numpy(np.random.RandomState(12).randint(
        3, cfg.vocab_size, size=(2, 8 * world)))
    tx = AdamW(1e-3)
    state = TrainState.create(lm, tx)
    step = make_train_step(lm.loss_fn, tx, clip_grad_norm=1.0,
                           grad_sync=lm)
    metrics = []
    for _ in range(steps):
        state, m = step(state, toks)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {n: p.detach().clone()
                       for n, p in lm.named_parameters()}}


# --------------------------------------------------------------------------- #
# mesh layouts: expert parallel, data x fsdp x tensor
# --------------------------------------------------------------------------- #

MOE_KW = dict(vocab_size=96, embed_dim=32, num_layers=2, num_heads=4,
              ffn_dim=64, max_positions=64, subln=True, xpos_rel_pos=True,
              moe_freq=2, moe_experts=4, use_flash=False)


def moe_lm(sizes=None, steps=2, **overrides):
    """A tiny MoE UniGPT (seeded; MOE_KW with `overrides`), sharded on
    the mesh of axis `sizes` when given, trained `steps` AdamW steps on a
    seeded batch of 8 rows with the GShard loss (wt 0.01). Returns the
    metrics and every parameter, whole."""
    from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.sharding import (batch_shard, param_specs,
                                                   mesh_sizes_of,
                                                   shard_parameters)
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import (TrainState,
                                               apply_with_moe_aux,
                                               cross_entropy_loss,
                                               make_train_step)

    model = UniGPT(UniGPTConfig(**{**MOE_KW, **overrides}), device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        3, MOE_KW["vocab_size"], size=(8, 24)))
    sync, mesh, specs = None, None, {}
    if sizes is not None:
        mesh = make_mesh(sizes)
        specs = param_specs(model, mesh_sizes_of(mesh))
        sync = shard_parameters(model, mesh)
        toks = batch_shard(mesh, toks)

    def loss_fn(m, batch):
        logits, aux, stats = apply_with_moe_aux(m, batch)
        s, n = cross_entropy_loss(logits[:, :-1], batch[:, 1:])
        return s / n + 0.01 * aux, stats

    tx = AdamW(1e-3, weight_decay=0.01)
    state = TrainState.create(model, tx)
    step = make_train_step(loss_fn, tx, clip_grad_norm=1.0, grad_sync=sync)
    metrics = []
    for _ in range(steps):
        state, m = step(state, toks)
        vals = {k: torch.as_tensor(v).detach().float().clone()
                for k, v in m.items()}
        if mesh is not None:
            # the global loss and overflow: mean over the batch shards
            for k in ("loss", "moe_overflow"):
                dist.all_reduce(vals[k])
                vals[k] /= dist.get_world_size()
        metrics.append({k: float(v) for k, v in vals.items()})
    params = {}
    names = specs.items() if specs else [
        (n, ()) for n, _ in model.named_parameters()]
    for name, spec in names:
        mod_name, _, pname = name.rpartition(".")
        t = getattr(model.get_submodule(mod_name), pname).detach()
        if isinstance(t, DTensor):  # FSDP2's shard over data x fsdp
            t = t.full_tensor()
        for axis in ("expert", "tensor"):  # the dims a rank keeps its block of
            if axis in spec:
                group = mesh.get_group(axis)
                parts = [torch.empty_like(t) for _ in range(
                    dist.get_world_size(group))]
                dist.all_gather(parts, t.contiguous(), group=group)
                t = torch.cat(parts, spec.index(axis))
        params[name] = t.clone()
    # the projections split over `tensor`: kind and the weight they read
    splits = {n: (m.tensor_split[0], tuple(m.weight.shape))
              for n, m in model.named_modules()
              if getattr(m, "tensor_split", None) is not None}
    # the attention modules that attend over this rank's block of heads
    heads = sorted(n for n, m in model.named_modules()
                   if hasattr(m, "heads_group") and m.heads_group())
    return {"metrics": metrics, "params": params, "splits": splits,
            "heads_split": heads,
            "param_types": sorted({type(p).__name__
                                   for p in model.parameters()})}


SERVE_KW = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
                ffn_dim=48, max_positions=128, use_flash=False,
                image_tower=None, subln=True, xpos_rel_pos=True, moe_freq=2,
                moe_experts=4)
SERVE_PROMPTS = [("a", [5, 9, 11]), ("b", [7, 3, 3, 8, 12, 4, 30, 9, 17]),
                 ("c", [22, 41])]


def serve(sizes=None, kv_dtype="model"):
    """Greedy streams of ServingEngine on a seeded MoE UniGPT, one-rank or
    over the mesh of axis `sizes`."""
    from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.runtime.serving import (ServingConfig,
                                                 ServingEngine)

    cfg = UniGPTConfig(**SERVE_KW)
    model = UniGPT(cfg)
    model.init_weights(torch.Generator().manual_seed(5))
    scfg = ServingConfig(max_batch=2, page_size=8, num_pages=32,
                         max_pages_per_seq=8, max_new_tokens=6, eos=63,
                         prefill_bucket=8, chunk_pages=2, kv_dtype=kv_dtype)
    mesh = None if sizes is None else make_mesh(sizes)
    eng = ServingEngine(cfg, scfg, model.state_dict(), mesh=mesh,
                        device="cpu")
    for rid, p in SERVE_PROMPTS:
        eng.submit(rid, p)
    return {k: list(map(int, v)) for k, v in eng.run().items()}


SERVE_MESHES = {"tensor4": ({"tensor": 4}, "model"),
                "tensor2_int8_kv": ({"tensor": 2, "data": 2}, "int8")}


def mesh_layouts(rank, world, layouts):
    out = {name: moe_lm(sizes, **kw) for name, (sizes, kw) in layouts.items()}
    out["serve"] = {name: serve(sizes, kv)
                    for name, (sizes, kv) in SERVE_MESHES.items()}
    return out


# --------------------------------------------------------------------------- #
# pipeline parallelism
# --------------------------------------------------------------------------- #

PP_KW = dict(vocab_size=96, embed_dim=32, num_layers=4, num_heads=4,
             ffn_dim=64, max_positions=64, xpos_rel_pos=True, use_flash=False)


GPT_KW = dict(vocab_size=96, embed_dim=32, num_layers=4, num_heads=4,
              ffn_dim=64, max_positions=64, subln=True, xpos_rel_pos=True,
              use_flash=False, image_tower=None)


def pp_tokens():
    return torch.from_numpy(np.random.RandomState(8).randint(
        3, PP_KW["vocab_size"], size=(8, 24)))


CLI_ARGS = ["--dim", "32", "--layers", "4", "--heads", "4", "--ffn", "64",
            "--vocab", "300", "--tokens_per_sample", "16", "--batch_size",
            "8", "--fused_ce", "--ce_chunk", "128", "--warmup", "1",
            "--device", "cpu"]


def cli_step(data: str, pp_stages: int):
    """One step of cli/train_gpt.py's trainer (float32) on the corpus
    `data`: its metrics."""
    from unilm_tpu_torch.cli import train_gpt

    args = train_gpt.build_parser().parse_args(
        ["--data", data, "--pp_stages", str(pp_stages)] + CLI_ARGS)
    args.bf16 = False
    tr = train_gpt.build_trainer(args)
    _, m = tr.step_fn(tr.state, tr.next_batch())
    return {k: float(v) for k, v in m.items()}


def pipeline_cases(rank, world, data, lm_params, gpt_params):
    """`lm_params`: (per-layer DecoderLayer state dicts, embedding [V, E],
    ln_f (scale, bias)) of a PipelineLM; `gpt_params`: a UniGPT
    state_dict. The parent makes both from JAX's trees."""
    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.models.kosmos import UniGPTConfig
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.pipeline import (PipelineGPT, PipelineLM,
                                                   stack_stage_params)
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import (TrainState, cross_entropy_loss,
                                               make_train_step)

    out = {}
    # PipelineLM, 2 stages x 4 microbatches (the data axis repeats it)
    cfg = TransformerConfig(**PP_KW)
    per_layer, emb, ln = lm_params
    mesh = make_mesh({"stage": 2, "data": 2})
    lm = PipelineLM(cfg, num_stages=2, mesh=mesh, num_microbatches=4,
                    remat=True)
    lm.load_stages(stack_stage_params(per_layer, 2))
    with torch.no_grad():
        lm.embed_tokens.weight.copy_(emb)
        lm.ln_f_scale.copy_(ln[0])
        lm.ln_f_bias.copy_(ln[1])
    toks = pp_tokens()

    def lm_loss(m, batch):
        logits = m.logits(batch)
        s, n = cross_entropy_loss(logits[:, :-1], batch[:, 1:])
        return s / n, {}

    loss, _ = lm_loss(lm, toks)
    loss.backward()
    out["lm"] = {"loss": float(loss), "stage": lm.stage_index,
                 "grads": {n: p.grad.clone() for n, p in
                           lm.named_parameters()}}
    for p in lm.parameters():
        p.grad = None
    tx = AdamW(1e-3)
    state = TrainState.create(lm, tx)
    step = make_train_step(lm_loss, tx, clip_grad_norm=1.0,
                           grad_sync=lm.grad_sync())
    state, m = step(state, toks)
    out["lm"]["step"] = {k: float(v) for k, v in m.items()}

    # PipelineGPT, stage 2 x fsdp 2 over a UniGPT's text path
    mesh = make_mesh({"stage": 2, "fsdp": 2})
    pp = PipelineGPT(UniGPTConfig(**GPT_KW), num_stages=2, mesh=mesh,
                     num_microbatches=2, fsdp_axis="fsdp")
    pp.from_unigpt(gpt_params)
    pp.shard_stage()

    def gpt_loss(m, batch):
        logits = m.logits(batch)
        rows = m._rows(batch)
        s, n = cross_entropy_loss(logits[:, :-1], rows[:, 1:])
        return s / n, {}

    tx = AdamW(1e-3)
    state = TrainState.create(pp, tx)
    step = make_train_step(gpt_loss, tx, clip_grad_norm=1.0,
                           grad_sync=pp.grad_sync())
    metrics = []
    for _ in range(2):
        state, m = step(state, toks)
        vals = torch.tensor([float(m["loss"])])
        dist.all_reduce(vals, group=mesh.get_group("fsdp"))
        metrics.append({"loss": float(vals) / 2,
                        "grad_norm": float(m["grad_norm"])})
    out["gpt"] = {"metrics": metrics, "stage": pp.stage_index,
                  "params": {k: v.clone() for k, v in pp.to_unigpt().items()}}
    # the CLI's --pp_stages 2 on the 4 ranks: stage 2 x fsdp 2
    out["cli"] = cli_step(data, 2)
    return out
