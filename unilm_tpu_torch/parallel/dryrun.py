"""The multi-rank dry run (port of `__graft_entry__.dryrun_multichip`, JAX
:121-460): the mesh layouts of the JAX dry run, each a train step at a
tiny size on a gloo process group of n CPU ranks, every loss held against
the same model on one rank.

    python -c "from unilm_tpu_torch.parallel.dryrun import dryrun_multichip
    as d; d(4)"

Layouts (n ranks; as JAX, fsdp 2 when n is even and tensor 2 when 4
divides it; the expert-parallel mesh, which JAX forms from 8 ranks, from
any even n):
- the MoE UniGPT with its Pix2Struct tower (JAX's dry-run model) on an
  expert-parallel mesh (expert 2, the rest data) and on data x fsdp x
  tensor, one AdamW step each (parallel/sharding.py);
- the plain ring (parallel/ring_attention.py `ring_attention`) over the
  fsdp axis against dense attention;
- PipelineLM, stage 2 x data, one step against the sequential model;
- PipelineGPT, stage x fsdp 2 (stage 4 from 8 ranks), one step against
  UniGPT's own loss;
- SeqParallelLM, seq n, one step against the dense loss; and the
  activation footprint of the 1.3B config at 4 x 32k against one 16 GB
  chip and its n-way shard (JAX's argument, the numbers of
  `activation_footprint_bytes`).
It starts n processes (spawn), each initialising the group through a
FileStore in a temporary directory, and joins them; a layout whose loss
is off by more than 1e-5 (relative) raises.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

TOL = 1e-5


def _ce_step(model, loss_fn, batch, sync=None):
    """One AdamW step of `model` through make_train_step; its metrics."""
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import TrainState, make_train_step

    tx = AdamW(1e-4)
    state = TrainState.create(model, tx)
    _, m = make_train_step(loss_fn, tx, clip_grad_norm=1.0,
                           grad_sync=sync)(state, batch)
    return {k: float(v) for k, v in m.items()}


def _unigpt(sizes):
    """JAX's dry-run model (MoE every 2nd layer, 2 experts, the Pix2Struct
    tower, segment embeddings) on a batch of 8; one step, sharded on the
    mesh of `sizes` (None: one rank). Returns the global loss."""
    from unilm_tpu_torch.models.kosmos import (Pix2StructVisionConfig,
                                               UniGPT, UniGPTConfig)
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.sharding import batch_shard, shard_parameters
    from unilm_tpu_torch.runtime.train import (apply_with_moe_aux,
                                               cross_entropy_loss)

    cfg = UniGPTConfig(
        vocab_size=128, embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
        max_positions=64, subln=True, xpos_rel_pos=True, moe_freq=2,
        moe_experts=2, image_tower="pix2struct", latent_query_num=4,
        pix2struct=Pix2StructVisionConfig(
            hidden_size=32, num_layers=1, num_heads=2, d_ff=64, d_kv=16,
            patch_dim=12, max_rows=16, use_flash=False),
        segment_emb=True, use_flash=False)
    model = UniGPT(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    B, T, NP = 8, 32, 8
    g = torch.Generator().manual_seed(1)
    img = torch.randn(B, NP, 2 + 12, generator=g)
    # the patches' (row, col) ids: a 2 x 4 grid (JAX's dry run draws them
    # from a normal, which its clamping gather takes; torch's raises)
    img[..., 0] = (torch.arange(NP) // 4 + 1).float()
    img[..., 1] = (torch.arange(NP) % 4 + 1).float()
    batch = {"tokens": torch.randint(3, 128, (B, T), generator=g),
             "img": img,
             "img_mask": torch.zeros(B, T, dtype=torch.bool),
             "segs": torch.zeros(B, T, dtype=torch.long)}
    batch["img_mask"][:, 1:5] = True
    batch["segs"][:, 1:5] = 1
    sync = None
    if sizes is not None:
        mesh = make_mesh(sizes)
        sync = shard_parameters(model, mesh)
        batch = {k: batch_shard(mesh, v) for k, v in batch.items()}

    def loss_fn(m, b):
        logits, _, stats = apply_with_moe_aux(m, b["tokens"], b["img"],
                                              b["img_mask"], b["segs"])
        s, n = cross_entropy_loss(logits[:, :-1], b["tokens"][:, 1:],
                                  ~b["img_mask"][:, 1:])
        return s / n, stats

    loss = torch.tensor(_ce_step(model, loss_fn, batch, sync)["loss"])
    if sizes is not None:
        dist.all_reduce(loss)
        loss /= dist.get_world_size()
    return float(loss)


def _ring_err(fsdp: int) -> float:
    """max |ring - dense| of the plain ring over the fsdp axis (JAX's SP
    check)."""
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh({"fsdp": fsdp, "data": -1})
    group = mesh.get_group("fsdp")
    B, T, H, D = 2, 8 * fsdp, 2, 8
    q, k, v = torch.randn(3, B, T, H, D, generator=torch.Generator()
                          .manual_seed(3))
    r, Tl = dist.get_rank(group), T // fsdp
    sl = slice(r * Tl, (r + 1) * Tl)
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], group=group,
                         causal=True)
    s = torch.einsum("bthd,bshd->bhts", q * D ** -0.5, k)
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -1e30)
    dense = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    return float((out - dense[:, sl]).abs().max())


def _pipeline_lm(stages):
    """PipelineLM over stage x data, one step: (its loss, the sequential
    model's)."""
    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.core.layers import init_weights_
    from unilm_tpu_torch.core.transformer import DecoderLayer
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.pipeline import (PipelineLM,
                                                   stack_stage_params)
    from unilm_tpu_torch.runtime.train import cross_entropy_loss

    cfg = TransformerConfig(vocab_size=128, embed_dim=64, num_layers=4,
                            num_heads=4, ffn_dim=128, max_positions=64,
                            xpos_rel_pos=True, use_flash=False)
    g = torch.Generator().manual_seed(7)
    layers = [DecoderLayer(cfg) for _ in range(cfg.num_layers)]
    for layer in layers:
        init_weights_(layer, g)
    emb = torch.randn(cfg.vocab_size, cfg.embed_dim, generator=g) * 0.125
    toks = torch.randint(3, 128, (8, 32), generator=g)
    lm = PipelineLM(cfg, stages, make_mesh({"stage": stages, "data": -1}),
                    num_microbatches=2, remat=True)
    lm.load_stages(stack_stage_params([l.state_dict() for l in layers],
                                      stages))
    with torch.no_grad():
        lm.embed_tokens.weight.copy_(emb)

    def loss_fn(m, b):
        s, n = cross_entropy_loss(m.logits(b)[:, :-1], b[:, 1:])
        return s / n, {}

    pp = _ce_step(lm, loss_fn, toks, lm.grad_sync())["loss"]
    from unilm_tpu_torch.core.attention import xpos_inputs

    with torch.no_grad():
        h = emb[toks] * cfg.embed_dim ** 0.5
        xpos = xpos_inputs(cfg, 0, toks.shape[1], h.device)
        for layer in layers:
            h = layer(h, mode="train", causal=True, xpos=xpos)
        h = torch.nn.functional.layer_norm(h, (h.shape[-1],), eps=1e-5)
        s, n = cross_entropy_loss((h @ emb.t())[:, :-1], toks[:, 1:])
    return pp, float(s / n)


def _pipeline_gpt(stages, fsdp):
    """PipelineGPT over stage x fsdp, one step: (its loss, UniGPT's)."""
    from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig
    from unilm_tpu_torch.parallel.mesh import make_mesh
    from unilm_tpu_torch.parallel.pipeline import PipelineGPT
    from unilm_tpu_torch.runtime.train import cross_entropy_loss

    cfg = UniGPTConfig(vocab_size=128, embed_dim=64, num_layers=8,
                       num_heads=4, ffn_dim=128, max_positions=64, subln=True,
                       xpos_rel_pos=True, use_flash=False)
    ref = UniGPT(cfg)
    ref.init_weights(torch.Generator().manual_seed(20))
    toks = torch.randint(4, 128, (8, 24),
                         generator=torch.Generator().manual_seed(21))
    mesh = make_mesh({"stage": stages, "fsdp": fsdp})
    pp = PipelineGPT(cfg, stages, mesh, num_microbatches=2, fsdp_axis="fsdp")
    pp.from_unigpt(ref.state_dict())
    pp.shard_stage()

    def loss_fn(m, b):
        s, n = cross_entropy_loss(m.logits(b)[:, :-1], m._rows(b)[:, 1:])
        return m.rows_mean(s / n), {}

    got = _ce_step(pp, loss_fn, toks, pp.grad_sync())["loss"]
    with torch.no_grad():
        s, n = cross_entropy_loss(ref(toks)[:, :-1], toks[:, 1:])
    return got, float(s / n)


def _seq_lm(n):
    """SeqParallelLM over seq n, one step: (its loss, the dense loss)."""
    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.parallel.long_context import SeqParallelLM
    from unilm_tpu_torch.parallel.mesh import make_mesh

    cfg = TransformerConfig(vocab_size=128, embed_dim=64, num_layers=2,
                            num_heads=4, ffn_dim=128, max_positions=256,
                            xpos_rel_pos=True, use_flash=False)
    toks = torch.randint(3, 128, (2, 8 * n),
                         generator=torch.Generator().manual_seed(12))
    lms = []
    for mesh in (make_mesh({"seq": n}), None):
        lm = SeqParallelLM(cfg, mesh, "seq")
        lm.init_weights(torch.Generator().manual_seed(11))
        lms.append(lm)
    got = _ce_step(lms[0], lms[0].loss_fn, toks, lms[0])["loss"]
    with torch.no_grad():
        want = float(lms[1].loss_fn(lms[1], toks)[0])
    return got, want


def _layouts(n: int) -> list:
    """JAX's mesh shapes for n ranks: the expert-parallel one (expert 2
    when n is even) and data x fsdp x tensor."""
    fsdp = 2 if n % 2 == 0 else 1
    tensor = 2 if n % 4 == 0 else 1
    out = [{"data": n // (fsdp * tensor), "fsdp": fsdp, "tensor": tensor}]
    if n % 2 == 0:
        out.insert(0, {"expert": 2, "data": n // 2})
    return out


def _rank(rank: int, n: int, init: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=n)
    try:
        res = {"one_rank": _unigpt(None), "layouts": []}
        for sizes in _layouts(n):
            res["layouts"].append((sizes, _unigpt(sizes)))
        if n % 2 == 0:
            res["ring_err"] = _ring_err(2)
            res["pipeline_lm"] = _pipeline_lm(2)
        if n >= 4 and n % 2 == 0:
            stages = 4 if n >= 8 else 2
            res["pipeline_gpt"] = _pipeline_gpt(stages, n // stages)
            res["seq_lm"] = _seq_lm(n)
        torch.save(res, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= TOL * max(1.0, abs(b))


def dryrun_multichip(n: int) -> dict:
    """Run the layouts on n gloo CPU ranks; raise AssertionError when a
    loss is off; return rank 0's results."""
    import torch.multiprocessing as mp

    from unilm_tpu_torch.core.config import TransformerConfig
    from unilm_tpu_torch.parallel.long_context import (
        activation_footprint_bytes)

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "res")
        mp.spawn(_rank, args=(n, os.path.join(tmp, "init"), out), nprocs=n,
                 join=True)
        results = [torch.load(f"{out}.{r}.pt", weights_only=False)
                   for r in range(n)]
    for r, res in enumerate(results):
        one = res["one_rank"]
        for sizes, loss in res["layouts"]:
            assert np.isfinite(loss) and _close(loss, one), (
                f"rank {r}: mesh {sizes} loss {loss} != one rank {one}")
        if "ring_err" in res:
            assert res["ring_err"] < 1e-4, f"ring != dense: {res['ring_err']}"
        for key in ("pipeline_lm", "pipeline_gpt", "seq_lm"):
            if key in res:
                got, want = res[key]
                assert _close(got, want), f"rank {r}: {key} {got} != {want}"
    big = TransformerConfig(vocab_size=65037, embed_dim=2048, num_layers=24,
                            num_heads=32, ffn_dim=8192, max_positions=32768)
    full = activation_footprint_bytes(big, 4, 32768) / 1e9
    shard = activation_footprint_bytes(big, 4, 32768 // 8) / 1e9
    assert full > 16.0 and shard < 8.0
    res = dict(results[0], footprint_gb=(full, shard))
    print(f"dryrun_multichip OK: {n} ranks, one-rank loss "
          f"{res['one_rank']:.6f}, layouts "
          f"{[(s, round(l, 6)) for s, l in res['layouts']]}, "
          + ", ".join(f"{k} {tuple(round(x, 6) for x in res[k])}"
                      for k in ("pipeline_lm", "pipeline_gpt", "seq_lm")
                      if k in res)
          + f"; 1.3B at 4 x 32k: {full:.1f} GB > 16 GB, 8-way shard "
          f"{shard:.1f} GB")
    return res
