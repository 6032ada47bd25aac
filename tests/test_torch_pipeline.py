"""Port parity for pipeline parallelism (unilm_tpu_torch.parallel.pipeline)
on four gloo CPU ranks (one spawn, tests/torch_dist_workers.py), against
the JAX package on the same parameters, drawn from a seed with numpy in
the trees JAX's modules give.

- PipelineLM, 2 stages x 4 microbatches with per-microbatch remat (the
  mesh's data axis repeats the pipeline): the loss and every gradient
  equal JAX `PipelineLM.sequential_logits`'s (its parity oracle: the same
  layers in order, one process) under `jax.value_and_grad`, and one
  make_train_step update gives that loss and the global norm of those
  gradients.
- PipelineGPT over UniGPT's text path, stage 2 x fsdp 2 (ZeRO-3 stage
  matrices, microbatch rows split over fsdp): the first step's loss and
  grad norm are JAX UniGPT's; after two AdamW steps the loss, grad norm
  and parameters are the port's one-rank UniGPT's (itself held against
  JAX's train step in tests/test_torch_train.py).
- The CLI's --pp_stages builds PipelineGPT on the stage x fsdp mesh.

Float32 (JAX at matmul precision "highest"); losses and norms 1e-5
relative, gradients 1e-4 relative plus 1e-6 absolute, parameters 1e-5
absolute (sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from unilm_tpu.core.config import TransformerConfig as JCfg
from unilm_tpu.models import kosmos as jk
from unilm_tpu.parallel import make_mesh as jmake_mesh
from unilm_tpu.parallel.pipeline import PipelineLM as JPipelineLM
from unilm_tpu.runtime.train import cross_entropy_loss as jce
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params, to_tensor)
from unilm_tpu_torch.models.kosmos import UniGPT, UniGPTConfig
from unilm_tpu_torch.runtime.optim import AdamW
from unilm_tpu_torch.runtime.train import (TrainState, cross_entropy_loss,
                                           make_train_step)

torch.set_num_threads(1)


def _draw(shapes, seed):
    """A seeded numpy draw in the tree `shapes` (from jax.eval_shape):
    0.1 * N(0, 1), plus 1 for the norms' scales."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        x = 0.1 * rng.randn(*s.shape)
        if getattr(path[-1], "key", None) == "scale":
            x += 1.0
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset

    rng = np.random.RandomState(0)
    docs = [rng.randint(4, 300, size=rng.randint(8, 40)).tolist()
            for _ in range(40)]
    prefix = str(tmp_path_factory.mktemp("corpus") / "data")
    build_indexed_dataset(prefix, docs)
    return prefix


@pytest.fixture(scope="module")
def jax_lm():
    """JAX PipelineLM (2 stages) with numpy-drawn params, and the loss and
    gradients of its sequential oracle on W.pp_tokens()."""
    cfg = JCfg(**W.PP_KW)
    lm = JPipelineLM(cfg, num_stages=2, mesh=jmake_mesh(
        {"stage": 2}, devices=jax.devices()[:2]), num_microbatches=4)
    params = _draw(jax.eval_shape(lm.init, jax.random.PRNGKey(0)), 7)
    toks = jnp.asarray(W.pp_tokens().numpy())

    def loss(p):
        s, n = jce(lm.sequential_logits(p, toks)[:, :-1], toks[:, 1:])
        return s / n

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    return params, float(val), jax.device_get(grads)


def _lm_torch(params):
    """(per-layer state dicts in layer order, embedding, (scale, bias)) of
    a JAX PipelineLM tree."""
    stages = params["stages"]
    S, per = jax.tree.leaves(stages)[0].shape[:2]
    layers = [flax_to_state_dict(jax.tree.map(lambda a: a[s, i], stages))
              for s in range(S) for i in range(per)]
    return (layers, to_tensor(params["embed_tokens"]["embedding"]),
            (to_tensor(params["ln_f"]["scale"]),
             to_tensor(params["ln_f"]["bias"])))


@pytest.fixture(scope="module")
def jax_gpt():
    """JAX UniGPT (GPT_KW) with numpy-drawn params, and the loss and grad
    norm of its text forward on W.pp_tokens()."""
    model = jk.UniGPT(jk.UniGPTConfig(**W.GPT_KW))
    toks = jnp.asarray(W.pp_tokens().numpy())
    params = _draw(jax.eval_shape(model.init, jax.random.PRNGKey(0), toks)
                   ["params"], 9)

    def loss(p):
        logits = model.apply({"params": p}, toks)
        s, n = jce(logits[:, :-1], toks[:, 1:])
        return s / n

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    return params, float(val), _global_norm(grads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, corpus, jax_lm, jax_gpt):
    ref = UniGPT(UniGPTConfig(**W.GPT_KW))
    load_flax_params(ref, jax_gpt[0])
    return W.spawn("pipeline_cases", 4, tmp_path_factory.mktemp("pp"),
                   data=corpus, lm_params=_lm_torch(jax_lm[0]),
                   gpt_params=ref.state_dict())


def test_pipeline_lm_matches_the_sequential_model(ranks, jax_lm):
    _, loss, grads = jax_lm
    layers, emb, ln = _lm_torch(grads)
    per = len(layers) // 2
    close = dict(rtol=1e-4, atol=1e-6)
    for r, res in enumerate(ranks):
        got = res["lm"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        s, g = got["stage"], got["grads"]
        np.testing.assert_allclose(g["embed_tokens.weight"].numpy(),
                                   emb.numpy(), **close)
        np.testing.assert_allclose(g["ln_f_scale"].numpy(), ln[0].numpy(),
                                   **close)
        np.testing.assert_allclose(g["ln_f_bias"].numpy(), ln[1].numpy(),
                                   **close)
        for i in range(per):
            want = layers[s * per + i]
            assert {k[len(f"stage.layers.{i}."):] for k in g
                    if k.startswith(f"stage.layers.{i}.")} == set(want)
            for n, w in want.items():
                np.testing.assert_allclose(
                    g[f"stage.layers.{i}.{n}"].numpy(), w.numpy(), **close,
                    err_msg=f"rank {r} layer {s * per + i} {n}")
        np.testing.assert_allclose(got["step"]["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["step"]["grad_norm"],
                                   _global_norm(grads), rtol=1e-5)


def test_pipeline_gpt_stage_x_fsdp_trains_as_unigpt(ranks, jax_gpt):
    params, jloss, jnorm = jax_gpt
    ref = UniGPT(UniGPTConfig(**W.GPT_KW))
    load_flax_params(ref, params)
    toks = W.pp_tokens()

    def loss_fn(m, batch):
        s, n = cross_entropy_loss(m(batch)[:, :-1], batch[:, 1:])
        return s / n, {}

    tx = AdamW(1e-3)
    state = TrainState.create(ref, tx)
    step = make_train_step(loss_fn, tx, clip_grad_norm=1.0)
    want = []
    for _ in range(2):
        state, m = step(state, toks)
        want.append({k: float(v) for k, v in m.items()})
    np.testing.assert_allclose(want[0]["loss"], jloss, rtol=1e-5)
    np.testing.assert_allclose(want[0]["grad_norm"], jnorm, rtol=1e-5)
    sd = ref.state_dict()
    merged = {}
    for r, res in enumerate(ranks):
        for i, (g, w) in enumerate(zip(res["gpt"]["metrics"], want)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"rank {r} step {i} {k}")
        merged.update(res["gpt"]["params"])
    keys = {k for k in sd if not k.startswith("embed_positions")}
    assert set(merged) == keys
    for k in keys:
        np.testing.assert_allclose(merged[k].numpy(), sd[k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_train_cli_pp_stages_step_is_the_one_rank_step(ranks, corpus):
    """cli/train_gpt.py --pp_stages 2 on 4 ranks (stage 2 x fsdp 2, 4
    GPipe microbatches): the first step's loss and grad norm are the
    one-rank trainer's on the same corpus and seed."""
    want = W.cli_step(corpus, 0)
    for res in ranks:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res["cli"][k], want[k], rtol=1e-5,
                                       err_msg=k)
