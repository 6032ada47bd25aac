"""Port parity for the train slice: unilm_tpu_torch's chunked cross
entropy, optimizers, schedules, train step and train CLI against
unilm_tpu / optax on the CPU.

Inputs come from numpy; JAX runs at matmul precision 'highest'
(tests/conftest.py). Tolerances, with their reasons:
- chunked CE: loss 1e-5 relative, grads 1e-6 abs (fp32, the same chunked
  online log-sum-exp summed in another order);
- optimizers over 3 updates: params 1e-6 abs + 1e-5 rel (fp32; the
  schedule is evaluated in float64 here and float32 in optax);
- schedules: 1e-6 relative + 1e-10 abs (float64 against optax's
  float32, whose (init - peak) * frac + peak loses the low bits of a small
  warmup_init_lr);
- tiny UniGPT: loss and metrics 1e-5 relative, every gradient 1e-5 abs
  at |g| < 1, params after 2 AdamW steps 1e-5 abs, 1% of the lr of 1e-3
  (Adam's m/(sqrt(v) + eps) turns fp32 noise in a gradient element of
  |g| ~ eps = 1e-8 into a few percent of its update; elsewhere the
  difference is ~1e-9);
- remat and CLI resume: bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.ops import fused_ce as jce
from unilm_tpu.runtime import optim as joptim
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.ops import fused_ce as tce
from unilm_tpu_torch.runtime import optim as toptim
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(1)


@pytest.mark.parametrize("ls,masked", [(0.0, False), (0.1, True)])
def test_chunked_cross_entropy_matches_jax(ls, masked):
    rng = np.random.RandomState(0)
    N, E, V, chunk = 37, 24, 300, 128  # 3 chunks, the last one ragged
    x = rng.randn(N, E).astype(np.float32)
    emb = (rng.randn(V, E) * 0.3).astype(np.float32)
    tgt = rng.randint(0, V, size=N).astype(np.int32)
    tgt[:3] = [0, V - 1, 128]
    mask = (rng.rand(N) > 0.3) if masked else None

    def jf(a, b):
        return jce.chunked_cross_entropy(
            a, b, jnp.asarray(tgt),
            None if mask is None else jnp.asarray(mask), chunk=chunk,
            label_smoothing=ls)

    jl, jn = jf(jnp.asarray(x), jnp.asarray(emb))
    jg = jax.grad(lambda a, b: jf(a, b)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(emb))
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tl, tn = tce.chunked_cross_entropy(
        tx, te, torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask), chunk=chunk,
        label_smoothing=ls)
    tl.backward()
    assert float(tn) == float(jn)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg[1]), atol=1e-6)
    # the dense loss of runtime.train gives the same value
    dl, dn = ttrain.cross_entropy_loss(
        torch.from_numpy(x) @ torch.from_numpy(emb).t(),
        torch.from_numpy(tgt), None if mask is None else torch.from_numpy(mask),
        label_smoothing=ls)
    np.testing.assert_allclose(float(dl), float(jl), rtol=1e-5)
    assert float(dn) == float(jn)


SHAPES = [(256, 130), (130, 256), (64, 32), (40,), (3, 200, 150)]
# sorted, so JAX's dict leaves come in this order; the names steer
# create_optimizer's weight-decay mask (no decay on pos_embed and 1-D)
NAMES = ["a_w", "b_w", "c_pos_embed", "d_bias", "e_w"]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw_clip_mask"])
def test_optimizers_match_optax(name):
    """3 updates on factored (both dims >= 128) and unfactored shapes, with
    a warmup schedule (so the first update has lr 0, as in optax);
    adamw_clip_mask is create_optimizer's adamw branch with global-norm
    clipping (active: the gradients' norm is ~300) and the decay mask."""
    rng = np.random.RandomState(1)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    sched_j = joptim.polynomial_decay_schedule(1e-2, 10, 1)
    sched_t = toptim.polynomial_decay_schedule(1e-2, 10, 1)
    jp = {n: jnp.asarray(p) for n, p in zip(NAMES, params)}
    tp = [torch.from_numpy(p.copy()) for p in params]
    if name == "adamw":
        jtx = optax.adamw(sched_j, b1=0.9, b2=0.98, weight_decay=0.01)
        ttx = toptim.AdamW(sched_t, b1=0.9, b2=0.98, weight_decay=0.01)
    elif name == "adafactor":
        jtx = optax.adafactor(sched_j)
        ttx = toptim.Adafactor(sched_t)
    else:
        kw = dict(weight_decay=0.05, betas=(0.9, 0.98), clip_grad_norm=1.0)
        jtx = joptim.create_optimizer(jp, sched_j, **kw)
        ttx = toptim.create_optimizer(list(zip(NAMES, tp)), sched_t, **kw)
        assert ttx.mask == [True, True, False, False, True]
    js = jtx.init(jp)
    ts = ttx.init(tp)
    for gs in grads:
        u, js = jtx.update({n: jnp.asarray(g) for n, g in zip(NAMES, gs)},
                           js, jp)
        jp = optax.apply_updates(jp, u)
        ttx.update([torch.from_numpy(g) for g in gs], ts, tp)
    for a, n in zip(tp, NAMES):
        np.testing.assert_allclose(a.numpy(), np.asarray(jp[n]), atol=1e-6,
                                   rtol=1e-5, err_msg=n)
    assert ts["count"] == 3
    assert float(np.abs(tp[0].numpy() - params[0]).max()) > 1e-4


def test_schedules_match_jax():
    cases = [
        (joptim.polynomial_decay_schedule(2e-4, 100, 10, end_lr=1e-5,
                                          power=2.0, warmup_init_lr=1e-6),
         toptim.polynomial_decay_schedule(2e-4, 100, 10, end_lr=1e-5,
                                          power=2.0, warmup_init_lr=1e-6)),
        (joptim.polynomial_decay_schedule(2e-4, 5, 0),
         toptim.polynomial_decay_schedule(2e-4, 5, 0)),
        (joptim.cosine_schedule(1e-3, 100, 10, min_lr=1e-5),
         toptim.cosine_schedule(1e-3, 100, 10, min_lr=1e-5)),
        (joptim.inverse_sqrt_schedule(5e-4, 16, 1e-7),
         toptim.inverse_sqrt_schedule(5e-4, 16, 1e-7)),
    ]
    for js, ts in cases:
        for c in (0, 1, 2, 5, 9, 10, 11, 15, 16, 17, 50, 99, 100, 150):
            np.testing.assert_allclose(ts(c), float(js(jnp.asarray(c))),
                                       rtol=1e-6, atol=1e-10, err_msg=str(c))


def test_create_optimizer_branches():
    named = [("w", torch.zeros(4, 4)), ("b", torch.zeros(4)),
             ("pos_embed", torch.zeros(2, 4))]
    tx = toptim.create_optimizer(named, 1e-3, weight_decay=0.05)
    assert isinstance(tx, toptim.AdamW) and tx.mask == [True, False, False]
    assert isinstance(toptim.create_optimizer(named, 1e-3,
                                              optimizer="adafactor"),
                      toptim.Adafactor)
    # LAMB, SGD and layer decay, once "not ported", now build (their
    # arithmetic against optax: tests/test_torch_beit_train.py)
    lamb = toptim.create_optimizer(named, 1e-3, optimizer="lamb")
    assert isinstance(lamb, toptim.Lamb) and lamb.mask == [True, False, False]
    ld = toptim.create_optimizer(named, 1e-3, layer_decay=0.75, num_layers=2)
    assert isinstance(ld, toptim.AdamW) and ld.scales == [1.0, 1.0, 0.75 ** 3]
    assert isinstance(toptim.create_optimizer(named, 1e-3, optimizer="sgd"),
                      toptim.Sgd)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.create_optimizer(named, 1e-3, optimizer="rmsprop")


# --------------------------------------------------------------------------- #
# tiny UniGPT: the train step against make_train_step + optax.adamw
# --------------------------------------------------------------------------- #

KW = dict(vocab_size=512, embed_dim=64, num_layers=2, num_heads=4,
          ffn_dim=128, max_positions=40, scale_length=16)
B, T, MB = 2, 32, 2
LR = 1e-3


def _batch():
    """[MB, B, T] tokens with pad (id 1) keys; row 0 of microbatch 1 starts
    with a pad, so its first query has no visible key."""
    rng = np.random.RandomState(3)
    toks = rng.randint(4, KW["vocab_size"], size=(MB, B, T)).astype(np.int32)
    toks[0, 1, 5:8] = 1
    toks[1, 0, 0] = 1
    toks[1, 1, 20] = 1
    return toks


@functools.lru_cache(maxsize=None)
def _jax_run(stacked: bool):
    """JAX params, microbatch-0 loss and grads, and the params after two
    make_train_step updates."""
    cfg = jk.UniGPTConfig(**KW)
    toks = _batch()
    params = jk.UniGPT(cfg).init(jax.random.PRNGKey(0),
                                 jnp.asarray(toks[0]))["params"]
    model = jk.UniGPT(cfg)
    if stacked:
        params = jk.stack_unigpt_params(dict(params), KW["num_layers"])
        model = jk.UniGPT(jk.UniGPTConfig(scan_layers=True, **KW))

    def loss_fn(p, batch, rng):
        out = model.apply({"params": p}, batch, return_features=True)
        s, n = jce.chunked_cross_entropy(
            out[:, :-1], p["embed_tokens"]["embedding"], batch[:, 1:],
            chunk=200)
        return s / n, {"ntok": n}

    (loss0, _), grads0 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(toks[0]), None)
    tx = optax.adamw(joptim.polynomial_decay_schedule(LR, 10, 1), b1=0.9,
                     b2=0.98, weight_decay=0.01)
    state = jtrain.TrainState.create(params, tx)
    step = jax.jit(jtrain.make_train_step(loss_fn, tx, clip_grad_norm=1.0,
                                          microbatches=MB))
    metrics = []
    for i in range(2):
        state, m = step(state, jnp.asarray(toks), jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return (jax.device_get(params), float(loss0), jax.device_get(grads0),
            jax.device_get(state.params), metrics)


def _torch_model(params):
    model = tk.UniGPT(tk.UniGPTConfig(**KW))
    load_flax_params(model, params)
    return model


def _torch_loss(m, batch):
    out = m(batch, return_features=True)
    s, n = tce.chunked_cross_entropy(out[:, :-1], m.embed_tokens.weight,
                                     batch[:, 1:], chunk=200)
    return s / n, {"ntok": n}


@pytest.mark.parametrize("tree", ["looped", "stacked"])
def test_train_step_matches_jax(tree):
    params, loss0, grads0, params2, jmetrics = _jax_run(tree == "stacked")
    toks = torch.from_numpy(_batch()).long()

    # loss and every gradient of one microbatch
    model = _torch_model(params)
    loss, _ = _torch_loss(model, toks[0])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss0, rtol=1e-5)
    want = flax_to_state_dict(grads0)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   atol=1e-5, err_msg=name)

    # two updates: 2 microbatches, clip 1.0, polynomial-decay AdamW
    model = _torch_model(params)
    tx = toptim.AdamW(toptim.polynomial_decay_schedule(LR, 10, 1), b1=0.9,
                      b2=0.98, weight_decay=0.01)
    state = ttrain.TrainState.create(model, tx)
    step = ttrain.make_train_step(_torch_loss, tx, clip_grad_norm=1.0,
                                  microbatches=MB)
    for i in range(2):
        state, m = step(state, toks)
        for k in ("loss", "grad_norm", "ntok"):
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k],
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    assert state.step == 2
    want = flax_to_state_dict(params2)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_remat_gives_equal_gradients():
    params = _jax_run(False)[0]
    toks = torch.from_numpy(_batch()[1]).long()
    grads = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        model = tk.UniGPT(tk.UniGPTConfig(remat=remat, remat_policy=policy,
                                          **KW))
        load_flax_params(model, params)
        _torch_loss(model, toks)[0].backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
        torch.testing.assert_close(grads[2][name], grads[0][name],
                                   atol=1e-6, rtol=0, msg=name)


def _docs(n=40):
    rng = np.random.RandomState(0)
    docs = [rng.randint(4, 500, size=rng.randint(5, 60)) for _ in range(n)]
    docs[3][:3] = 1  # pad tokens: masked keys
    return docs


@pytest.mark.parametrize("source", ["mmap", "text"])
def test_data_stream_matches_unilm_tpu_data(tmp_path, source):
    """The port's corpus format, dictionary and CLI stream against
    unilm_tpu.data's: the same bytes on disk, and the same batches, bit for
    bit, straight and after a resume from a JSON round-tripped state."""
    import json

    from unilm_tpu.cli import train_gpt as jcli
    from unilm_tpu.data import dictionary as jdict
    from unilm_tpu.data import indexed_dataset as jds
    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.data import dictionary as tdict
    from unilm_tpu_torch.data import indexed_dataset as tds

    docs = _docs()
    argv = ["--tokens_per_sample", "32", "--batch_size", "3", "--seed", "5"]
    if source == "mmap":
        jds.build_indexed_dataset(str(tmp_path / "j"), docs)
        tds.build_indexed_dataset(str(tmp_path / "t"), docs)
        for ext in (".bin", ".idx"):
            assert ((tmp_path / ("j" + ext)).read_bytes()
                    == (tmp_path / ("t" + ext)).read_bytes())
        jread = jds.MMapIndexedDataset(str(tmp_path / "t"))
        tread = tds.MMapIndexedDataset(str(tmp_path / "j"))
        assert len(jread) == len(tread) == len(docs)
        for i in range(len(docs)):
            assert np.array_equal(jread[i], tread[i])
        argv += ["--data", str(tmp_path / "j")]
        jd, td = jdict.Dictionary(), tdict.Dictionary()
    else:
        words = [f"w{i}" for i in range(30)]
        (tmp_path / "dict.txt").write_text(
            "".join(f"{w} {100 - i}\n" for i, w in enumerate(words)))
        (tmp_path / "corpus.txt").write_text("".join(
            " ".join(words[t % 33] if t % 33 < 30 else "oov" for t in d)
            + "\n\n" for d in docs))
        argv += ["--data", str(tmp_path / "corpus.txt")]
        jd = jdict.Dictionary.load(str(tmp_path / "dict.txt"))
        td = tdict.Dictionary.load(str(tmp_path / "dict.txt"))
        assert jd.symbols == td.symbols and jd.eos() == td.eos()
    args = train_gpt.build_parser().parse_args(argv)
    jstream, tstream = jcli.build_stream(args, jd), train_gpt.build_stream(
        args, td)
    state = None
    for i in range(12):  # wraps the permutation more than once
        if i == 5:
            state = json.loads(json.dumps(tstream.getstate()))
            assert state == json.loads(json.dumps(jstream.getstate()))
        a, b = next(jstream), next(tstream)
        assert all(np.array_equal(x, y) and y.dtype == np.int32
                   for x, y in zip(a, b)), i
    resumed = train_gpt.build_stream(args, td)
    resumed.setstate(state)
    jstream = jcli.build_stream(args, jd)
    jstream.setstate(state)
    for i in range(7):
        a, b = next(jstream), next(resumed)
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), i


def test_cli_resume_is_bitwise(tmp_path):
    """4 steps straight equal 2 steps + save + resume + 2 steps: params,
    optimizer state and the logged losses, bit for bit."""
    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset

    build_indexed_dataset(str(tmp_path / "data"), _docs())
    base = ["--data", str(tmp_path / "data"), "--dim", "64", "--layers", "2",
            "--heads", "4", "--ffn", "128", "--vocab", "512",
            "--tokens_per_sample", "32", "--batch_size", "4",
            "--update_freq", "2", "--fused_ce", "--ce_chunk", "200",
            "--warmup", "1", "--lr", "1e-3", "--save_every", "2",
            "--device", "cpu"]
    train_gpt.main(base + ["--save_dir", str(tmp_path / "a"),
                           "--max_steps", "4"])
    train_gpt.main(base + ["--save_dir", str(tmp_path / "b"),
                           "--max_steps", "2"])
    train_gpt.main(base + ["--save_dir", str(tmp_path / "b"),
                           "--max_steps", "4"])
    from unilm_tpu_torch.runtime.checkpoint import CheckpointManager

    sa, da, ma = CheckpointManager(str(tmp_path / "a")).restore(4)
    sb, db, mb = CheckpointManager(str(tmp_path / "b")).restore(4)
    assert sa["step"] == sb["step"] == 4 and da == db and ma == mb
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    for a, b in zip(sa["opt_state"]["mu"] + sa["opt_state"]["nu"],
                    sb["opt_state"]["mu"] + sb["opt_state"]["nu"]):
        assert torch.equal(a, b)
    # a partial save (no state.pt) is skipped
    (tmp_path / "b" / "step_6").mkdir()
    (tmp_path / "b" / "step_6" / "extra.json").write_text("{}")
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 4


def test_train_cli_refuses_unported_paths(tmp_path):
    """What the JAX CLI refuses (it asserts): --pp_stages takes text
    pretraining with dense layers only."""
    from unilm_tpu_torch.cli import train_gpt

    for flags in (["--data", "x", "--pp_stages", "2", "--moe_freq", "2",
                   "--moe_experts", "2"],
                  ["--vl_data", "x*.jsonl", "--pp_stages", "2"]):
        args = train_gpt.build_parser().parse_args(flags + ["--device",
                                                            "cpu"])
        with pytest.raises(ValueError, match="--pp_stages"):
            train_gpt.build_trainer(args)


def test_train_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                             monkeypatch):
    """--device defaults to cuda: with CUDA hidden the default raises, and
    --device cpu trains."""
    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset

    build_indexed_dataset(str(tmp_path / "data"), _docs(8))
    base = ["--data", str(tmp_path / "data"), "--dim", "32", "--layers", "1",
            "--heads", "2", "--ffn", "64", "--vocab", "512",
            "--tokens_per_sample", "16", "--batch_size", "2",
            "--max_steps", "1", "--save_dir", str(tmp_path / "ckpt")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_gpt.build_parser().parse_args(base).device == "cuda"
    with pytest.raises(RuntimeError, match="device cpu"):
        train_gpt.main(base)
    train_gpt.main(base + ["--device", "cpu"])
    from unilm_tpu_torch.runtime.checkpoint import CheckpointManager

    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 1


@pytest.mark.parametrize("n", [6, 7, 8])
def test_fixed_batch_iterator_matches_jax(n):
    """Batches of 3 from a finite source of n items: the port's stream is
    unilm_tpu.data.iterators.FixedBatchIterator's with drop_last=True (a
    short last batch is dropped, then the stream stops), the one behaviour
    the port's training CLIs use; JAX's default would yield the short
    batch too."""
    from unilm_tpu.data import iterators as jit_
    from unilm_tpu_torch.data import iterators as tit

    def drain(stream):
        out = []
        while True:
            try:
                out.append(next(stream))
            except StopIteration:
                return out

    want = drain(jit_.FixedBatchIterator(
        jit_.NativeCheckpointableIterator(list(range(n))), 3, drop_last=True))
    got = drain(tit.FixedBatchIterator(iter(range(n)), 3))
    assert got == want == [list(range(i, i + 3)) for i in range(0, n - 2, 3)]
