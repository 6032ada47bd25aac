"""Port parity for the X-MoE slice: unilm_tpu_torch.core.moe, the stacks'
MoE layers, `apply_with_moe_aux`, the train CLI's MoE step and the serving
stack's MoE layers against unilm_tpu on the CPU, and the decoder's
drop-path.

Inputs come from numpy seeds, parameters from the JAX init (through
convert/from_jax.py); JAX runs at matmul precision 'highest'
(tests/conftest.py), torch in float32. Tolerances: outputs, the GShard
loss and the overflow 1e-5 relative (+1e-6 absolute); gradients 1e-4;
routing masks (dispatch) equal. The random second-expert policy is fed
JAX's own uniform draw (recorded from `jax.random.uniform`); drop-path
is fed JAX's keep flags (recorded from `jax.random.bernoulli`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.core import moe as jmoe
from unilm_tpu.core import transformer as jtr
from unilm_tpu.core.config import TransformerConfig as JCfg
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict
from unilm_tpu_torch.core import moe as tmoe
from unilm_tpu_torch.core import transformer as ttr
from unilm_tpu_torch.core.config import TransformerConfig as TCfg
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(1)

BASE = dict(embed_dim=32, ffn_dim=48, num_heads=4, num_layers=4,
            use_flash=False)


def _cfgs(**kw):
    return JCfg(**{**BASE, **kw}), TCfg(**{**BASE, **kw})


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


class _Recorder:
    """Wraps a jax.random function and keeps every array it returns (under
    jit, the traced values: the jitted function returns them)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.calls.append(out)
        return out


def _replay(monkeypatch, draws):
    """Make the port's routing uniform return JAX's draws in order."""
    it = iter(draws)
    monkeypatch.setattr(tmoe, "draw_uniform",
                        lambda shape, rng, device: torch.from_numpy(next(it)))


# name -> (config kwargs, deterministic)
LAYER_CASES = {
    "top2_eval": (dict(moe_experts=4), True),
    "top2_train_random": (dict(moe_experts=4), False),
    "top1_eval": (dict(moe_experts=4, moe_top=1), True),
    "top1_train": (dict(moe_experts=4, moe_top=1), False),
    "gate_dim8_eval": (dict(moe_experts=4, moe_gate_dim=8), True),
    "gate_dim8_train": (dict(moe_experts=4, moe_gate_dim=8), False),
    "clipped_train": (dict(moe_experts=4, moe_capacity_factor=0.25), False),
    "second_all_train": (dict(moe_experts=4,
                              moe_second_expert_policy="all"), False),
    "swiglu_subln_eval": (dict(moe_experts=3, activation="swiglu",
                               subln=True), True),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(name, monkeypatch):
    kw, det = LAYER_CASES[name]
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 64, 32).astype(np.float32)
    layer = jmoe.MoELayer(jcfg)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    rec = _Recorder(jax.random.uniform)
    monkeypatch.setattr(jax.random, "uniform", rec)

    g = rng.randn(*x.shape).astype(np.float32)

    def jf(p, x):
        (out, aux), mut = layer.apply(
            {"params": p}, x, deterministic=det, mutable=["moe_metrics"],
            rngs=None if det else {"dropout": jax.random.PRNGKey(5)})
        return jnp.sum(out * g) + aux, (out, aux, mut, tuple(rec.calls))

    (_, (jout, jaux, mut, draws)), jgrad = jax.jit(
        jax.value_and_grad(jf, has_aux=True))(params, jnp.asarray(x))
    monkeypatch.undo()
    rec.calls = [np.asarray(d) for d in draws]
    joverflow = float(jax.tree.leaves(mut)[0])
    random_policy = not det and jcfg.moe_second_expert_policy == "random" \
        and jcfg.moe_top == 2
    assert len(rec.calls) == int(random_policy)
    _replay(monkeypatch, rec.calls)

    m = tmoe.MoELayer(tcfg)
    m.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tx = torch.from_numpy(x)
    out = m(tx, None if det else torch.Generator().manual_seed(0))
    ((out * torch.from_numpy(g)).sum() + m.moe_aux).backward()
    _close(out.detach(), jout, msg="out")
    _close(float(m.moe_aux), float(jaux), msg="aux")
    _close(float(m.moe_overflow), joverflow, msg="overflow")
    if name == "clipped_train":
        assert joverflow > 0.05
    _grads_close(m, jgrad)


def _grads_close(model, jgrad):
    """Every gradient within 1e-4 relative, and absolute within 1e-5 or
    1e-6 of the tensor's largest magnitude, the larger (fp32 sums over
    all tokens, in another order, cancel there; a k_proj bias's exact
    gradient is 0)."""
    want = flax_to_state_dict(jax.device_get(jgrad))
    for n, p in model.named_parameters():
        w = want[n].numpy()
        _close(p.grad, w, rtol=1e-4, atol=max(1e-5, 1e-6 * np.abs(w).max()),
               msg=n)


@pytest.mark.parametrize("top2,cap,with_uniform", [
    (True, 8, True), (True, 16, False), (False, 8, False)])
def test_gating_routes_as_jax(top2, cap, with_uniform):
    """`top2_gating` on the same logits: dispatch (the routing masks)
    equal, combine, the GShard loss and the overflow within 1e-6; ties in
    the logits take the first expert in both."""
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 40, 5).astype(np.float32)
    logits[0, :6] = 0.0  # exact ties: the first index wins
    u = rng.rand(2, 40).astype(np.float32) if with_uniform else None
    key = jax.random.PRNGKey(0)
    if with_uniform:
        real = jax.random.uniform
        try:
            jax.random.uniform = lambda *a, **k: jnp.asarray(u)
            jc, jd, ja, jo = jmoe._top2_gating(jnp.asarray(logits), cap, top2,
                                               key, "random")
        finally:
            jax.random.uniform = real
    else:
        jc, jd, ja, jo = jmoe._top2_gating(jnp.asarray(logits), cap, top2,
                                           None, "random")
    tc, td, ta, to = tmoe.top2_gating(
        torch.from_numpy(logits), cap, top2,
        None if u is None else torch.from_numpy(u))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    _close(tc, jc, atol=1e-7)
    _close(float(ta), float(ja))
    _close(float(to), float(jo))


@pytest.mark.parametrize("top2", [False, True])
def test_gating_replays_a_given_choice(top2):
    """`top2_gating(choice=)` routes to the given experts with its own
    gates: its own `expert_choice` gives the default output bit for bit,
    and another forward's choice moves exactly the tokens whose experts
    differ, every gate still a softmax value of these logits."""
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(2, 16, 4).astype(np.float32))
    other = logits + torch.from_numpy(
        1.5 * rng.randn(2, 16, 4).astype(np.float32))
    cap = 16  # no drops: every token keeps its experts
    want = tmoe.top2_gating(logits, cap, top2, None)
    got = tmoe.top2_gating(logits, cap, top2, None,
                           choice=tmoe.expert_choice(logits, top2))
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    choice = tmoe.expert_choice(other, top2)
    combine, dispatch, _, _ = tmoe.top2_gating(logits, cap, top2, None,
                                               choice=choice)
    experts = dispatch.any(-1)  # [G, S, E]: the experts a token went to
    chosen = torch.zeros_like(experts)
    for idx in choice:
        if idx is not None:
            chosen |= torch.nn.functional.one_hot(idx, 4).bool()
    assert torch.equal(experts, chosen)
    moved = (choice[0] != tmoe.expert_choice(logits, top2)[0])
    assert moved.any() and not moved.all()
    gates = torch.softmax(logits, -1)
    w = combine.sum(-1)  # [G, S, E]: each token's gate at each expert
    if not top2:
        assert torch.equal(w[experts], gates[experts])
    else:  # renormalised over the two chosen experts
        norm = (gates * chosen).sum(-1, keepdim=True)
        torch.testing.assert_close(w, gates * chosen / norm)


def test_capacity_rule_is_jaxs():
    _, tcfg = _cfgs(moe_experts=8)
    for S, det, want in ((2048, False, 256), (2048, True, 512), (1, True, 1),
                         (10, False, 8), (3, True, 3), (100, False, 16)):
        assert tmoe.capacity(tcfg, S, det) == want, (S, det)


def _decoder_params(jcfg, x):
    return jax.device_get(jax.jit(lambda r, x: jtr.Decoder(jcfg).init(
        r, x, causal=True))(jax.random.PRNGKey(2), jnp.asarray(x))["params"])


@pytest.mark.parametrize("det", [True, False])
def test_decoder_with_moe_layers_matches_jax(det, monkeypatch):
    """A 4-layer decoder with moe_freq=2 (layers 1 and 3 are MoE): the
    output, and through apply_with_moe_aux the summed GShard loss and the
    mean overflow, deterministic and with the random policy."""
    jcfg, tcfg = _cfgs(moe_freq=2, moe_experts=4, subln=True,
                       xpos_rel_pos=True)
    x = np.random.RandomState(1).randn(2, 24, 32).astype(np.float32)
    params = _decoder_params(jcfg, x)
    rec = _Recorder(jax.random.uniform)
    monkeypatch.setattr(jax.random, "uniform", rec)

    @jax.jit
    def jf(p, x):
        out = jtrain.apply_with_moe_aux(
            jtr.Decoder(jcfg), {"params": p}, x, causal=True,
            deterministic=det,
            rngs=None if det else {"dropout": jax.random.PRNGKey(3)})
        return out, tuple(rec.calls)

    (jout, jaux, jstats), draws = jf(params, jnp.asarray(x))
    monkeypatch.undo()
    rec.calls = [np.asarray(d) for d in draws]
    assert len(rec.calls) == (0 if det else 2)
    _replay(monkeypatch, rec.calls)
    dec = ttr.Decoder(tcfg)
    dec.load_state_dict(flax_to_state_dict(params))
    assert isinstance(dec.layers[1].moe, tmoe.MoELayer)
    assert not hasattr(dec.layers[0], "moe")
    dec.train(not det)
    out, aux, stats = ttrain.apply_with_moe_aux(
        dec, torch.from_numpy(x),
        generator=None if det else torch.Generator().manual_seed(0))
    _close(out.detach(), jout, rtol=1e-5, atol=1e-5, msg="out")
    _close(float(aux), float(jaux), msg="aux")
    _close(float(stats["moe_overflow"]), float(jstats["moe_overflow"]))


def test_apply_with_moe_aux_without_moe_layers():
    _, tcfg = _cfgs(num_layers=1)
    dec = ttr.Decoder(tcfg)
    out, aux, stats = ttrain.apply_with_moe_aux(dec, torch.zeros(1, 4, 32))
    assert float(aux) == 0.0 and stats == {} and out.shape == (1, 4, 32)


def test_decoder_drop_path_matches_jax(monkeypatch):
    """The decoder's drop-path (one rate a layer, linspace(0, rate, L)) on
    its two branches with JAX's keep flags: output and gradients; the
    flags are drawn once a forward, so remat recomputes the same."""
    jcfg, tcfg = _cfgs(drop_path_rate=0.4, subln=True)
    x = np.random.RandomState(5).randn(3, 16, 32).astype(np.float32)
    params = _decoder_params(jcfg, x)
    rec = _Recorder(jax.random.bernoulli)
    monkeypatch.setattr(jax.random, "bernoulli", rec)

    g = np.random.RandomState(6).randn(*x.shape).astype(np.float32)

    def jf(p):
        y = jtr.Decoder(jcfg).apply(
            {"params": p}, jnp.asarray(x), causal=True, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(y * g), (y, tuple(rec.calls))

    (_, (jy, draws)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        params)
    monkeypatch.undo()
    rec.calls = [np.asarray(d) for d in draws]
    L, B = BASE["num_layers"], x.shape[0]
    assert len(rec.calls) == 2 * (L - 1)  # layer 0's rate is 0
    flags = np.ones((L, 2, B), bool)
    flags[1:] = np.stack(rec.calls).reshape(L - 1, 2, B)
    assert not flags.all()
    for remat in (False, True):
        dec = ttr.Decoder(dataclasses.replace(tcfg, remat=remat)).train()
        dec.load_state_dict(flax_to_state_dict(params))
        y = dec(torch.from_numpy(x),
                drop_path_keep=torch.from_numpy(flags))
        (y * torch.from_numpy(g)).sum().backward()
        _close(y.detach(), jy, atol=1e-5, msg=f"remat={remat}")
        _grads_close(dec, jg)
    # drawn from the forward's generator: [L, 2, B], layer 0 keeps all
    dec = ttr.Decoder(tcfg).train()
    got = dec.draw_drop_path(B, torch.Generator().manual_seed(0))
    assert got.shape == (L, 2, B) and bool(got[0].all())
    with pytest.raises(ValueError, match="keep flags"):
        dec(torch.from_numpy(x))


def test_multiway_moe_layer_is_not_split():
    """A multiway encoder layer that is an MoE layer has one `moe`, no
    ffn_A / ffn_B (JAX :123); the others keep the pair."""
    _, tcfg = _cfgs(multiway=True, moe_freq=2, moe_experts=2)
    enc = ttr.Encoder(tcfg)
    assert hasattr(enc.layers[1], "moe") and not hasattr(enc.layers[1],
                                                         "ffn_A")
    assert hasattr(enc.layers[0], "ffn_A") and not hasattr(enc.layers[0],
                                                           "moe")
    jcfg, _ = _cfgs(multiway=True, moe_freq=2, moe_experts=2)
    x = np.random.RandomState(6).randn(2, 8, 32).astype(np.float32)
    jp = jax.device_get(jax.jit(jtr.Encoder(jcfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    enc.load_state_dict(flax_to_state_dict(jp))
    jy, jaux, _ = jax.jit(lambda p, x: jtrain.apply_with_moe_aux(
        jtr.Encoder(jcfg), {"params": p}, x))(jp, jnp.asarray(x))
    y, aux, _ = ttrain.apply_with_moe_aux(enc, torch.from_numpy(x))
    _close(y.detach(), jy, atol=1e-5)
    _close(float(aux), float(jaux))


def test_train_gpt_moe_step_matches_jax(tmp_path):
    """One `cli/train_gpt.py` MoE step (--moe_freq 2 --moe_experts 4,
    fused CE, 2 microbatches) against JAX's loss of the CLI: the same
    initial weights, the loss with the gate loss (wt 0.01) and
    moe_overflow in the metrics."""
    from unilm_tpu.models import kosmos as jk
    from unilm_tpu.ops import fused_ce as jce
    from unilm_tpu_torch.cli import train_gpt
    from unilm_tpu_torch.convert.from_jax import load_flax_params
    from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset

    rng = np.random.RandomState(0)
    docs = [rng.randint(4, 300, size=rng.randint(8, 40)).tolist()
            for _ in range(30)]
    build_indexed_dataset(str(tmp_path / "data"), docs)
    args = train_gpt.build_parser().parse_args(
        ["--data", str(tmp_path / "data"), "--dim", "32", "--layers", "2",
         "--heads", "2", "--ffn", "64", "--vocab", "300",
         "--tokens_per_sample", "16", "--batch_size", "4", "--update_freq",
         "2", "--fused_ce", "--ce_chunk", "128", "--moe_freq", "2",
         "--moe_experts", "4", "--device", "cpu"])
    args.bf16 = False  # float32 on both sides
    tr = train_gpt.build_trainer(args)
    batch = tr.next_batch()
    cfg = jk.UniGPTConfig(
        vocab_size=300, embed_dim=32, num_layers=2, num_heads=2, ffn_dim=64,
        max_positions=18, subln=True, xpos_rel_pos=True, moe_freq=2,
        moe_experts=4)
    toks = batch.numpy().astype(np.int32)
    params = jax.device_get(jax.jit(jk.UniGPT(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(toks[0]))["params"])
    load_flax_params(tr.model, params)
    model = jk.UniGPT(cfg)

    def loss_fn(p, b):
        out, aux, st = jtrain.apply_with_moe_aux(
            model, {"params": p}, b, return_features=True)
        s, n = jce.chunked_cross_entropy(
            out[:, :-1], p["embed_tokens"]["embedding"], b[:, 1:], chunk=128)
        return s / n + 0.01 * aux, st

    jloss = jax.jit(loss_fn)
    want = [jloss(params, jnp.asarray(t)) for t in toks]
    _, m = tr.step_fn(tr.state, batch)
    _close(float(m["loss"]), np.mean([float(w[0]) for w in want]))
    _close(float(m["moe_overflow"]),
           np.mean([float(w[1]["moe_overflow"]) for w in want]))
    assert tr.state.step == 1


def test_serving_stack_with_moe_layers_gives_jaxs_tokens():
    """The serving engines with moe_freq=2 give JAX's greedy streams, in
    the model dtype and with int8 weights. Under int8 the port keeps the
    experts and the router in full precision; the JAX engine's
    `quantize_dense_tree` takes the experts' 3-D kernels for scanned
    stacks and its MoE model then finds no `kernel` (a fault of the
    reference, pinned here), so the JAX side is the same engine on a tree
    quantized without the experts, the port's rule."""
    import flax
    from unilm_tpu.models import kosmos as jk
    from unilm_tpu.ops.quant import quantize_dense_tree
    from unilm_tpu.runtime import serving as js
    from unilm_tpu_torch.models import kosmos as tk
    from unilm_tpu_torch.ops.quant import is_decoder_projection
    from unilm_tpu_torch.runtime import serving as ts

    kw = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
              ffn_dim=48, max_positions=128, use_flash=False,
              image_tower=None, subln=True, xpos_rel_pos=True, moe_freq=2,
              moe_experts=4)
    jcfg, tcfg = jk.UniGPTConfig(**kw), tk.UniGPTConfig(**kw)
    params = jax.device_get(jax.jit(jk.UniGPT(jcfg).init)(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"])
    skw = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=8,
               max_new_tokens=6, eos=63, prefill_bucket=8)
    prompts = [("a", [5, 9, 11]), ("b", [7, 3, 3, 8, 12, 4, 30])]

    def run(eng):
        for rid, p in prompts:
            eng.submit(rid, p)
        return {k: list(map(int, v)) for k, v in eng.run().items()}

    got = run(ts.ServingEngine(tcfg, ts.ServingConfig(**skw), params,
                               device="cpu"))
    assert got == run(js.ServingEngine(jcfg, js.ServingConfig(**skw),
                                       params))
    with pytest.raises(flax.errors.ScopeParamNotFoundError):
        run(js.ServingEngine(jcfg, js.ServingConfig(
            **skw, weight_dtype="int8"), params))
    teng = ts.ServingEngine(tcfg, ts.ServingConfig(**skw,
                                                   weight_dtype="int8"),
                            params, device="cpu")
    jq = quantize_dense_tree(params, predicate=lambda p: (
        p[-2] in {"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2",
                  "fc3"} and "experts" not in p
        and any(s.startswith("layers") for s in p)))
    jeng = js.ServingEngine(dataclasses.replace(jcfg, quant_weights=True),
                            js.ServingConfig(**skw), jq)
    assert run(teng) == run(jeng)
    sd = teng.model.state_dict()
    assert sd["decoder.layers.1.moe.experts.fc1.weight"].dtype == \
        torch.float32
    assert sd["decoder.layers.1.moe.gate.weight"].dtype == torch.float32
    assert "decoder.layers.0.ffn.fc1.weight_i8" in sd
    assert not is_decoder_projection(
        ("decoder", "layers_1", "moe", "experts", "fc1", "kernel"))
