"""Port parity for the search strategies of runtime/generate.py (beam,
diverse siblings, length-constrained beam, diverse beam, ensembling,
sampling) against unilm_tpu on the CPU.

The scenarios of tests/test_generate.py and tests/test_search_strategies.py
(all but the constrained and GAD ones, which tests/test_torch_search.py
holds) run through both packages on the
same scripted probability tables (logits given by the previous token and
the step), and through a tiny fp32 Kosmos-2.5 text decoder on both
stacks. Tolerances: token streams identical; scores within 1e-5
(relative); the kept sampling support equal as a set of ids.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.ops import quant as jq
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.ops import quant as tq
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

V = 6  # 0 = bos, 1 = pad, 2 = eos, 3..5 real tokens
PAD, EOS = 1, 2
SCORE_RTOL = 1e-5


def jax_scripted(table):
    table = jnp.asarray(table, jnp.float32)

    def prefill(params, tokens, aux):
        P = tokens.shape[1]
        return (table[tokens[:, -1], P - 1][:, None, :],
                {"step": jnp.asarray(P, jnp.int32)})

    def step(params, tokens, cache, aux):
        s = cache["step"]
        B, T = tokens.shape
        steps = jnp.broadcast_to((s + jnp.arange(T))[None], (B, T))
        return table[tokens, steps], {"step": s + T}

    return prefill, step


def torch_scripted(table):
    table = torch.tensor(np.asarray(table, np.float32))

    def prefill(tokens, aux):
        P = tokens.shape[1]
        return table[tokens[:, -1], P - 1][:, None, :], {"step": P}

    def step(tokens, cache, aux):
        s = cache["step"]
        B, T = tokens.shape
        steps = (s + torch.arange(T))[None].expand(B, T)
        return table[tokens, steps], {"step": s + T}

    return prefill, step


def _table(seed, scale=1.0, shape=(V, 12, V)):
    table = np.random.RandomState(seed).randn(*shape) * scale
    table[..., PAD] = -100.0
    return table


def _exhaustive_table(seed):
    """tests/test_generate.py's exact-beam table: alive branching only
    through tokens 3 and 4."""
    table = np.random.RandomState(seed).randn(V, 8, V) * 2.0
    table[:, :, [PAD, 0, 5]] = -100.0
    return table


def _path_table(kind):
    table = np.full((V, 8, V), -10.0, np.float32)
    if kind == "argmax":  # bos -> 3 -> 4 -> 5 -> eos
        table[0, 0, 3] = table[3, 1, 4] = table[4, 2, 5] = 0
        table[5, 3, EOS] = 0
    elif kind == "min_len":  # the model always wants eos
        table[:, :, EOS] = 5.0
        table[:, :, 3] = 0.0
    else:  # "ngram": 3, 4, 3, 4, ... unless 2-grams are blocked
        table[0, :, 3] = table[3, :, 4] = table[4, :, 3] = 1.0
        table[4, :, 5] = 0.5
    return table


def _scenarios():
    """name -> (search, tables, GenerationConfig kwargs, batch, extra)."""
    base = dict(vocab_size=V, pad=PAD, eos=EOS)
    out = {}
    for seed in (0, 1, 2):
        for lp in (1.0, 0.0, 2.0):
            out[f"beam_exhaustive_s{seed}_lp{lp}"] = (
                "beam", [_exhaustive_table(seed)],
                dict(beam_size=8, max_new_tokens=3, len_penalty=lp, **base),
                1, {})
    out["greedy_argmax"] = ("greedy", [_path_table("argmax")],
                            dict(beam_size=1, max_new_tokens=6, **base), 1, {})
    out["greedy_min_len"] = ("greedy", [_path_table("min_len")],
                             dict(beam_size=1, max_new_tokens=4,
                                  min_new_tokens=3, **base), 1, {})
    out["greedy_ngram"] = ("greedy", [_path_table("ngram")],
                           dict(beam_size=1, max_new_tokens=5,
                                no_repeat_ngram_size=2, **base), 1, {})
    b3 = dict(beam_size=3, max_new_tokens=4, **base)
    out["beam_batch1"] = ("beam", [_table(0, 2.0, (V, 8, V))], b3, 1, {})
    out["beam_batch3"] = ("beam", [_table(0, 2.0, (V, 8, V))], b3, 3, {})
    t = _table(0)
    t[0, 0, 4] += 8.0
    d = dict(min_new_tokens=0, **base)
    out["diverse_groups_disagree"] = (
        "diverse", [t], dict(beam_size=3, max_new_tokens=3, num_groups=3,
                             diversity_strength=1000.0, **d), 1, {})
    out["diverse_single_group"] = (
        "diverse", [_table(4)], dict(beam_size=4, max_new_tokens=4,
                                     num_groups=1, diversity_strength=0.7,
                                     **d), 1, {})
    out["diverse_zero_strength"] = (
        "diverse", [_table(5)], dict(beam_size=4, max_new_tokens=4,
                                     num_groups=2, diversity_strength=0.0,
                                     **d), 1, {})
    out["generate_dispatch_diverse"] = (
        "generate", [_table(6)], dict(beam_size=4, max_new_tokens=3,
                                      num_groups=2, **d), 1, {})
    out["diverse_batch2"] = (
        "diverse", [_table(7, 1.5)], dict(beam_size=4, max_new_tokens=5,
                                          num_groups=2, **d), 2, {})
    for seed, rate in ((0, 0.8), (1, 0.3), (2, 1.5)):
        out[f"siblings_s{seed}_r{rate}"] = (
            "beam", [_table(seed, 1.5)], dict(beam_size=3, max_new_tokens=4,
                                              diversity_rate=rate, **d), 1, {})
    out["siblings_zero_rate"] = ("beam", [_table(3)], dict(
        beam_size=4, max_new_tokens=4, diversity_rate=0.0, **d), 1, {})
    t = _table(9)
    t[:, :, EOS] = -50
    out["siblings_huge_rate"] = ("beam", [t], dict(
        beam_size=3, max_new_tokens=4, diversity_rate=1e4, **d), 1, {})
    t2 = _table(11, 1.5, (2, V, 12, V))
    for b, (mn, mx) in enumerate(((2, 3), (1, 4))):
        out[f"length_constrained_{b}"] = ("beam", [t2[b]], dict(
            beam_size=16, max_new_tokens=6, **d), 1,
            dict(min_lens=[mn], max_lens=[mx]))
    t = _table(12)
    t[:, :, EOS] = -40
    out["length_per_sentence"] = ("beam", [t], dict(
        beam_size=3, max_new_tokens=8, **d), 2,
        dict(min_lens=[2, 5], max_lens=[2, 5]))
    out["ensemble_two"] = ("beam", [_table(13, 1.5), _table(113, 1.5)], dict(
        beam_size=4, max_new_tokens=5, **d), 2, {})
    out["ensemble_one"] = ("beam", [_table(14)], dict(
        beam_size=3, max_new_tokens=4, **d), 1, {"ensemble": True})
    return out


SCENARIOS = _scenarios()


def _run_scenario(name):
    search, tables, kw, B, extra = SCENARIOS[name]
    extra = dict(extra)
    ens = extra.pop("ensemble", False) or len(tables) > 1
    jfns = [jax_scripted(t) for t in tables]
    tfns = [torch_scripted(t) for t in tables]
    jparams = None
    if ens:  # JAX's ensemble takes an M-tuple of params
        jpf, jst = jgen.make_ensemble(jfns)
        tpf, tst = tgen.make_ensemble(tfns)
        jparams = (None,) * len(tables)
    else:
        (jpf, jst), (tpf, tst) = jfns[0], tfns[0]
    jl = {k: jnp.asarray(v) for k, v in extra.items()}
    tl = {k: torch.tensor(v) for k, v in extra.items()}
    jprompt = jnp.zeros((B, 1), jnp.int32)
    tprompt = torch.zeros((B, 1), dtype=torch.long)
    jfn = {"beam": jgen.beam_generate, "diverse": jgen.diverse_beam_generate,
           "greedy": jgen.greedy_generate, "generate": jgen.generate}[search]
    tfn = {"beam": tgen.beam_generate, "diverse": tgen.diverse_beam_generate,
           "greedy": tgen.greedy_generate, "generate": tgen.generate}[search]
    want = jfn(jgen.GenerationConfig(**kw), jpf, jst, jparams, jprompt, None,
               **jl)
    got = tfn(tgen.GenerationConfig(**kw), tpf, tst, tprompt, None, **tl)
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_search_matches_jax(name):
    (wt, ws), (gt, gs) = _run_scenario(name)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    if gs.dtype == torch.int64:  # greedy: lengths
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    else:
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws),
                                   rtol=SCORE_RTOL, atol=1e-6)


def test_search_scenarios_behave():
    """What the JAX tests assert of these scenarios holds of the port's
    results too (the diverse groups open differently; length bounds are
    respected; greedy paths)."""
    _, (toks, _) = _run_scenario("diverse_groups_disagree")
    assert len({int(t) for t in toks[0, :, 1]}) == 3
    _, (toks, _) = _run_scenario("greedy_argmax")
    assert toks[0, 1:5].tolist() == [3, 4, 5, EOS]
    _, (toks, _) = _run_scenario("greedy_min_len")
    assert toks[0, 1:4].tolist() == [3, 3, EOS]
    _, (toks, _) = _run_scenario("length_per_sentence")
    for b, want in ((0, 2), (1, 5)):
        row = [t for t in toks[b, 0, 1:].tolist() if t != PAD]
        assert row.index(EOS) == want


def test_length_constraints_helper():
    mn, mx = tgen.length_constraints(torch.tensor([10, 20]), 0.5, 1, 2.0, 5)
    jmn, jmx = jgen.length_constraints(jnp.asarray([10, 20]), 0.5, 1, 2.0, 5)
    assert mn.tolist() == [6, 11] == np.asarray(jmn).tolist()
    assert mx.tolist() == [25, 45] == np.asarray(jmx).tolist()


@pytest.mark.parametrize("ties", [False, True])
def test_topk_over_beams_is_a_flat_topk(ties):
    """The two-stage top-k equals one top-k over the flattened cube (and
    JAX's two-stage top-k), ties to the lower flat index."""
    rng = np.random.RandomState(1)
    cube = rng.randn(3, 4, 50).astype(np.float32)
    if ties:
        cube = np.round(cube * 2).astype(np.float32)
    n = 8
    s, b, t = tgen._topk_over_beams(torch.from_numpy(cube), n)
    fs, fi = tgen._top_k(torch.from_numpy(cube).reshape(3, -1), n)
    np.testing.assert_array_equal(s.numpy(), fs.numpy())
    np.testing.assert_array_equal((b * 50 + t).numpy(), fi.numpy())
    js, jb, jt = jgen._topk_over_beams(jnp.asarray(cube), n)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    if not ties:
        ts, ti = torch.topk(torch.from_numpy(cube).reshape(3, -1), n)
        np.testing.assert_array_equal(fi.numpy(), ti.numpy())


def test_gather_beams_returns_fresh_tensors():
    """After a reorder that duplicates a parent, an in-place write to one
    child's leaf leaves its sibling and the parent unchanged; 0-d leaves,
    ints and dataclass fields map through."""
    import dataclasses

    @dataclasses.dataclass
    class State:
        rows: torch.Tensor
        pos: int = 7

    pool = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(6, 4)
    tree = {"pool": pool, "scale": pool.clone(), "n": torch.tensor(5),
            "idx": 3, "extra": (State(pool.clone()),)}
    idx = torch.tensor([[0, 0, 2], [1, 1, 1]])
    out = tgen._gather_beams(tree, idx, batch=2, old_k=3)
    assert out["n"] is tree["n"] and out["idx"] == 3
    assert out["extra"][0].pos == 7
    want = pool[[0, 0, 2, 4, 4, 4]]
    for leaf in (out["pool"], out["scale"], out["extra"][0].rows):
        assert torch.equal(leaf, want)
    out["pool"][0] += 100.0
    out["extra"][0].rows[3] += 100.0
    assert torch.equal(out["pool"][1], pool[0])
    assert torch.equal(out["extra"][0].rows[4], pool[4])
    assert torch.equal(tree["pool"], torch.arange(24.0).reshape(6, 4))
    tiled = tgen._tile_cache(tree, 2)
    assert tiled["pool"].shape == (12, 4) and tiled["n"] is tree["n"]
    assert torch.equal(tiled["pool"][1], pool[0])


def test_cross_leaves_shared_across_beams():
    """An encoder-decoder's cross K/V (5-D leaves under `cross_key` /
    `cross_value`, JAX `_is_shared_cross_leaf`): `_tile_cache` passes them
    through, `_gather_beams` returns the same tensors when the beam count
    holds and gathers them when it changes, as JAX does; a 4-D leaf of
    that name tiles like any other, and the pools are still copied."""
    L, S = 3, 4
    cross = torch.arange(2 * L * S * 2 * 2, dtype=torch.float32).reshape(
        L, 2, S, 2, 2).transpose(0, 1)  # [B=2, L, S, H, D], layer-major
    tree = {"decoder": {"cross_key": cross, "cross_value": cross + 1.0,
                        "kv_pool_key": torch.arange(12.0).reshape(2, 6),
                        "cache_index": 4},
            "looped": {"cross_key": torch.zeros(2, S, 2, 2)}}
    tiled = tgen._tile_cache(tree, 3)
    assert tiled["decoder"]["cross_key"] is cross
    assert tiled["decoder"]["cross_value"] is tree["decoder"]["cross_value"]
    assert tiled["decoder"]["kv_pool_key"].shape == (6, 6)
    assert tiled["looped"]["cross_key"].shape == (6, S, 2, 2)
    idx = torch.tensor([[2, 0, 0], [1, 1, 2]])
    same = tgen._gather_beams(tiled, idx, batch=2, old_k=3)
    assert same["decoder"]["cross_key"] is cross
    assert same["looped"]["cross_key"] is tiled["looped"]["cross_key"]
    pool = tiled["decoder"]["kv_pool_key"]
    assert torch.equal(same["decoder"]["kv_pool_key"],
                       pool[[2, 0, 0, 4, 4, 5]])
    assert same["decoder"]["kv_pool_key"].data_ptr() != pool.data_ptr()
    # fewer beams out than in: the cross leaves (one row a beam) gather too
    beams = {"cross_key": cross.repeat_interleave(3, 0)}
    out = tgen._gather_beams(beams, torch.tensor([[2], [0]]), batch=2,
                             old_k=3)["cross_key"]
    assert torch.equal(out, cross[[0, 1]]) and out.shape == (2, L, S, 2, 2)


# ---- sampling -------------------------------------------------------------

def _jax_support(lp, cfg):
    """The candidates JAX's greedy_generate draws among (its lines
    239-251), as sets of token ids per row."""
    lp = jnp.asarray(lp)
    if cfg.sampling_topk > 0:
        _, idx = jax.lax.top_k(lp, cfg.sampling_topk)
        return [set(r.tolist()) for r in np.asarray(idx)]
    sorted_lp, sort_idx = jax.lax.top_k(lp, lp.shape[-1])
    probs = jnp.exp(sorted_lp)
    keep = jnp.cumsum(probs, axis=-1) - probs < cfg.sampling_topp
    return [set(np.asarray(i)[np.asarray(k)].tolist())
            for i, k in zip(sort_idx, keep)]


def _port_support(lp, cfg):
    vals, ids = tgen.sampling_candidates(torch.from_numpy(np.array(lp)), cfg)
    return [set(i[v > tgen.NEG_INF / 2].tolist()) for i, v in zip(ids, vals)]


@pytest.mark.parametrize("kw", [dict(sampling_topk=1), dict(sampling_topk=5),
                                dict(sampling_topp=0.3),
                                dict(sampling_topp=0.9)],
                         ids=["top1", "top5", "topp0.3", "topp0.9"])
def test_sampling_support_matches_jax(kw):
    """The kept support equals JAX's on random log-probabilities, and every
    token JAX's sampler draws on a scripted model lies in the port's
    support at that step."""
    cfg = tgen.GenerationConfig(sampling=True, **kw)
    x = np.random.RandomState(2).randn(6, 40).astype(np.float32) * 2
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x)))
    assert _port_support(lp, cfg) == _jax_support(lp, cfg)

    table = _table(21, 1.5, (V, 12, V))
    gkw = dict(beam_size=1, max_new_tokens=8, vocab_size=V, pad=PAD, eos=EOS,
               min_new_tokens=8, sampling=True, **kw)
    toks, _ = jgen.greedy_generate(
        jgen.GenerationConfig(**gkw), *jax_scripted(table), None,
        jnp.zeros((4, 1), jnp.int32), rng=jax.random.PRNGKey(3))
    toks = np.array(toks)
    tcfg = tgen.GenerationConfig(**gkw)
    for i in range(1, 9):
        logits = torch.tensor(table[toks[:, i - 1], i - 1], dtype=torch.float32)
        lp = torch.log_softmax(logits, -1)
        lp = tgen._adjust_logprobs(lp, torch.from_numpy(toks).long(), i - 1,
                                   i, tcfg)
        for row, sup in enumerate(_port_support(lp.numpy(), tcfg)):
            assert int(toks[row, i]) in sup, (i, row)


def test_sampling_seeded_and_top1_is_greedy():
    table = _table(22, 1.5, (V, 12, V))
    tpf, tst = torch_scripted(table)
    kw = dict(beam_size=1, max_new_tokens=8, vocab_size=V, pad=PAD, eos=EOS,
              min_new_tokens=8)
    prompt = torch.zeros((5, 1), dtype=torch.long)
    greedy, _ = tgen.generate(tgen.GenerationConfig(**kw), tpf, tst, prompt)
    top1, _ = tgen.generate(tgen.GenerationConfig(sampling=True,
                                                  sampling_topk=1, **kw),
                            tpf, tst, prompt,
                            generator=torch.Generator().manual_seed(4))
    assert torch.equal(top1, greedy)
    cfg = tgen.GenerationConfig(sampling=True, sampling_topp=0.95, **kw)
    runs = [tgen.generate(cfg, tpf, tst, prompt,
                          generator=torch.Generator().manual_seed(s))[0]
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], greedy)


# ---- a tiny Kosmos-2.5 text decoder on both stacks ------------------------

KW = dict(vocab_size=97, embed_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
          max_positions=128, segment_emb=True, use_flash=False,
          image_tower=None)
MODEL_CASES = {
    "beam": (dict(beam_size=3), False, {}),
    "beam_int8": (dict(beam_size=3), True, {}),
    "siblings": (dict(beam_size=3, diversity_rate=0.5), False, {}),
    "diverse": (dict(beam_size=4, num_groups=2, diversity_strength=0.7),
                False, {}),
    "diverse_int8": (dict(beam_size=4, num_groups=2, diversity_strength=0.7),
                     True, {}),
    "length": (dict(beam_size=3), False, dict(min_lens=[3, 2],
                                              max_lens=[4, 5])),
}


@functools.lru_cache(maxsize=None)
def _model_params():
    rng = np.random.RandomState(0)
    prompt = rng.randint(4, KW["vocab_size"], size=(2, 6)).astype(np.int32)
    segs = rng.randint(0, 2, size=(2, 6)).astype(np.int32)
    p_loop = jk.UniGPT(jk.UniGPTConfig(**KW)).init(
        jax.random.PRNGKey(2), jnp.asarray(prompt),
        segment_tokens=jnp.asarray(segs))["params"]
    return (jax.device_get(jk.stack_unigpt_params(dict(p_loop), 2)),
            prompt, segs)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_search_matches_jax(case):
    """Beam, siblings, diverse beam and length-constrained beam over a
    tiny scanned UniGPT (bf16-free fp32; `_int8`: int8 projections, head
    and KV pool): the pools are tiled and gathered every step in both."""
    gkw, int8, lens = MODEL_CASES[case]
    params, prompt, segs = _model_params()
    flags = dict(scan_layers=True)
    if int8:
        flags.update(quant_weights=True, quant_lm_head=True,
                     kv_cache_dtype="int8")
        params = jk.quantize_lm_head(jq.quantize_dense_tree(
            params, predicate=tq.is_decoder_projection))
        params = jax.device_get(params)
    jm = jk.UniGPT(jk.UniGPTConfig(**flags, **KW))
    tm = tk.UniGPT(tk.UniGPTConfig(**flags, **KW)).eval()
    load_flax_params(tm, params)
    cfg = dict(max_new_tokens=6, vocab_size=KW["vocab_size"],
               min_new_tokens=2, **gkw)
    cache = prompt.shape[1] + cfg["max_new_tokens"]
    want = jgen.generate(jgen.GenerationConfig(**cfg),
                         *jk.make_unigpt_generate_fns(jm, cache), params,
                         jnp.asarray(prompt), (None, None, jnp.asarray(segs)),
                         **{k: jnp.asarray(v) for k, v in lens.items()})
    got = tgen.generate(tgen.GenerationConfig(**cfg),
                        *tk.make_unigpt_generate_fns(tm, cache),
                        torch.from_numpy(prompt).long(),
                        (None, None, torch.from_numpy(segs).long()),
                        **{k: torch.tensor(v) for k, v in lens.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=SCORE_RTOL, atol=1e-6)
