"""Port parity for lexically constrained beam search and aggressive
(draft-and-verify) decoding, runtime/generate.py, against unilm_tpu on
the CPU.

The cases of tests/test_search_strategies.py (constrained: the exhaustive
oracle, every hypothesis satisfied, no constraints equal to beam search, a
ragged batch) and of tests/test_generate.py / tests/test_scan_stack.py
(GAD) run the same scripted probability tables, or the same seeded tiny
fp32 models (a scanned Kosmos-2.5 text decoder, TrOCR), through both
packages. Tolerances: tokens, `met` and model-call counts identical;
scores within 1e-5 (relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.models import trocr as jt
from unilm_tpu.ops import quant as jq
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.models import trocr as tt
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


def automaton_progress(seq, flat, starts, count):
    """The ordered-constraint automaton over seq (up to eos)."""
    p = 0
    for t in seq:
        if t == EOS:
            break
        if p < count and t == flat[p]:
            p += 1
        elif p < count:
            s = starts[p]
            p = s + 1 if t == flat[s] else s
    return p


def _flat(phrases):
    flat = [t for ph in phrases for t in ph]
    starts, j = [], 0
    for ph in phrases:
        starts += [j] * len(ph)
        j += len(ph)
    return flat, starts


def oracle_constrained(table, phrases, max_new, len_penalty):
    """The best finished sequence whose automaton reaches the final state
    (eos at any step, scored with its log-prob, or the longest length)."""
    flat, starts = _flat(phrases)
    best = (-1e30, None)
    real = [t for t in range(V) if t not in (PAD, EOS)]

    def logprobs(prev, step):
        x = np.asarray(table, np.float32)[prev, step]
        x = x - x.max()
        return x - np.log(np.exp(x).sum())

    def fin(seq, score, glen):
        nonlocal best
        if automaton_progress(seq, flat, starts, len(flat)) >= len(flat):
            s = score / max(glen, 1.0) ** len_penalty
            if s > best[0]:
                best = (s, seq)

    def rec(prev, step, score, seq):
        if len(seq) == max_new:
            fin(seq, score, len(seq))
            return
        lp = logprobs(prev, step)
        fin(seq + [EOS], score + lp[EOS], len(seq) + 1)
        for tok in real:
            rec(tok, step + 1, score + lp[tok], seq + [tok])

    rec(0, 0, 0.0, [])
    return best


def _jax_constrained(cfg, prefill, step, params, prompt, packed, aux=None):
    """JAX's constrained_beam_generate under one jax.jit (a single XLA
    program instead of one compile per eager op), as numpy."""
    run = jax.jit(lambda p, pr, pk, a: jgen.constrained_beam_generate(
        jgen.GenerationConfig(**cfg), prefill, step, p, pr, *pk, aux=a))
    return [np.asarray(x) for x in run(params, jnp.asarray(prompt, jnp.int32),
                                       tuple(packed), aux)]


def _constrained_both(table, batch_phrases, prompt, **cfg_kw):
    """The constrained search over one scripted table in both packages:
    ((tokens, scores, met) of JAX, then of the port), as numpy."""
    cfg = dict(vocab_size=V, pad=PAD, eos=EOS, **cfg_kw)
    jc = jgen.pack_constraints(batch_phrases, pad=PAD)
    want = _jax_constrained(cfg, *jax_scripted(table), None, prompt, jc)
    tc = tgen.pack_constraints(batch_phrases, pad=PAD)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = tgen.constrained_beam_generate(
        tgen.GenerationConfig(**cfg), *torch_scripted(table),
        torch.tensor(prompt), *tc)
    return want, [x.numpy() for x in got]


def _assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SCORE_RTOL, atol=0)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_constrained_matches_jax_and_the_oracle(seed):
    """Beam 8 over 5 new tokens: the port's beams, scores and `met` equal
    JAX's, and its best is the exhaustive oracle's constrained best."""
    table = _table(seed, 1.5)
    phrases = [[4], [5, 3]] if seed % 2 == 0 else [[3, 3]]
    want, got = _constrained_both(
        table, [phrases], np.zeros((1, 1), np.int64), beam_size=8,
        max_new_tokens=5, len_penalty=1.0, min_new_tokens=0)
    _assert_same(want, got)
    seq = [int(t) for t in got[0][0, 0, 1:] if t != PAD]
    score, oracle = oracle_constrained(table, phrases, 5, 1.0)
    assert bool(got[2][0, 0]) and seq == oracle
    np.testing.assert_allclose(got[1][0, 0], score, rtol=SCORE_RTOL)


def test_constrained_every_hypothesis_satisfies():
    """With the constraint's first token made unlikely, every live
    hypothesis still holds the phrase and says so in `met`, while plain
    beam search's best does not hold it."""
    table = _table(7, 2.0)
    table[:, :, 4] -= 4.0
    phrases = [[4, 5]]
    kw = dict(beam_size=4, max_new_tokens=6, min_new_tokens=0)
    want, got = _constrained_both(table, [phrases],
                                  np.zeros((1, 1), np.int64), **kw)
    _assert_same(want, got)
    flat, starts = _flat(phrases)
    for k in range(4):
        if got[1][0, k] < -1e6:
            continue
        seq = [int(t) for t in got[0][0, k, 1:] if t != PAD]
        assert automaton_progress(seq, flat, starts, 2) == 2, (k, seq)
        assert bool(got[2][0, k])
    beam, _ = tgen.beam_generate(
        tgen.GenerationConfig(vocab_size=V, pad=PAD, eos=EOS, **kw),
        *torch_scripted(table), torch.zeros((1, 1), dtype=torch.int64))
    seq = [int(t) for t in beam[0, 0, 1:] if t != PAD]
    assert automaton_progress(seq, flat, starts, 2) < 2


def test_constrained_without_constraints_is_beam_search():
    """No constraints: the best beam and its score are beam_generate's, in
    both packages."""
    table = _table(3)
    kw = dict(beam_size=4, max_new_tokens=4, min_new_tokens=0)
    want, got = _constrained_both(table, [[]], np.zeros((1, 1), np.int64),
                                  **kw)
    _assert_same(want, got)
    btok, bsc = tgen.beam_generate(
        tgen.GenerationConfig(vocab_size=V, pad=PAD, eos=EOS, **kw),
        *torch_scripted(table), torch.zeros((1, 1), dtype=torch.int64))
    np.testing.assert_array_equal(got[0][0, 0], btok[0, 0].numpy())
    np.testing.assert_allclose(got[1][0, 0], bsc[0, 0].numpy(),
                               rtol=SCORE_RTOL)


@pytest.mark.parametrize("batch_phrases", [
    [[[4]], [[5, 3]]],
    [[[3], [4, 5]], [], [[5, 5, 4]]],
], ids=["two", "ragged"])
def test_constrained_ragged_batch(batch_phrases):
    """Sentences with different constraint counts (one with none) in one
    batch: equal to JAX, each sentence's best satisfies its own phrases
    and scores as that sentence run alone."""
    table = _table(9, 1.5)
    B = len(batch_phrases)
    kw = dict(beam_size=6, max_new_tokens=5, min_new_tokens=0)
    want, got = _constrained_both(table, batch_phrases,
                                  np.zeros((B, 1), np.int64), **kw)
    _assert_same(want, got)
    for b, phrases in enumerate(batch_phrases):
        flat, starts = _flat(phrases)
        seq = [int(t) for t in got[0][b, 0, 1:] if t != PAD]
        assert automaton_progress(seq, flat, starts, len(flat)) == len(flat)
        alone = tgen.constrained_beam_generate(
            tgen.GenerationConfig(vocab_size=V, pad=PAD, eos=EOS, **kw),
            *torch_scripted(table), torch.zeros((1, 1), dtype=torch.int64),
            *tgen.pack_constraints([phrases], pad=PAD))
        np.testing.assert_allclose(got[1][b, 0], alone[1][0, 0].numpy(),
                                   rtol=SCORE_RTOL)


# ---- seeded tiny models ----------------------------------------------------

KW = dict(vocab_size=97, embed_dim=64, num_layers=2, num_heads=2, ffn_dim=128,
          max_positions=128, segment_emb=True, use_flash=False,
          image_tower=None)


def _init(jm, *args, **kwargs):
    """Parameters for the flax module `jm` from a seeded numpy draw, in the
    tree its init gives (traced by eval_shape, never run): 0.1 * N(0, 1),
    plus 1 for the norms' scales."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args,
                            **kwargs)["params"]
    rng = np.random.RandomState(0)

    def leaf(path, s):
        x = 0.1 * rng.randn(*s.shape)
        if getattr(path[-1], "key", None) == "scale":
            x += 1.0
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _kosmos_params():
    rng = np.random.RandomState(0)
    prompt = rng.randint(4, KW["vocab_size"], size=(2, 6)).astype(np.int32)
    segs = rng.randint(0, 2, size=(2, 6)).astype(np.int32)
    p_loop = _init(jk.UniGPT(jk.UniGPTConfig(**KW)), jnp.asarray(prompt),
                   segment_tokens=jnp.asarray(segs))
    return (jax.device_get(jk.stack_unigpt_params(dict(p_loop), 2)),
            prompt, segs)


def _kosmos_pair(int8: bool):
    """(JAX model, port model, params) of the tiny scanned decoder, the
    int8 variant with int8 projections, head and KV pool."""
    params, _, _ = _kosmos_params()
    flags = dict(scan_layers=True)
    if int8:
        flags.update(quant_weights=True, quant_lm_head=True,
                     kv_cache_dtype="int8")
        params = jax.device_get(jk.quantize_lm_head(jq.quantize_dense_tree(
            params, predicate=tq.is_decoder_projection)))
    jm = jk.UniGPT(jk.UniGPTConfig(**flags, **KW))
    tm = tk.UniGPT(tk.UniGPTConfig(**flags, **KW)).eval()
    load_flax_params(tm, params)
    return jm, tm, params


@pytest.mark.parametrize("int8", [False, True], ids=["model_pool",
                                                      "int8_pool"])
def test_constrained_on_a_decoder_matches_jax(int8):
    """Beam 4 at B=2 with two ordered phrases per sentence over the tiny
    Kosmos-2.5 decoder: the pools are tiled and gathered by bank every
    step; tokens, scores and `met` equal JAX's."""
    jm, tm, params = _kosmos_pair(int8)
    _, prompt, segs = _kosmos_params()
    phrases = [[[10, 11], [12]], [[20], [21, 22]]]
    cfg = dict(beam_size=4, max_new_tokens=7, vocab_size=KW["vocab_size"],
               min_new_tokens=2)
    cache = prompt.shape[1] + cfg["max_new_tokens"]
    want = _jax_constrained(cfg, *jk.make_unigpt_generate_fns(jm, cache),
                            params, prompt, jgen.pack_constraints(phrases),
                            aux=(None, None, jnp.asarray(segs)))
    got = tgen.constrained_beam_generate(
        tgen.GenerationConfig(**cfg), *tk.make_unigpt_generate_fns(tm, cache),
        torch.from_numpy(prompt).long(), *tgen.pack_constraints(phrases),
        aux=(None, None, torch.from_numpy(segs).long()))
    _assert_same(want, [x.numpy() for x in got])
    assert got[2].any()


TROCR = dict(img_size=32, patch_size=16, enc_dim=32, enc_layers=2,
             enc_heads=4, enc_ffn=64, distilled=True, vocab_size=100,
             dec_dim=48, dec_layers=2, dec_heads=4, dec_ffn=96,
             max_positions=64, use_flash=False)


def test_constrained_trocr_shares_the_cross_cache():
    """TrOCR beam 5 at B=2 under constraints: equal to JAX's scanned
    model; the port's cross K/V stay one tensor, shared by every beam."""
    jm = jt.TrOCRModel(jt.TrOCRConfig(scan_layers=True, **TROCR))
    rng = np.random.RandomState(0)
    params = _init(jm, jnp.zeros((1, 32, 32, 3)),
                   jnp.zeros((1, 2), jnp.int32))
    tm = tt.TrOCRModel(tt.TrOCRConfig(**TROCR), device="cpu").eval()
    load_flax_params(tm, params)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    phrases = [[[40, 41]], [[50], [60]]]
    cfg = dict(beam_size=5, max_new_tokens=8, pad=1, eos=3, vocab_size=100)
    prompt = np.full((2, 1), 2)
    enc = jax.jit(functools.partial(jm.apply, method=jm.encode))(
        {"params": params}, jnp.asarray(img))
    want = _jax_constrained(cfg, *jt.make_generate_fns(jm, 10), params,
                            prompt, jgen.pack_constraints(phrases), aux=enc)
    tpf, tst = tt.make_generate_fns(tm, 10)
    seen = []

    def step(tokens, cache, aux):
        seen.append(cache["text_decoder"]["decoder"]["cross_key"])
        return tst(tokens, cache, aux)

    with torch.no_grad():
        got = tgen.constrained_beam_generate(
            tgen.GenerationConfig(**cfg), tpf, step, torch.from_numpy(prompt),
            *tgen.pack_constraints(phrases),
            aux=tm.encode(torch.from_numpy(img)))
    _assert_same(want, [x.numpy() for x in got])
    assert len(seen) > 1 and all(t is seen[0] for t in seen)
    assert seen[0].shape[0] == 2  # the sentences', not the beams'


# ---- aggressive decoding ---------------------------------------------------


def test_gad_scripted_matches_jax_and_greedy():
    """An oracle draft with an error every 7th token, block 8, over a
    scripted table whose pad and eos never win: the tokens and the call
    count equal JAX's, the tokens equal greedy's, in fewer calls."""
    VV = 9
    rng = np.random.RandomState(3)
    table = rng.randn(VV, 40, VV).astype(np.float32) * 3
    table[:, :, PAD] = -100
    table[:, :, EOS] = -100
    cfg = dict(beam_size=1, max_new_tokens=24, pad=PAD, eos=EOS,
               vocab_size=VV)

    def draft_fn(accepted, need):
        out, seq = [], list(accepted)
        for i in range(need):
            tok = int(np.argmax(table[seq[-1], len(seq) - 1]))
            if (len(seq) + i) % 7 == 0:
                tok = (tok + 1) % VV
            out.append(tok)
            seq.append(tok)
        return np.asarray(out)

    want, wcalls = jgen.aggressive_generate(
        jgen.GenerationConfig(**cfg), *jax_scripted(table), None,
        jnp.zeros((1, 1), jnp.int32), draft_fn, block_size=8)
    got, calls = tgen.aggressive_generate(
        tgen.GenerationConfig(**cfg), *torch_scripted(table),
        torch.zeros((1, 1), dtype=torch.int64), draft_fn, block_size=8)
    greedy, _ = tgen.greedy_generate(
        tgen.GenerationConfig(**cfg), *torch_scripted(table),
        torch.zeros((1, 1), dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    assert calls == wcalls < 24


@pytest.mark.parametrize("draft", ["corrupted", "bad"])
@pytest.mark.parametrize("int8", [False, True], ids=["model_pool",
                                                      "int8_pool"])
def test_gad_on_a_decoder_matches_jax_and_greedy(int8, draft):
    """GAD over the tiny scanned decoder (block 4, 10 new tokens): each
    verify is a T > 1 decode over the pool (kv_len = start + T) and each
    accept rewinds `cache_index` and `pos`; the tokens and call counts
    equal JAX's, and the tokens the port's greedy output, over model-dtype
    and int8 KV pools, with a draft of greedy's tokens with every 5th
    corrupted and with a draft that is always wrong."""
    jm, tm, params = _kosmos_pair(int8)
    _, prompt, segs = _kosmos_params()
    prompt, segs = prompt[:1], segs[:1]
    cfg = dict(beam_size=1, max_new_tokens=10, vocab_size=KW["vocab_size"],
               min_new_tokens=10, eos=2)
    cache = prompt.shape[1] + cfg["max_new_tokens"] + 4
    tpf, tst = tk.make_unigpt_generate_fns(tm, cache)
    aux_t = (None, None, torch.from_numpy(segs).long())
    greedy, _ = tgen.greedy_generate(tgen.GenerationConfig(**cfg), tpf, tst,
                                     torch.from_numpy(prompt).long(), aux_t)
    ref = greedy[0].tolist()

    def draft_fn(accepted, need):
        if draft == "bad":
            return np.asarray([(int(t) * 7 + 3) % 80 + 3
                               for t in accepted[-need:]], np.int32)
        start = len(accepted)
        return np.asarray([(t + (1 if (start + i) % 5 == 0 else 0)) % 97
                           for i, t in enumerate(ref[start:start + need])])

    want, wcalls = jgen.aggressive_generate(
        jgen.GenerationConfig(**cfg), *jk.make_unigpt_generate_fns(jm, cache),
        params, jnp.asarray(prompt), draft_fn,
        aux=(None, None, jnp.asarray(segs)), block_size=4)
    got, calls = tgen.aggressive_generate(
        tgen.GenerationConfig(**cfg), tpf, tst,
        torch.from_numpy(prompt).long(), draft_fn, aux=aux_t, block_size=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == wcalls
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    if draft == "corrupted":
        assert calls < cfg["max_new_tokens"]


def test_rewind_cache_sets_every_counter():
    """`_rewind_cache` sets the Python-int counters of a dict cache and
    passes the pools and floats through; a dataclass cache (YOCO's, whose
    retention state cannot be rewound) raises."""
    from unilm_tpu_torch.models.yoco import YOCOCache

    pool = torch.zeros(2, 3)
    tree = {"decoder": {"kv_pool_key": pool, "cache_index": 9,
                        "scale": 1.5},
            "step_counter": {"pos": 9}}
    out = tgen._rewind_cache(tree, 4)
    assert out["decoder"]["cache_index"] == 4
    assert out["step_counter"]["pos"] == 4
    assert out["decoder"]["kv_pool_key"] is pool
    assert out["decoder"]["scale"] == 1.5
    with pytest.raises(TypeError, match="YOCOCache"):
        tgen._rewind_cache({"yoco": YOCOCache([pool], pool, pool, pos=9)}, 4)
