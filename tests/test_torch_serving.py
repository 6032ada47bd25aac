"""Port parity: unilm_tpu_torch.runtime.serving against
unilm_tpu.runtime.serving on the CPU, float32, at a tiny size.

The same JAX-initialised UniGPT tree serves both engines (the port takes
it through convert/from_jax.py). Greedy streams must be IDENTICAL and the
engines' `stats` dicts equal, for: contiguous batches with and without
xPos, int8 weights + int8 KV on the scanned stack, prefix caching with
eviction under pool pressure, a chunked long prompt, and speculative
decoding. On the CPU both engines take the scatter + gathered-attention
path. `PagedGPT` logits agree within 1e-4 (fp32 sums in another order
through 2 layers, |logit| < 5) and pools within 1e-5, from a looped and a
stacked tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.runtime import serving as js
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.runtime import serving as ts

torch.set_num_threads(1)

BASE = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
            ffn_dim=48, max_positions=128, use_flash=False, image_tower=None)
SKW = dict(max_batch=2, page_size=8, num_pages=32, max_pages_per_seq=8,
           max_new_tokens=6, eos=63, prefill_bucket=8)


def _cfgs(**kw):
    return jk.UniGPTConfig(**BASE, **kw), tk.UniGPTConfig(**BASE, **kw)


@functools.lru_cache(maxsize=None)
def _params(subln: bool, xpos: bool):
    cfg, _ = _cfgs(subln=subln, xpos_rel_pos=xpos)
    p = jk.UniGPT(cfg).init(jax.random.PRNGKey(0),
                            jnp.ones((1, 4), jnp.int32))["params"]
    return jax.device_get(p)


def _rand_prompts(seed, n, size):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(3, 60, size=size)] for _ in range(n)]


def _run(engine_cls, cfg, scfg, params, batches):
    """Submit each batch of (rid, prompt) and run it to the end; returns
    the outputs and the engine's stats."""
    kw = {"device": "cpu"} if engine_cls is ts.ServingEngine else {}
    eng = engine_cls(cfg, scfg, params, **kw)
    out = {}
    for batch in batches:
        for rid, prompt in batch:
            eng.submit(rid, prompt)
        out.update({k: list(map(int, v)) for k, v in eng.run().items()})
    return out, dict(eng.stats)


# trace name -> (config kwargs, serving kwargs, batches)
TRACES = {
    "contiguous_xpos": (
        dict(xpos_rel_pos=True), {},
        [[("a", [5, 9, 11]), ("b", [7, 3, 3, 8, 12, 4, 30]),
          ("c", [22, 41])]]),
    "contiguous_no_xpos": (
        dict(xpos_rel_pos=False), {},
        [[("a", [5, 9, 11]), ("b", [7, 3, 3, 8, 12, 4, 30]),
          ("c", [22, 41])]]),
    "int8_weights_int8_kv": (
        dict(subln=True, xpos_rel_pos=True, scan_layers=True),
        dict(weight_dtype="int8", kv_dtype="int8", chunk_pages=2),
        [[("a", [5, 9, 11]), ("b", [7, 3, 3, 8, 12, 4, 30, 9, 17, 2])]]),
    "prefix_cache_eviction": (
        dict(), dict(max_batch=1, num_pages=16, max_pages_per_seq=4,
                     max_new_tokens=3),
        [[(f"r{i}", p)] for i, p in enumerate(_rand_prompts(2, 5, 17))]
        + [[("again", _rand_prompts(2, 5, 17)[4][:16] + [8, 9])]]),
    "chunked_long_prompt": (
        dict(), {},
        [[("short", [5, 9, 11]), ("long", _rand_prompts(5, 1, 29)[0])]]),
    "speculative_k4": (
        dict(), dict(spec_k=4, max_new_tokens=10),
        [[("r", [5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9]),
          ("s", [7, 3, 3, 8, 7, 3, 3])]]),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_engine_streams_match_jax(trace):
    ckw, skw, batches = TRACES[trace]
    jcfg, tcfg = _cfgs(**ckw)
    params = _params(jcfg.subln, jcfg.xpos_rel_pos)
    scfg = {**SKW, **skw}
    want, want_stats = _run(js.ServingEngine, jcfg,
                            js.ServingConfig(**scfg), params, batches)
    got, got_stats = _run(ts.ServingEngine, tcfg, ts.ServingConfig(**scfg),
                          params, batches)
    assert got == want
    assert got_stats == want_stats
    n_req = sum(len(b) for b in batches)
    assert len(got) == n_req and all(got.values())
    if trace == "prefix_cache_eviction":
        assert got_stats["evicted_pages"] > 0
        assert got_stats["prefix_hit_pages"] > 0
    if trace == "chunked_long_prompt":
        assert got_stats["prefill_chunks"] == 1 + 4
    if trace == "speculative_k4":
        assert got_stats["spec_accepted"] > 0


@pytest.mark.parametrize("stacked", [False, True])
def test_paged_gpt_logits_and_pools_match_jax(stacked):
    """A prefill chunk (ragged n_valid) and then a decode step, from a
    looped tree (looped JAX stack) and a stacked tree (scanned JAX
    stack)."""
    jcfg, tcfg = _cfgs(subln=True, xpos_rel_pos=True, scan_layers=stacked,
                       scale_length=8)
    params = _params(True, True)
    if stacked:
        params = jax.device_get(jk.stack_unigpt_params(dict(params), 2))
    L, H, D, page, P, MP = 2, 2, 16, 8, 8, 3
    rng = np.random.RandomState(0)
    tokens = rng.randint(3, 60, size=(2, 8)).astype(np.int32)
    tables = np.asarray([[1, 2, 3], [5, 4, 6]], np.int32)
    lengths = np.asarray([0, 3], np.int32)
    n_valid = np.asarray([8, 5], np.int32)
    kp = np.zeros((L * P, page, H * D), np.float32)

    jm = jax.jit(js.PagedGPT(jcfg).apply)
    tm = ts.PagedGPT(tcfg)
    sd = flax_to_state_dict(params)
    tm.load_state_dict({k: sd[k] for k in tm.state_dict()}, strict=True)
    jpools = (jnp.asarray(kp), jnp.asarray(kp))
    tpools = (torch.from_numpy(kp.copy()), torch.from_numpy(kp.copy()))
    for step_tokens, lens, nv in (
            (tokens, lengths, n_valid),
            (tokens[:, :1], lengths + n_valid, np.ones(2, np.int32))):
        lj, jk_, jv_ = jm({"params": params}, jnp.asarray(step_tokens),
                                *jpools, jnp.asarray(tables),
                                jnp.asarray(lens), jnp.asarray(nv))
        jpools = (jk_, jv_)
        lt, _, _ = tm(torch.from_numpy(step_tokens), *tpools,
                      torch.from_numpy(tables), torch.from_numpy(lens),
                      torch.from_numpy(nv))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=0)
    for a, b in zip(tpools, jpools):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_per_batch_xpos_matches_jax():
    x = np.random.RandomState(1).randn(2, 3, 2, 16).astype(np.float32)
    pos = np.asarray([[0, 1, 2], [1500, 1501, 1502]], np.int32)
    for invert in (False, True):
        want = js._per_batch_xpos(jnp.asarray(x), jnp.asarray(pos), 512,
                                  invert=invert)
        got = ts._per_batch_xpos(torch.from_numpy(x), torch.from_numpy(pos),
                                 512, invert=invert)
        want = np.asarray(want)
        # sin/cos of fp32 arguments ~1.5e3 rad: the libraries' range
        # reductions differ by a few 1e-6, times decay scales up to ~10
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_batched_sample_supports_and_greedy():
    """top_k=1 is the greedy token; sampled tokens stay inside the top-k
    and top-p supports; temperature <= 0 is the argmax of the raw
    logits; a fixed generator seed reproduces the draw."""
    rng = np.random.RandomState(0)
    V = 200
    logits = torch.from_numpy(rng.randn(5, V).astype(np.float32) * 3)
    temps = torch.tensor([0.0, 1.0, 1.0, 0.7, 1.3])
    topks = torch.tensor([0, 5, 0, 0, 1], dtype=torch.int32)
    topps = torch.tensor([0.0, 0.0, 0.3, 0.0, 0.0])
    order = np.argsort(-logits.numpy(), axis=-1)
    p = np.exp(np.sort(logits[2].numpy())[::-1])
    p /= p.sum()
    n_keep = int(np.searchsorted(np.cumsum(p), 0.3)) + 1
    seen = {1: set(), 2: set(), 3: set()}
    for i in range(200):
        g = torch.Generator().manual_seed(i)
        tok = ts.batched_sample(logits, temps, topks, topps, g).numpy()
        assert tok.dtype == np.int32
        assert tok[0] == order[0, 0] and tok[4] == order[4, 0]
        for b in seen:
            seen[b].add(int(tok[b]))
    assert seen[1] <= set(order[1, :5].tolist()) and len(seen[1]) > 1
    assert seen[2] <= set(order[2, :n_keep].tolist())
    assert len(seen[3]) > 1
    a = ts.batched_sample(logits, temps, topks, topps,
                          torch.Generator().manual_seed(7))
    b = ts.batched_sample(logits, temps, topks, topps,
                          torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    # the JAX sampler's greedy rows agree
    want = js.batched_sample(jnp.asarray(logits.numpy()),
                             jnp.zeros(5), jnp.zeros(5, jnp.int32),
                             jnp.zeros(5), jax.random.PRNGKey(0))
    got = ts.batched_sample(logits, torch.zeros(5),
                            torch.zeros(5, dtype=torch.int32),
                            torch.zeros(5), torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_engine_reproducible_and_greedy_slot_exact():
    """A sampled slot beside a greedy one: a fixed seed reproduces the
    sampled stream; the greedy stream equals the JAX engine's."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg.subln, jcfg.xpos_rel_pos)
    scfg = dict(SKW, seed=11)
    batch = [("s", [5, 9, 11]), ("g", [7, 3, 3, 8])]

    def run(cls):
        kw = {"device": "cpu"} if cls is ts.ServingEngine else {}
        eng = cls(tcfg if cls is ts.ServingEngine else jcfg,
                  (ts if cls is ts.ServingEngine else js).ServingConfig(
                      **scfg), params, **kw)
        samp = (ts if cls is ts.ServingEngine else js).SamplingParams
        eng.submit("s", batch[0][1], sampling=samp(temperature=0.9, top_k=4))
        eng.submit("g", batch[1][1])
        return {k: list(map(int, v)) for k, v in eng.run().items()}

    a, b = run(ts.ServingEngine), run(ts.ServingEngine)
    assert a == b
    assert a["g"] == run(js.ServingEngine)["g"]


def test_unported_options_raise():
    """What the JAX engine refuses under a mesh (it asserts): int8 weights
    and the scanned stack."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg.subln, jcfg.xpos_rel_pos)
    with pytest.raises(ValueError, match="int8 weights"):
        ts.ServingEngine(tcfg, ts.ServingConfig(**SKW, weight_dtype="int8"),
                         params, mesh=object(), device="cpu")
    _, scan = _cfgs(scan_layers=True)
    with pytest.raises(ValueError, match="scan_layers"):
        ts.ServingEngine(scan, ts.ServingConfig(**SKW), params,
                         mesh=object(), device="cpu")


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """device defaults to "cuda": with CUDA hidden the default raises, and
    device="cpu" serves."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg.subln, jcfg.xpos_rel_pos)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cpu"):
        ts.ServingEngine(tcfg, ts.ServingConfig(**SKW), params)
    eng = ts.ServingEngine(tcfg, ts.ServingConfig(**SKW), params,
                           device="cpu")
    assert eng.device.type == "cpu"
    eng.submit("r", [5, 9, 11])
    assert len(eng.run()["r"]) > 0
