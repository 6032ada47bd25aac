"""Port parity for the serving slice: the Kosmos-2.5 UniGPT text decoder
(scan_layers, xPos, sub-LN, segment embeddings) in unilm_tpu_torch against
unilm_tpu on the CPU.

A JAX-initialised param tree goes through the bridge
(unilm_tpu_torch.convert.from_jax) into the port; prompts and segment
tokens come from numpy. The cache is >= 1024 so the page-64 / chunk-8 pool
geometry is used, and scale_length=16 so the length-extrapolation qscale
is live. Tolerances: float32 logits 1e-4 and pools 1e-5 (the same fp32
math in another order); bfloat16 logits 0.0625 and pools 0.0316 (4 bf16
ulps at |logit| < 4 and |k|, |v| < 2 — the frameworks round at different
points of the norms and matmuls).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.core.layers import get_activation
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

KW = dict(vocab_size=251, embed_dim=192, num_layers=2, num_heads=2,
          ffn_dim=384, max_positions=1200, scale_length=16, segment_emb=True,
          use_flash=False)
B, P, CACHE = 2, 20, 1040
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.0625, 0.0316)}


@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    """JAX model + stacked params and the port loaded from them."""
    jdt, tdt, _, _ = DTYPES[dtype]
    rng = np.random.RandomState(0)
    prompt = rng.randint(4, KW["vocab_size"], size=(B, P)).astype(np.int32)
    segs = rng.randint(0, 2, size=(B, P)).astype(np.int32)
    looped = jk.UniGPT(jk.UniGPTConfig(dtype=jdt, param_dtype=jdt, **KW))
    p_loop = looped.init(jax.random.PRNGKey(1), jnp.asarray(prompt),
                         segment_tokens=jnp.asarray(segs))["params"]
    params = jax.device_get(jk.stack_unigpt_params(dict(p_loop),
                                                   KW["num_layers"]))
    jm = jk.UniGPT(jk.UniGPTConfig(scan_layers=True, dtype=jdt,
                                   param_dtype=jdt, **KW))
    tm = tk.UniGPT(tk.UniGPTConfig(scan_layers=True, dtype=tdt,
                                   param_dtype=tdt, **KW))
    load_flax_params(tm, params)
    return jm, params, jax.device_get(p_loop), tm, prompt, segs


def _leaf_count(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_bridge_maps_every_leaf():
    """tree -> state_dict -> names: every leaf of stack_unigpt_params'
    output lands on exactly one port parameter, per layer."""
    _, params, p_loop, tm, _, _ = _setup("float32")
    sd = flax_to_state_dict(params)
    L = KW["num_layers"]
    n_layer = _leaf_count(params["decoder"]["layers"])
    assert len(sd) == _leaf_count(params) + (L - 1) * n_layer
    assert set(sd) == set(tm.state_dict())
    for name in ("decoder.layers.1.self_attn.inner_attn_ln.weight",
                 "decoder.layers.0.ffn.ffn_layernorm.bias",
                 "segment_emb.weight", "decoder.layer_norm.weight"):
        assert name in sd
    # the port's stack_unigpt_params gives JAX's stacked tree
    restacked = tk.stack_unigpt_params(p_loop, L)
    for a, b in zip(jax.tree_util.tree_leaves(restacked),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the looped tree bridges to the same tensors
    sd_loop = flax_to_state_dict(p_loop)
    assert set(sd_loop) == set(sd)
    for k in sd:
        assert torch.equal(sd[k], sd_loop[k]), k
    np.testing.assert_array_equal(
        sd["decoder.layers.1.self_attn.q_proj.weight"].numpy(),
        np.asarray(params["decoder"]["layers"]["self_attn"]["q_proj"]
                   ["kernel"][1]).T)
    # a leaf the bridge does not know fails loudly
    bad = {"decoder": {"layers": {"self_attn": {"q_proj": {
        "kernel_i8": np.zeros((2, 4, 4), np.int8)}}}}}
    with pytest.raises(KeyError, match="kernel_i8"):
        flax_to_state_dict(bad)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_decode_logits_and_pools(dtype):
    jm, params, _, tm, prompt, segs = _setup(dtype)
    _, _, atol, pool_atol = DTYPES[dtype]
    prefill = jax.jit(functools.partial(jm.apply, method=jm.prefill,
                                        mutable=["cache"]),
                      static_argnums=(2, 6))
    decode = jax.jit(functools.partial(jm.apply, method=jm.decode_step,
                                       mutable=["cache"]),
                     static_argnums=(2,))

    lj, vars_ = prefill({"params": params}, jnp.asarray(prompt), CACHE,
                        None, None, jnp.asarray(segs), False)
    lt, ct = tm.prefill(torch.from_numpy(prompt).long(), CACHE,
                        segment_tokens=torch.from_numpy(segs).long())
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32),
                               atol=atol, rtol=0)
    cj = vars_["cache"]
    tok = prompt[:, -1:]
    for s in range(4):
        lj, v2 = decode({"params": params, "cache": cj}, jnp.asarray(tok),
                        CACHE)
        cj = v2["cache"]
        lt, ct = tm.decode_step(torch.from_numpy(tok).long(), ct, CACHE)
        np.testing.assert_allclose(lt.float().numpy(),
                                   np.asarray(lj, np.float32), atol=atol,
                                   rtol=0, err_msg=f"step {s}")
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)

    # same cache leaves, same geometry, same contents
    assert set(ct) == set(cj) == {"decoder", "step_counter"}
    assert set(ct["decoder"]) == set(cj["decoder"])
    assert set(ct["step_counter"]) == set(cj["step_counter"]) == {"pos"}
    assert ct["decoder"]["cache_index"] == int(cj["decoder"]["cache_index"])
    assert ct["step_counter"]["pos"] == int(cj["step_counter"]["pos"]) == P + 4
    for leaf in ("kv_pool_key", "kv_pool_value"):
        want = np.asarray(cj["decoder"][leaf], np.float32)
        got = ct["decoder"][leaf]
        assert tuple(got.shape) == want.shape == (B, 2 * 24, 64, 192)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=pool_atol, rtol=0, err_msg=leaf)


def test_greedy_token_stream_identical():
    """B=2 greedy with n-gram blocking: the token streams are identical."""
    jm, params, _, tm, prompt, segs = _setup("float32")
    gcfg = dict(beam_size=1, max_new_tokens=8, min_new_tokens=8,
                no_repeat_ngram_size=2, vocab_size=KW["vocab_size"])
    jpf, jst = jk.make_unigpt_generate_fns(jm, CACHE)
    want, want_len = jgen.greedy_generate(
        jgen.GenerationConfig(**gcfg), jpf, jst, params, jnp.asarray(prompt),
        aux=(None, None, jnp.asarray(segs)))
    tpf, tst = tk.make_unigpt_generate_fns(tm, CACHE)
    got, got_len = tgen.generate(
        tgen.GenerationConfig(**gcfg), tpf, tst, torch.from_numpy(prompt).long(),
        aux=(None, None, torch.from_numpy(segs).long()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_bf16_gelu_is_tanh_like_jax():
    """The JAX package computes 'gelu' as tanh-GELU under bf16 and as
    erf-GELU in fp32 (unilm_tpu/core/layers.py:89-94); the port follows."""
    x = np.linspace(-4, 4, 801).astype(np.float32)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    erf = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    xt = torch.from_numpy(x)
    bf16_fn = get_activation("gelu", torch.bfloat16)
    fp32_fn = get_activation("gelu", torch.float32)
    np.testing.assert_allclose(bf16_fn(xt).numpy(), tanh, atol=1e-6)
    np.testing.assert_allclose(fp32_fn(xt).numpy(), erf, atol=1e-6)
    assert np.abs(tanh - erf).max() > 1e-4  # the rule is observable


def test_xpos_functions_match_jax():
    """xPos tables, the interleaved rotation and the length-extrapolation
    qscale at positions in the thousands, where the decay scale is large."""
    from unilm_tpu.core import positional as jp
    from unilm_tpu_torch.core import positional as tp

    D = 96
    pos = np.arange(2040, 2060, dtype=np.int32)
    x = np.random.RandomState(0).randn(3, len(pos), D).astype(np.float32)
    js, jc, jsc = jp.xpos_sin_cos_scale(jnp.asarray(pos),
                                        jnp.zeros((), jnp.float32), D)
    ts, tc, tsc = tp.xpos_sin_cos_scale(torch.from_numpy(pos), 0.0, D)
    # sin/cos of fp32 arguments ~2e3 rad: the two libraries' range
    # reductions differ by a few 1e-6
    for a, b in ((ts, js), (tc, jc), (tsc, jsc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-5)
    for inv in (False, True):
        want = jp.apply_xpos(jnp.asarray(x), js, jc, 1.0 / jsc if inv else jsc)
        got = tp.apply_xpos(torch.from_numpy(x), ts, tc,
                            1.0 / tsc if inv else tsc)
        # the sin/cos differences above, times decay scales up to ~1e2
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=1e-6 * np.abs(want).max())
    for k_len in (16, 2060):
        want = jp.length_extrapolation_qscale(jnp.asarray(pos), k_len, 16)
        got = tp.length_extrapolation_qscale(torch.from_numpy(pos), k_len, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
