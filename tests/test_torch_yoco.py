"""Port parity for YOCO (unilm_tpu_torch/models/yoco.py) and gated
retention (unilm_tpu_torch/ops/retention.py) against the JAX package.

Inputs and weights come from numpy / a flax init and are loaded into the
port through convert.from_jax; both sides run in float32, JAX at matmul
precision 'highest' (tests/conftest.py), both on their plain attention
(use_flash=False, as JAX's tests/test_yoco.py runs). Tolerances:
- retention, chunk against naive and against JAX: 1e-5 abs + 1e-5 rel
  (the same fp32 sums in another order; JAX's own chunk-vs-naive bound is
  1e-4 / 1e-3);
- forward logits against JAX: 1e-4 abs + 1e-4 rel (fp32 through a few
  layers);
- prefill + decode against JAX's make_yoco_generate_fns: 3e-4 abs + 1e-3
  rel, JAX's own bound for its prefill/decode against its forward;
- greedy streams: identical tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import yoco as jy
from unilm_tpu.ops import retention as jret
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.models import yoco as ty
from unilm_tpu_torch.ops import retention as tret
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

RET_TOL = 1e-5
LOGIT_TOL = 1e-4
VOCAB = 64


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _ret_inputs(B, T, H, D, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (_rand(rng, B, T, H, D) for _ in range(3))
    g = (-np.abs(_rand(rng, B, T, H)) * 0.1).astype(np.float32)
    return q, k, v, g


# --------------------------------------------------------------------------- #
# gated retention
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("T,chunk", [(16, 4), (17, 4), (8, 8), (32, 16)])
def test_retention_chunk_naive_and_jax_agree(T, chunk):
    q, k, v, g = _ret_inputs(2, T, 3, 8)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o_c, s_c = tret.chunk_gate_retention(*t, chunk)
    o_n, s_n = tret.naive_gate_retention(*t)
    jo, js = jret.chunk_gate_retention(*map(jnp.asarray, (q, k, v, g)), chunk)
    for a, w in ((o_c, o_n), (s_c, s_n), (o_c, jo), (s_c, js)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), atol=RET_TOL,
                                   rtol=RET_TOL)


def test_retention_continues_from_a_state():
    """A chunked scan from the state of the first half gives the second
    half of the whole scan; a recurrent step from it gives JAX's step."""
    q, k, v, g = _ret_inputs(1, 12, 2, 4, seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o_full, s_full = tret.chunk_gate_retention(*t, 4)
    o1, s1 = tret.chunk_gate_retention(*(a[:, :6] for a in t), 4)
    o2, s2 = tret.chunk_gate_retention(*(a[:, 6:] for a in t), 4,
                                       initial_state=s1)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o_full.numpy(),
                               atol=RET_TOL, rtol=RET_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=RET_TOL,
                               rtol=RET_TOL)
    step = [a[:, 6:7] for a in t]
    o, s = tret.recurrent_gate_retention(*step, s1)
    jo, js = jret.recurrent_gate_retention(
        *(jnp.asarray(a.numpy()) for a in step), jnp.asarray(s1.numpy()))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=RET_TOL,
                               rtol=RET_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=RET_TOL,
                               rtol=RET_TOL)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

def tiny_kw(**kw):
    """JAX's tests/test_yoco.py tiny config."""
    d = dict(vocab_size=VOCAB, dim=32, self_layers=2, cross_layers=2,
             num_heads=4, kv_heads=2, ffn_dim=64, window_size=4,
             use_flash=False)
    d.update(kw)
    return d


def _pair(seed=1, T=10, **kw):
    """(JAX model, its params, the port's model with those params)."""
    jm = jy.YOCO(jy.YOCOConfig(**tiny_kw(**kw)))
    toks = jnp.zeros((1, T), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), toks)["params"]
    tm = ty.YOCO(ty.YOCOConfig(**tiny_kw(**kw)), device="cpu")
    load_flax_params(tm, jax.device_get(params))
    return jm, params, tm


def _tokens(B, T, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("self_type", ["sliding_window", "gate_retention"])
def test_forward_logits_match_jax(self_type):
    jm, params, tm = _pair(self_type=self_type)
    toks = _tokens(2, 10)
    want = jm.apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long())
    assert got.shape == (2, 10, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("self_type", ["sliding_window", "gate_retention"])
def test_prefill_decode_match_jax(self_type):
    """Prefill 5 tokens into a 12-slot cache, then decode 7 one at a time:
    the port's logits against JAX's generate functions at each step, and
    against the port's own forward over the whole sequence."""
    T = 12
    jm, params, tm = _pair(self_type=self_type)
    toks = _tokens(1, T, seed=2)
    jpre, jstep = jy.make_yoco_generate_fns(jm, cache_size=T)
    tpre, tstep = ty.make_yoco_generate_fns(tm, cache_size=T)
    jl, jc = jpre(params, jnp.asarray(toks[:, :5]), None)
    tl, tc = tpre(torch.from_numpy(toks[:, :5]).long(), None)
    outs, jouts = [tl], [jl]
    for t in range(5, T):
        jl, jc = jstep(params, jnp.asarray(toks[:, t:t + 1]), jc, None)
        tl, tc = tstep(torch.from_numpy(toks[:, t:t + 1]).long(), tc, None)
        outs.append(tl)
        jouts.append(jl)
    got = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.concatenate(jouts, 1)),
                               atol=3e-4, rtol=1e-3)
    with torch.no_grad():
        full = tm(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got, full.numpy(), atol=3e-4, rtol=1e-3)
    assert tc.pos == T


@pytest.mark.parametrize("self_type", ["sliding_window", "gate_retention"])
def test_greedy_streams_match_jax(self_type):
    """runtime.generate's greedy search over the two packages' generate
    functions: the same tokens, eos never drawn (-1)."""
    P, NEW = 6, 8
    jm, params, tm = _pair(self_type=self_type)
    toks = _tokens(2, P, seed=3)
    kw = dict(beam_size=1, max_new_tokens=NEW, eos=-1, pad=1)
    jtoks, jlen = jgen.greedy_generate(
        jgen.GenerationConfig(**kw), *jy.make_yoco_generate_fns(
            jm, cache_size=P + NEW), params, jnp.asarray(toks))
    ttoks, tlen = tgen.generate(
        tgen.GenerationConfig(**kw), *ty.make_yoco_generate_fns(
            tm, cache_size=P + NEW), torch.from_numpy(toks).long())
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("self_type", ["sliding_window", "gate_retention"])
def test_converter_covers_every_leaf(self_type):
    """Every flax leaf maps to a parameter of the port's YOCO and every
    parameter is matched, under the names the flax tree gives them."""
    jm, params, tm = _pair(self_type=self_type)
    sd = flax_to_state_dict(jax.device_get(params))
    assert set(sd) == set(tm.state_dict())
    want = {"embed_tokens.weight", "kv_norm.weight", "global_k.weight",
            "global_v.weight", "final_norm.weight", "self_norm1_0.weight",
            "self_norm2_1.weight", "self_ffn_0.fc1.weight",
            "self_ffn_0.fc2.weight", "self_ffn_0.fc3.weight",
            "cross_0.q_proj.weight", "cross_1.out_proj.weight",
            "cross_ffn_1.fc3.weight", "self_1.out_proj.weight"}
    if self_type == "gate_retention":
        want |= {"self_0.g_proj.weight", "self_0.gt_proj.weight"}
    assert want <= set(sd)
    # Dense kernels [in, out] arrive transposed
    np.testing.assert_array_equal(
        sd["global_k.weight"].numpy(),
        np.asarray(params["global_k"]["kernel"]).T)


def test_one_global_kv_pair_in_the_cache():
    """The YOCO property: exactly one global K/V pair whatever the
    cross-layer count, beside one (K, V) per self layer."""
    _, _, tm = _pair(cross_layers=3)
    _, cache = tm(torch.from_numpy(_tokens(1, 6)).long(), "prefill",
                  cache_size=6)
    assert cache.global_k.shape == (1, 6, 2, 8)
    assert cache.global_v.shape == (1, 6, 2, 8)
    assert len(cache.self_state) == 2 and cache.pos == 6
    globals_ = [f.name for f in cache.__dataclass_fields__.values()
                if f.name.startswith("global")]
    assert globals_ == ["global_k", "global_v"]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ty.YOCO(ty.YOCOConfig(**tiny_kw()))


def test_cache_overflow_raises():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="overflow"):
        tm(torch.from_numpy(_tokens(1, 6)).long(), "prefill", cache_size=4)
