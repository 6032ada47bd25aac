"""Port parity for models/retnet.py (RetNet over ops/retention.py, the
rectangular [B, H, Dk, 2Dk] recurrent state) and models/
diff_transformer.py against unilm_tpu on the CPU.

Sizes: 2 layers, width 32 (RetNet: 2 heads of key width 16 and value
width 32, chunks of 4), vocab 50. Parameters come from `jax.eval_shape` of
the flax init plus a seeded numpy draw, loaded into both packages; the
port gets them through convert/from_jax.py. Inputs come from numpy
seeds. Float32 on both sides, JAX at matmul precision 'highest' and under
jax.jit. Tolerances: logits 1e-4 relative + 1e-4 absolute; RetNet's
recurrent decode against its own chunk form 1e-4; the recurrent step's
rectangular state against JAX's 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import diff_transformer as jdt
from unilm_tpu.models import retnet as jrn
from unilm_tpu.ops import retention as jret
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.models import diff_transformer as tdt
from unilm_tpu_torch.models import retnet as trn
from unilm_tpu_torch.ops import retention as tret

from test_torch_seq2seq import close, draw_params, t

torch.set_num_threads(1)

V = 50
RKW = dict(vocab_size=V, embed_dim=32, num_layers=2, num_heads=2,
           chunk_size=4)


def _tokens(seed, B=2, T=10):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


def test_retention_decays_match_jax():
    close(trn.retention_decays(6), jrn.retention_decays(6), 0)


def test_recurrent_step_takes_a_rectangular_state():
    """Dv = 2 Dk: the state [B, H, Dk, Dv] and the output [B, 1, H, Dv]
    against JAX's step."""
    rng = np.random.RandomState(0)
    q, k = (rng.randn(2, 1, 3, 4).astype(np.float32) for _ in range(2))
    v = rng.randn(2, 1, 3, 8).astype(np.float32)
    g = -np.abs(0.1 * rng.randn(2, 1, 3)).astype(np.float32)
    s = rng.randn(2, 3, 4, 8).astype(np.float32)
    o, ns = tret.recurrent_gate_retention(t(q), t(k), t(v), t(g), t(s))
    jo, jns = jret.recurrent_gate_retention(q, k, v, g, s)
    assert o.shape == (2, 1, 3, 8) and ns.shape == (2, 3, 4, 8)
    close(o, jo, 1e-5)
    close(ns, jns, 1e-5)


def _retnet():
    jm = jrn.RetNetDecoder(jrn.RetNetConfig(**RKW))
    params = draw_params(jm, _tokens(0))
    tm = trn.RetNetDecoder(trn.RetNetConfig(**RKW), device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm


def test_retnet_forward_matches_jax():
    jm, params, tm = _retnet()
    tok = _tokens(1)
    jl, js = jax.jit(lambda p: jm.apply({"params": p}, tok))(params)
    with torch.no_grad():
        tl, ts = tm(t(tok).long())
    assert ts.shape == (2, 2, 2, 16, 32)
    close(tl, jl)
    close(ts, js)


def test_retnet_recurrent_decode_matches_chunk_form_and_jax():
    """A chunk-form prefill of 6 tokens, then 4 recurrent steps from its
    states: each step's logits against the chunk form over the whole
    sequence and against JAX's decode; the final states against the
    chunk form's."""
    jm, params, tm = _retnet()
    tok = _tokens(2, T=10)
    P = 6
    with torch.no_grad():
        full, full_states = tm(t(tok).long())
        _, states = tm(t(tok[:, :P]).long())
    jstates = jnp.asarray(states.numpy())
    jdec = jax.jit(lambda p, x, s, pos: jm.apply(
        {"params": p}, x, s, pos, "decode"))
    for i in range(P, 10):
        pos = torch.tensor([i])
        with torch.no_grad():
            logits, states = tm(t(tok[:, i:i + 1]).long(), states, pos,
                                "decode")
        close(logits, full[:, i:i + 1])
        jl, jstates = jdec(params, tok[:, i:i + 1], jstates, np.array([i]))
        close(logits, jl)
    close(states, full_states)


def test_init_retnet_states_shape():
    cfg = trn.retnet_base()
    s = trn.init_retnet_states(cfg, 3)
    assert s.shape == jrn.init_retnet_states(jrn.retnet_base(), 3).shape
    assert s.shape == (12, 3, 3, 256, 512) and s.dtype == torch.float32


DKW = dict(vocab_size=V, embed_dim=32, num_layers=2, num_heads=2,
           ffn_dim=48)


@pytest.mark.parametrize("kv_heads", [None, 1])
def test_diff_transformer_matches_jax(kv_heads):
    """Full heads and GQA (the kv heads repeated)."""
    jm = jdt.DiffTransformerLM(jdt.DiffTransformerConfig(
        **DKW, num_kv_heads=kv_heads))
    tok = _tokens(3, T=9)
    params = draw_params(jm, tok)
    want = jax.jit(lambda p: jm.apply({"params": p}, tok))(params)
    tm = tdt.DiffTransformerLM(tdt.DiffTransformerConfig(
        **DKW, num_kv_heads=kv_heads), device="cpu")
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(t(tok).long())
    assert got.shape == (2, 9, V)
    close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_diff_attention_matches_jax(causal):
    jm = jdt.MultiheadDiffAttn(32, depth=3, num_heads=2)
    x = np.random.RandomState(4).randn(2, 7, 32).astype(np.float32)
    params = draw_params(jm, x)
    want = jax.jit(lambda p: jm.apply({"params": p}, x, causal))(params)
    tm = tdt.MultiheadDiffAttn(32, depth=3, num_heads=2)
    load_flax_params(tm, params)
    with torch.no_grad():
        close(tm(t(x), causal), want)
    assert tm.lambda_init == jdt.lambda_init_fn(3)
