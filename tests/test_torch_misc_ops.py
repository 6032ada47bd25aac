"""Port parity for the three einsum ops that JAX writes without a Pallas
kernel: ops/dilated_attention.py (LongNet), ops/sparse_attention.py (ReSA)
and ops/dynamic_conv.py (LightConv / DynamicConv), against unilm_tpu on
the CPU.

Inputs come from numpy seeds, float32 on both sides (JAX at matmul
precision 'highest'). Tolerances: outputs 1e-5 abs + 1e-5 relative (the
same float32 einsums summed in other orders); block ids and summaries'
tail no-op exact. The shapes are the JAX tests' (tests/
test_dilated_attention.py, test_sparse_webdataset.py, test_misc_ops.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import dilated_attention as jdil
from unilm_tpu.ops import dynamic_conv as jdc
from unilm_tpu.ops import sparse_attention as jsa
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.ops import dilated_attention as tdil
from unilm_tpu_torch.ops import dynamic_conv as tdc
from unilm_tpu_torch.ops import sparse_attention as tsa

from test_torch_seq2seq import close, draw_params, t

torch.set_num_threads(1)


def randn(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# ---- LongNet ----------------------------------------------------------------

@pytest.mark.parametrize("segments,rates,T", [
    ((64,), (1,), 64), ((16,), (1,), 64), ((32,), (2,), 64),
    ((8, 16, 32), (1, 2, 4), 64), ((16, 64), (1, 4), 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_dilated_attention_matches_jax(segments, rates, T, causal):
    q, k, v = (randn(s, 2, T, 4, 16, scale=0.5) for s in range(3))
    want = jax.jit(functools.partial(
        jdil.dilated_attention, segment_lengths=segments,
        dilation_rates=rates, causal=causal))(q, k, v)
    got = tdil.dilated_attention(t(q), t(k), t(v), segment_lengths=segments,
                                 dilation_rates=rates, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    close(got, want, 1e-5)


def test_dilated_attention_rejects_what_jax_asserts():
    q = t(randn(0, 1, 48, 4, 8))
    with pytest.raises(ValueError):
        tdil.dilated_attention(q, q, q, segment_lengths=(32,),
                               dilation_rates=(1,))
    with pytest.raises(ValueError):
        tdil.dilated_attention(q, q, q, segment_lengths=(48,),
                               dilation_rates=(3,))  # 4 heads over 3


# ---- ReSA -------------------------------------------------------------------

def test_block_summaries_match_jax():
    k = randn(1, 2, 100, 2, 8)  # a 4-key tail no block covers
    summ = tsa.block_key_summary(t(k), 32)
    close(summ, jsa.block_key_summary(jnp.asarray(k), 32), 1e-6)
    k2 = k.copy()
    k2[:, 70] = randn(2, 2, 2, 8)
    for pos in (70, 96, 99):
        close(tsa.update_block_summary(summ, t(k2), pos, 32),
              jsa.update_block_summary(jnp.asarray(summ.numpy()),
                                       jnp.asarray(k2), jnp.asarray(pos), 32),
              1e-6)
    # a tail position changes nothing (JAX's clamped write made a no-op)
    assert torch.equal(tsa.update_block_summary(summ, t(k2), 99, 32), summ)


@pytest.mark.parametrize("kv_len", [1, 70, 96, 128])
def test_select_blocks_and_sparse_attention_match_jax(kv_len):
    B, S, H, D, bs = 2, 128, 2, 16, 16
    cfg = dict(block_size=bs, topk_blocks=4, rectify_interval=4,
               sink_blocks=1, local_blocks=2)
    q, k, v = randn(0, B, 1, H, D), randn(1, B, S, H, D), randn(2, B, S, H, D)
    summ = jsa.block_key_summary(jnp.asarray(k), bs)
    want_ids = np.asarray(jsa.select_blocks(
        jnp.asarray(q), summ, jnp.asarray(kv_len), jsa.ReSAConfig(**cfg)))
    got_ids = tsa.select_blocks(t(q), t(np.asarray(summ)), kv_len,
                                tsa.ReSAConfig(**cfg))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    want = jsa.sparse_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(want_ids),
        jnp.asarray(kv_len), jsa.ReSAConfig(**cfg))
    got = tsa.sparse_decode_attention(t(q), t(k), t(v), got_ids, kv_len,
                                      tsa.ReSAConfig(**cfg))
    close(got, want, 1e-5)


@pytest.mark.parametrize("step", [0, 1, 4, 7])
def test_resa_decode_step_matches_jax(step):
    B, S, H, D, bs = 1, 128, 2, 16, 32
    cfg = dict(block_size=bs, topk_blocks=2, rectify_interval=4,
               sink_blocks=1, local_blocks=1)
    q, k, v = randn(3, B, 1, H, D), randn(4, B, S, H, D), randn(5, B, S, H, D)
    summ = np.asarray(jsa.block_key_summary(jnp.asarray(k), bs))
    want = jsa.resa_decode_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(summ),
        jnp.asarray(96), jnp.asarray(step), jsa.ReSAConfig(**cfg))
    got = tsa.resa_decode_step(t(q), t(k), t(v), t(summ), 96, step,
                               tsa.ReSAConfig(**cfg))
    assert tsa.rectify_schedule(step, tsa.ReSAConfig(**cfg)) == (step % 4
                                                                 == 0)
    close(got, want, 1e-5)


# ---- LightConv / DynamicConv ------------------------------------------------

@pytest.mark.parametrize("causal,padding_l,softmax", [
    (False, None, True), (True, None, True), (False, 1, False)])
def test_light_and_dynamic_conv_match_jax(causal, padding_l, softmax):
    x = randn(0, 2, 10, 8)
    w = randn(1, 2, 3)
    close(tdc.light_conv(t(x), t(w), 2, padding_l, softmax, causal),
          jdc.light_conv(jnp.asarray(x), jnp.asarray(w), 2, padding_l,
                         softmax, causal), 1e-5)
    wd = randn(2, 2, 10, 2, 3)
    close(tdc.dynamic_conv(t(x), t(wd), padding_l, softmax, causal),
          jdc.dynamic_conv(jnp.asarray(x), jnp.asarray(wd), padding_l,
                           softmax, causal), 1e-5)


def test_dynamic_conv_layer_matches_jax():
    jm = jdc.DynamicConvLayer(dim=16, kernel_size=3, num_heads=4)
    x = randn(3, 2, 6, 16)
    params = draw_params(jm, x)
    tm = tdc.DynamicConvLayer(16, kernel_size=3, num_heads=4)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(t(x))
    close(got, jm.apply({"params": params}, x), 1e-5)
    # causal: a change at the last step leaves the earlier outputs alone
    x2 = x.copy()
    x2[:, -1] = 9.0
    with torch.no_grad():
        close(tm(t(x2))[:, :-1], got[:, :-1], 0)
