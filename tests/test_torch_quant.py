"""Port parity: unilm_tpu_torch.ops.quant against unilm_tpu.ops.quant on the
CPU, and the bridge for QuantDense leaves.

Tolerances: quantization (int8 values and f32 scales) is bit-equal, the
same fp32 arithmetic in the same order. Matmuls agree within 2e-5: the
same exact products (int8 and fp32 inputs are exact in fp32) summed in
another order, at |out| ~ 1. The JAX Pallas kernel runs in interpret
mode, as tests/test_quant.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models.kosmos import UniGPT as JUniGPT
from unilm_tpu.models.kosmos import UniGPTConfig as JCfg
from unilm_tpu.models.kosmos import stack_unigpt_params
from unilm_tpu.ops import quant as jq
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict
from unilm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

ATOL = 2e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _jax_proj_predicate(p):
    return p[-2] in tq.PROJECTIONS and any(s.startswith("layers") for s in p)


@pytest.mark.parametrize("shape,axis,dtype", [
    ((256, 384), 0, "float32"), ((96, 160), 1, "float32"),
    ((3, 128, 96), 1, "float32"), ((128, 256), 0, "bfloat16")])
def test_quantize_int8_bit_equal(shape, axis, dtype):
    w = _rand(shape, 0, 0.05)
    w[0, 0] = 0.0
    if len(shape) == 2:
        w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    wi, sc = jq.quantize_int8(jw, axis=axis)
    twi, tsc = tq.quantize_int8(
        torch.from_numpy(w).to(getattr(torch, dtype)), axis=axis)
    assert twi.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(twi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(sc))


@pytest.mark.parametrize("M", [1, 8, 13])
def test_int8_matmul_plain_matches_jax(monkeypatch, M):
    """The plain version against JAX's Pallas kernel (interpret) and its
    XLA dequant-dot, K x N = 256 x 384 (multiples of 128, so JAX takes
    the kernel), leading dims [M] and [1, M]."""
    K, N = 256, 384
    x = _rand((M, K), 1)
    wi, sc = jq.quantize_int8(jnp.asarray(_rand((K, N), 2, 0.05)), axis=0)
    want_k = np.asarray(jq.int8_matmul(jnp.asarray(x), wi, sc,
                                       interpret=True))
    want_x = np.asarray(jq._xla_int8_matmul(jnp.asarray(x), wi, sc))
    tw = torch.from_numpy(np.asarray(wi).T.copy())
    ts = torch.from_numpy(np.array(sc))
    got = tq.int8_matmul(torch.from_numpy(x), tw, ts)  # CPU -> plain
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_x, atol=ATOL, rtol=0)
    got3 = tq.int8_matmul(torch.from_numpy(x)[None], tw, ts)
    assert got3.shape == (1, M, N)
    np.testing.assert_array_equal(got3[0].numpy(), got.numpy())


@pytest.mark.parametrize("bias", [True, False])
def test_quant_dense_matches_jax(bias):
    import flax.linen as nn

    K, N = 64, 96
    x = _rand((5, K), 3)
    dense = nn.Dense(N, use_bias=bias)
    dp = dense.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"]
    dp = jax.device_get(dp)
    if bias:
        dp["bias"] = _rand((N,), 4, 0.1)
    qp = jq.quantize_dense_tree(dict(dp))
    want = jq.QuantDense(features=N, use_bias=bias, dtype=jnp.float32).apply(
        {"params": qp}, jnp.asarray(x))
    qd = tq.QuantDense(K, N, bias=bias, dtype=torch.float32)
    qd.load_state_dict(flax_to_state_dict(qp))
    got = qd(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    qd.use_kernel = False
    np.testing.assert_array_equal(qd(torch.from_numpy(x)).numpy(),
                                  got.numpy())


def _tiny_tree():
    cfg = JCfg(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
               ffn_dim=48, max_positions=128, use_flash=False,
               image_tower=None)
    params = JUniGPT(cfg).init(jax.random.PRNGKey(0),
                               jnp.ones((1, 4), jnp.int32))["params"]
    return jax.device_get(params)


@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_tree_and_state_dict_match_jax(stacked):
    """quantize_dense_tree equals JAX's on a looped and a stacked UniGPT
    tree; the bridge maps kernel_i8/scale onto QuantDense's tensors; and
    quantize_state_dict of the plain bridge output gives the same
    state_dict."""
    params = _tiny_tree()
    if stacked:
        params = jax.device_get(stack_unigpt_params(dict(params), 2))
    want = jax.device_get(jq.quantize_dense_tree(
        params, predicate=_jax_proj_predicate))
    got = tq.quantize_dense_tree(params, predicate=_jax_proj_predicate)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))

    sd = flax_to_state_dict(want)
    names = [k for k in sd if k.endswith("weight_i8")]
    assert len(names) == 2 * 6  # q/k/v/out + fc1/fc2 per layer
    layers = want["decoder"]["layers"] if stacked else None
    for li in range(2):
        tree = (jax.tree_util.tree_map(lambda a: a[li], layers) if stacked
                else want["decoder"][f"layers_{li}"])
        fc1 = tree["ffn"]["fc1"]
        np.testing.assert_array_equal(
            sd[f"decoder.layers.{li}.ffn.fc1.weight_i8"].numpy(),
            np.asarray(fc1["kernel_i8"]).T)
        np.testing.assert_array_equal(
            sd[f"decoder.layers.{li}.ffn.fc1.scale"].numpy(),
            np.asarray(fc1["scale"]))
    # norms keep `scale` -> `weight`; QuantDense keeps `scale`
    assert "decoder.layers.0.self_attn_layer_norm.weight" in sd
    assert "decoder.layers.0.self_attn.q_proj.weight" not in sd

    via_sd = tq.quantize_state_dict(flax_to_state_dict(params))
    assert set(via_sd) == set(sd)
    for k in sd:
        assert via_sd[k].dtype == sd[k].dtype or k.endswith(".bias"), k
        np.testing.assert_array_equal(via_sd[k].float().numpy(),
                                      sd[k].float().numpy(), err_msg=k)
