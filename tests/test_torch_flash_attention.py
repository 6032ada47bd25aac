"""Port parity: unilm_tpu_torch.ops.flash_attention (plain path, CPU)
against the JAX Pallas flash attention run in interpret mode.

Inputs come from numpy and go to both frameworks; both run in float32
(JAX at matmul precision 'highest', tests/conftest.py). Tolerance 2e-5
abs: the same fp32 math summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL = 2e-5

# name: (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias)
CASES = {
    "causal": (2, 40, 40, 2, 64, True, None, None, 0, False, None),
    "causal_q_offset": (2, 21, 45, 2, 96, True, 24, None, 0, False, None),
    "kv_len": (2, 19, 45, 2, 64, True, 20, 39, 0, False, None),
    "kpm_dead_row": (2, 37, 45, 2, 96, False, None, None, 0, True, None),
    "bias_1H": (2, 37, 45, 2, 64, False, None, None, 0, False, "1H"),
    "bias_B1": (2, 37, 45, 2, 96, True, 8, None, 0, False, "B1"),
    "window": (2, 40, 40, 2, 96, True, None, None, 9, False, None),
}


def _inputs(case, seed=0):
    B, T, S, H, D, causal, qoff, kvl, window, kpm, bias = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.3
        mask[1] = False  # every key of row 1 padded: out 0, lse 0
    b = None
    if bias == "1H":
        b = rng.randn(1, H, T, S).astype(np.float32)
    elif bias == "B1":
        b = rng.randn(B, 1, T, S).astype(np.float32)
    return q, k, v, mask, b


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_matches_jax(name):
    case = CASES[name]
    B, T, S, H, D, causal, qoff, kvl, window, kpm, bias = case
    q, k, v, mask, b = _inputs(case)
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)

    want = jfa.flash_attention(
        j(q), j(k), j(v), bias=j(b), key_padding_mask=j(mask), causal=causal,
        q_offset=None if qoff is None else jnp.asarray(qoff, jnp.int32),
        kv_len=None if kvl is None else jnp.asarray(kvl, jnp.int32),
        window=window, interpret=True)
    got = tfa.flash_attention(
        t(q), t(k), t(v), bias=t(b), key_padding_mask=t(mask), causal=causal,
        q_offset=qoff, kv_len=kvl, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)

    # row log-sum-exp against the blocked TPU kernel's second output
    scale = D ** -0.5
    qs = q * np.float32(scale)
    _, want_lse = jfa._flash_forward(
        jnp.asarray(qs).swapaxes(1, 2), jnp.asarray(k).swapaxes(1, 2),
        jnp.asarray(v).swapaxes(1, 2), j(b),
        None if mask is None else jnp.asarray(mask, jnp.int32),
        jnp.asarray([qoff or 0], jnp.int32),
        jnp.asarray([S if kvl is None else kvl], jnp.int32),
        causal=causal, window=window, block_q=16, block_k=16,
        interpret=True)
    _, got_lse = tfa.flash_forward(
        t(qs), t(k), t(v), t(b), t(mask), qoff or 0, kvl, causal=causal,
        window=window)
    assert got_lse.shape == (B, H, T) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=0)
    if kpm:
        assert float(got[1].abs().max()) == 0.0
        assert float(got_lse[1].abs().max()) == 0.0
