"""Port parity for the flash backward: unilm_tpu_torch's FlashAttentionFn
(CPU tensors, so its plain backward `flash_backward_plain`) against
jax.grad through the JAX Pallas flash attention in interpret mode, which
runs `_bwd_dq_kernel` and `_bwd_dkv_kernel` (or, for a head-broadcast
bias, the XLA recompute, as the port's backward does too).

Inputs and the output cotangent come from numpy; both sides run in
float32, JAX at matmul precision 'highest' (tests/conftest.py).
Tolerance 1e-5 abs + 1e-5 rel: the same fp32 math summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = 1e-5

# name: (B, T, S, H, D, causal, q_offset, kv_len, window, kpm, bias, block)
CASES = {
    "causal_kpm_dead_row": (2, 40, 40, 2, 64, True, None, None, 0, True,
                            None, 16),
    "q_offset_kv_len": (2, 19, 45, 2, 64, True, 20, 39, 0, False, None, 16),
    "window": (2, 40, 40, 2, 96, True, None, None, 9, False, None, 16),
    "bias_per_example": (2, 37, 45, 2, 64, False, None, None, 0, False,
                         "BH", 16),
    # [1, H, T, S] with B = 3: dbias summed over the batch (one k block, so
    # JAX takes its in-kernel bias_acc_b sum too)
    "bias_batch_broadcast": (3, 24, 30, 2, 64, True, None, None, 0, False,
                             "1H", 32),
    # [B, 1, T, S] with H > 1: both sides recompute through plain autodiff
    "bias_head_broadcast": (2, 24, 30, 2, 64, False, None, None, 0, True,
                            "B1", 32),
}


def _inputs(case, seed=0):
    B, T, S, H, D, causal, qoff, kvl, window, kpm, bias, _ = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.3
        mask[0, :4] = True
        mask[1] = False  # every key of row 1 padded
        if bias == "B1":
            mask[1, :2] = True  # the recompute's dead rows differ by design
    b = None
    if bias == "BH":
        b = rng.randn(B, H, T, S).astype(np.float32)
    elif bias == "1H":
        b = rng.randn(1, H, T, S).astype(np.float32)
    elif bias == "B1":
        b = rng.randn(B, 1, T, S).astype(np.float32)
    return q, k, v, g, mask, b


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_matches_jax(name):
    case = CASES[name]
    B, T, S, H, D, causal, qoff, kvl, window, kpm, bias, blk = case
    q, k, v, g, mask, b = _inputs(case)

    def jloss(q, k, v, b):
        out = jfa.flash_attention(
            q, k, v, bias=b,
            key_padding_mask=None if mask is None else jnp.asarray(mask),
            causal=causal,
            q_offset=None if qoff is None else jnp.asarray(qoff, jnp.int32),
            kv_len=None if kvl is None else jnp.asarray(kvl, jnp.int32),
            window=window, interpret=True, block_q=blk, block_k=blk)
        return jnp.sum(out * jnp.asarray(g))

    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if b is None else jnp.asarray(b)]
    argnums = (0, 1, 2, 3) if b is not None else (0, 1, 2)
    want = jax.grad(jloss, argnums=argnums)(*jargs)

    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    out = tfa.flash_attention(
        *targs, bias=tb,
        key_padding_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, q_offset=qoff, kv_len=kvl, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    got = [t.grad for t in targs] + ([tb.grad] if tb is not None else [])

    assert len(got) == len(want)
    for name_, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        w = np.asarray(w)
        assert tuple(a.shape) == w.shape, name_
        np.testing.assert_allclose(a.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=name_)
    if kpm and bias is None:
        # the dead row's queries get no gradient, its keys none either
        assert float(targs[0].grad[1].abs().max()) == 0.0
        assert float(targs[1].grad[1].abs().max()) == 0.0


def test_plain_backward_is_the_kernels_contract():
    """flash_backward_plain against autograd through flash_forward_plain
    in float32 (where the kernels' bf16 rounding points vanish): dq is the
    gradient of the pre-scaled q, dk of k, dbias summed over a broadcast
    batch, and a fully masked row gives zeros. Tolerance 1e-5: the lse
    recompute against autograd's saved softmax."""
    rng = np.random.RandomState(1)
    B, T, S, H, D = 3, 17, 23, 2, 64
    t = lambda *s: torch.from_numpy(
        rng.randn(*s).astype(np.float32)).requires_grad_()
    q, k, v, bias = t(B, T, H, D), t(B, S, H, D), t(B, S, H, D), t(1, H, T, S)
    mask = torch.from_numpy(rng.rand(B, S) > 0.3)
    mask[2] = False
    do = torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
    out, lse = tfa.flash_forward_plain(q, k, v, bias, mask, 3, 20,
                                       causal=True, window=0)
    want = torch.autograd.grad(out, (q, k, v, bias), do)
    got = tfa.flash_backward_plain(q.detach(), k.detach(), v.detach(),
                                   bias.detach(), mask, 3, 20, out.detach(),
                                   lse.detach(), do, causal=True, window=0)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, atol=TOL, rtol=TOL)
    assert float(got[0][2].abs().max()) == 0.0
