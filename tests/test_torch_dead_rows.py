"""A query row with no visible key: the two values the port keeps, pinned.

Causal, B=2, T=S=16, H=2, D=64, example 0 left-padded by 3 keys, so its
rows 0-2 see no key. JAX's dispatcher sends this call (T > 8, S < 1024,
causal, no window) to its XLA path, where the NEG_INF fill softmaxes such
a row to the mean of v over all S keys; the port's CPU `attention` (its
plain path) gives the same. On the card the port sends it to the flash
kernels (#5 or #1), which give the row out = 0 and lse = 0, as JAX's own
flash kernels do (the keep-guard of `_flash_kernel`); their backward
(#6/#7) gives it dq = 0. The flash kernels' plain twins, which the CPU
tests run in their place, show the card's values here.

Inputs from numpy; float32, JAX at matmul precision 'highest'
(tests/conftest.py). Tolerance 2e-5 abs: the same fp32 math summed in
another order.
"""

import jax.numpy as jnp
import numpy as np
import torch

from unilm_tpu.ops import attention as jattn
from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import attention as tattn
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL = 2e-5
B, T, H, D = 2, 16, 2, 64
PADS = 3  # example 0's leading pad keys = its dead rows


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, g = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    mask = np.ones((B, T), bool)
    mask[0, :PADS] = False
    return q, k, v, g, mask


def _jax_attention(q, k, v, mask):
    return np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_padding_mask=jnp.asarray(mask), causal=True))


def _live(x):
    """x with example 0's dead rows dropped: [B*T - PADS, H, D]."""
    return np.concatenate([x[0, PADS:], x[1]])


def test_cpu_attention_matches_jax_on_every_row():
    """The port's CPU path is JAX's function, dead rows included: the
    mean of v over all S keys there."""
    q, k, v, _, mask = _inputs()
    want = _jax_attention(q, k, v, mask)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          key_padding_mask=torch.from_numpy(mask),
                          causal=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    mean_v = np.broadcast_to(v[0].mean(0), (PADS, H, D))
    np.testing.assert_allclose(want[0, :PADS], mean_v, atol=ATOL, rtol=0)
    assert np.abs(mean_v).max() > 0.1  # the two values really differ


def test_flash_twin_gives_zero_on_dead_rows():
    """`flash_forward_plain`, the twin of the card's kernels, gives the
    dead rows out = 0 and lse = 0 and agrees with JAX on every other."""
    q, k, v, _, mask = _inputs()
    want = _jax_attention(q, k, v, mask)
    out, lse = tfa.flash_forward_plain(
        torch.from_numpy(q * np.float32(D ** -0.5)), torch.from_numpy(k),
        torch.from_numpy(v), None, torch.from_numpy(mask), causal=True)
    out, lse = out.numpy(), lse.numpy()
    assert (out[0, :PADS] == 0).all() and (lse[0, :, :PADS] == 0).all()
    np.testing.assert_allclose(_live(out), _live(want), atol=ATOL, rtol=0)


def test_jax_flash_kernel_gives_zero_on_dead_rows():
    """JAX's own flash kernel (interpret mode) gives the dead rows 0 too,
    and agrees with its XLA path on every other row: only JAX's choice of
    path differs from the card."""
    q, k, v, _, mask = _inputs()
    want = _jax_attention(q, k, v, mask)
    got = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_padding_mask=jnp.asarray(mask), causal=True, interpret=True))
    assert (got[0, :PADS] == 0).all()
    np.testing.assert_allclose(_live(got), _live(want), atol=ATOL, rtol=0)


def test_flash_backward_twin_gives_zero_dq_on_dead_rows():
    """`flash_backward_plain` (the twin of #6/#7) on the flash forward's
    out and lse: dead rows get dq = 0 and add nothing to dk, dv: the
    gradients equal those of the same call with the dead rows' output
    gradient zeroed."""
    q, k, v, g, mask = _inputs()
    qs = torch.from_numpy(q * np.float32(D ** -0.5))
    kt, vt, mt = (torch.from_numpy(a) for a in (k, v, mask))
    out, lse = tfa.flash_forward_plain(qs, kt, vt, None, mt, causal=True)
    do = torch.from_numpy(g)
    dq, dk, dv, _ = tfa.flash_backward_plain(qs, kt, vt, None, mt, 0, None,
                                             out, lse, do, causal=True)
    assert (dq[0, :PADS] == 0).all()
    assert float(dq[0, PADS:].abs().max()) > 0
    do0 = do.clone()
    do0[0, :PADS] = 0
    dq0, dk0, dv0, _ = tfa.flash_backward_plain(qs, kt, vt, None, mt, 0, None,
                                                out, lse, do0, causal=True)
    for x, y in ((dq, dq0), (dk, dk0), (dv, dv0)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL, rtol=0)
