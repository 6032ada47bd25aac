"""Port parity for the encoder attention backward (kernel #4's contract):
unilm_tpu_torch.ops.flash_attention.fused_encoder_backward_plain (what a
CPU tensor runs) against `jax.vjp` of the JAX package's
`fused_encoder_attention` run in interpret mode, whose custom VJP reaches
the one-pass Pallas backward `_vit_backward` / `_vit_bwd_kernel`; the
autograd Function `EncoderAttentionFn` on the CPU; and the dispatch of a
grad-requiring CUDA call to the kernel wrappers.

Inputs come from numpy and go to both frameworks in float32 (JAX at matmul
precision 'highest', tests/conftest.py). Tolerances, with their reasons:
- against JAX: 2e-5 abs + 1e-5 rel on dq, dk, dv and dbias. The same fp32
  function (JAX in the exp2 domain with the scale folded into q, the port
  in the exp domain), summed in another order; readings are ~1e-6 at
  gradients of magnitude up to ~10;
- `gradcheck` of the plain twin in float64 at its default tolerances
  (finite differences against the analytic gradient);
- the Function against autograd through the plain forward: 1e-5 abs, the
  same fp32 math in another order.

No card is visible here, so the dispatch test stands a CPU tensor in for a
CUDA one and records which wrappers run; the kernel itself is held against
the plain twin on the card by chip_smoke.py's encoder_bwd phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import attention as tatt
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-5

# name: (B, T, S, H, D, bias shape code); T and S not multiples of 8 where
# the case is ragged, so the TPU wrapper pads and masks
CASES = {
    "no_bias": (2, 24, 24, 2, 64, None),
    "bias_11": (2, 24, 24, 2, 64, "11"),
    "bias_1H": (3, 17, 17, 3, 64, "1H"),       # summed over the batch
    "bias_BH": (2, 16, 24, 2, 96, "BH"),
    "bias_B1": (2, 13, 21, 3, 64, "B1"),       # summed over the heads
    "ragged_1H": (2, 13, 21, 2, 64, "1H"),
    "ragged_no_bias": (1, 29, 11, 2, 128, None),
}
BIAS_SHAPES = {None: None, "11": lambda B, H, T, S: (1, 1, T, S),
               "1H": lambda B, H, T, S: (1, H, T, S),
               "BH": lambda B, H, T, S: (B, H, T, S),
               "B1": lambda B, H, T, S: (B, 1, T, S)}


def _inputs(case, seed=0, dtype=np.float32):
    B, T, S, H, D, bias = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(dtype)
    k = rng.randn(B, S, H, D).astype(dtype)
    v = rng.randn(B, S, H, D).astype(dtype)
    do = rng.randn(B, T, H, D).astype(dtype)
    b = None
    if bias is not None:
        b = (2 * rng.randn(*BIAS_SHAPES[bias](B, H, T, S))).astype(dtype)
    return q, k, v, b, do


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_interpret(name):
    case = CASES[name]
    B, T, S, H, D, _ = case
    q, k, v, b, do = _inputs(case)
    scale = D ** -0.5
    # the one-pass Pallas backward (#4) is what the JAX VJP runs here
    assert jfa._vit_bwd_profitable(B, H, T, S, D,
                                   0 if b is None else b.shape[1], 4)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if b is None:
        _, vjp = jax.vjp(lambda q_, k_, v_: jfa.fused_encoder_attention(
            q_, k_, v_, None, scale, True), *args)
    else:
        _, vjp = jax.vjp(lambda q_, k_, v_, b_: jfa.fused_encoder_attention(
            q_, k_, v_, b_, scale, True), *args, jnp.asarray(b))
    want = vjp(jnp.asarray(do))
    got = tfa.fused_encoder_backward(_t(q), _t(k), _t(v), _t(b), _t(do))
    names = ("dq", "dk", "dv", "dbias")
    for n, g, w in zip(names, got, want):
        if w is None:
            assert g is None, n
            continue
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, n
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=n)
    # an explicit scale is the same function as the default D^-0.5
    again = tfa.fused_encoder_backward_plain(_t(q), _t(k), _t(v), _t(b),
                                             _t(do), scale)
    for g, a in zip(got, again):
        if g is not None:
            assert torch.equal(g, a)


@pytest.mark.parametrize("bias", [None, "1H", "B1"])
def test_plain_backward_gradcheck_float64(bias):
    """The twin is the gradient of the plain forward: gradcheck of the
    Function (forward and backward both plain on the CPU) in float64."""
    case = (2, 5, 7, 2, 4, bias)
    q, k, v, b, _ = _inputs(case, seed=1, dtype=np.float64)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if b is not None:
        ins.append(torch.from_numpy(b).requires_grad_())
        fn = lambda q_, k_, v_, b_: tfa.EncoderAttentionFn.apply(
            q_, k_, v_, b_, 0.5)
    else:
        fn = lambda q_, k_, v_: tfa.EncoderAttentionFn.apply(
            q_, k_, v_, None, 0.5)
    assert torch.autograd.gradcheck(fn, tuple(ins))


@pytest.mark.parametrize("name", ["bias_1H", "bias_B1", "no_bias"])
def test_function_matches_autograd_through_the_plain_forward(name):
    """fused_encoder_attention on CPU tensors that require grad goes
    through EncoderAttentionFn; its gradients equal autograd's through
    `fused_encoder_attention_plain`, and a bias that needs no gradient
    gets none."""
    q, k, v, b, do = _inputs(CASES[name], seed=2)
    grads = []
    for fn in (tfa.fused_encoder_attention, tfa.fused_encoder_attention_plain):
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        tb = None if b is None else torch.from_numpy(b).requires_grad_()
        out = fn(*ins, tb)
        out.backward(torch.from_numpy(do))
        grads.append([t.grad for t in ins] + ([] if tb is None else [tb.grad]))
    for a, w in zip(*grads):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5)
    if b is not None:
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        tb = torch.from_numpy(b)
        tfa.fused_encoder_attention(*ins, tb).sum().backward()
        assert tb.grad is None and ins[0].grad is not None


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the dispatcher
    and the autograd Function take their card branches without a card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def wrappers(monkeypatch):
    """Record the kernel wrappers the Function calls; each returns what the
    plain twin computes, on the plain tensors."""
    seen = []

    def fwd(q, k, v, bias, scale):
        seen.append("encoder #3")
        plain = [None if t is None else t.as_subclass(torch.Tensor)
                 for t in (q, k, v, bias)]
        return tfa.fused_encoder_attention_plain(*plain, scale)

    def bwd(q, k, v, bias, do, scale, want_dbias):
        seen.append(("encoder_bwd #4", want_dbias))
        plain = [None if t is None else t.as_subclass(torch.Tensor)
                 for t in (q, k, v, bias, do)]
        dq, dk, dv, db = tfa.fused_encoder_backward_plain(*plain, scale)
        return dq, dk, dv, db if want_dbias else None

    monkeypatch.setattr(tfa, "_encoder_attention_cuda", fwd)
    monkeypatch.setattr(tfa, "_encoder_backward_cuda", bwd)
    return seen


@pytest.mark.parametrize("bias_grad", [True, False])
def test_dispatch_grad_call_to_the_kernels(wrappers, bias_grad):
    """A grad-requiring CUDA call of the dispatcher's encoder branch runs
    #3 forward and #4 backward (dbias only when the bias needs it), and
    the gradients are the plain twin's."""
    q, k, v, b, do = _inputs(CASES["bias_1H"], seed=3)
    ins = [torch.from_numpy(a).as_subclass(_FakeCuda).requires_grad_()
           for a in (q, k, v)]
    tb = torch.from_numpy(b).as_subclass(_FakeCuda)
    if bias_grad:
        tb.requires_grad_()
    out = tatt.attention(*ins, bias=tb)
    out.backward(torch.from_numpy(do))
    assert wrappers == ["encoder #3", ("encoder_bwd #4", bias_grad)]
    want = tfa.fused_encoder_backward_plain(
        *[torch.from_numpy(a) for a in (q, k, v, b, do)])
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.as_subclass(torch.Tensor).numpy(),
                                   w.numpy(), atol=1e-6)
    if bias_grad:
        assert tuple(tb.grad.shape) == b.shape
    else:
        assert tb.grad is None


def test_backward_wrapper_raises_on_what_it_does_not_take():
    """The CUDA backward wrapper raises before any launch (there is no
    fallback to the plain twin for a CUDA tensor)."""
    z = lambda *s: torch.zeros(*s).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._encoder_backward_cuda(z(1, 8, 2, 80), z(1, 8, 2, 80),
                                   z(1, 8, 2, 80), None, z(1, 8, 2, 80),
                                   0.1, False)
    with pytest.raises(ValueError, match="S <= 2048"):
        tfa._encoder_backward_cuda(z(1, 8, 2, 64), z(1, 3000, 2, 64),
                                   z(1, 3000, 2, 64), None, z(1, 8, 2, 64),
                                   0.1, False)
