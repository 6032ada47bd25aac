"""Port parity for the fused encoder attention (kernel #3's contract):
unilm_tpu_torch.ops.flash_attention.fused_encoder_attention_plain (what a
CPU tensor runs) against the JAX package's `fused_encoder_attention` run
in interpret mode, and the dispatcher's choice of branch for CUDA tensors.

Inputs come from numpy and go to both frameworks in float32 (JAX at matmul
precision 'highest', tests/conftest.py). Tolerance 1e-5 abs: the same
fp32 math (JAX in the exp2 domain with scale * log2(e) folded into q, the
port in the exp domain), summed in another order.

No card is visible here, so the dispatch tests stand a CPU tensor in for
a CUDA one (`is_cuda` True) and record which kernel wrapper the
dispatcher calls; the kernel itself is checked against the plain version
on the card by chip_smoke.py's encoder_attn phase.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import attention as tatt
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

ATOL = 1e-5

# name: (B, T, S, H, D, bias shape code)
CASES = {
    "no_bias": (2, 24, 24, 2, 64, None),
    "bias_11": (2, 24, 24, 2, 64, "11"),
    "bias_1H": (2, 17, 17, 3, 64, "1H"),
    "bias_BH": (2, 16, 24, 2, 96, "BH"),
    "ragged_1H": (2, 13, 21, 2, 64, "1H"),
    "ragged_no_bias": (1, 29, 11, 2, 128, None),
}


def _inputs(case, seed=0):
    B, T, S, H, D, bias = case
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    shape = {None: None, "11": (1, 1, T, S), "1H": (1, H, T, S),
             "BH": (B, H, T, S)}[bias]
    b = None if shape is None else (2 * rng.randn(*shape)).astype(np.float32)
    return q, k, v, b


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_interpret(name):
    q, k, v, b = _inputs(CASES[name])
    D = q.shape[-1]
    scale = D ** -0.5
    want = jfa.fused_encoder_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), scale, True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tfa.fused_encoder_attention(t(q), t(k), t(v), t(b))  # CPU: plain
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # an explicit scale is the same function as the default D^-0.5
    again = tfa.fused_encoder_attention_plain(t(q), t(k), t(v), t(b), scale)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("name", ["bias_1H", "ragged_no_bias"])
def test_bf16_twin_against_jax_fast_path(name):
    """On bf16 inputs JAX's #3 takes its "fast" softmax, exp2 of the
    max-shifted scores rounded to bf16 (`_vit_kernel`, flash_attention.py
    :605, 618-623), and rounds q * scale * log2(e) and the pre-scaled bias
    to bf16. The port keeps the exact rounding (p = exp2(s - m) in fp32,
    then rounded), and its kernel is held to the twin, not to the fast
    path. Pinned here: the two bf16 outputs agree to rel L2 1.5e-2, and
    the twin is no farther from the fp32 result than JAX's bf16 output."""
    q, k, v, b = _inputs(CASES[name], seed=1)
    bf = lambda a: None if a is None else torch.from_numpy(a).to(
        torch.bfloat16)
    tq, tk, tv, tb = bf(q), bf(k), bf(v), bf(b)
    j = lambda t: None if t is None else jnp.asarray(t.float().numpy(),
                                                     jnp.bfloat16)
    scale = q.shape[-1] ** -0.5
    want = jfa.fused_encoder_attention(j(tq), j(tk), j(tv), j(tb), scale,
                                       True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    got = tfa.fused_encoder_attention(tq, tk, tv, tb)  # CPU: the twin
    assert got.dtype == torch.bfloat16
    f32 = lambda t: None if t is None else t.float()
    exact = tfa.fused_encoder_attention_plain(f32(tq), f32(tk), f32(tv),
                                              f32(tb))
    rel = lambda x, ref: float((x.float() - ref).norm() / ref.norm())
    assert rel(got, want) <= 1.5e-2
    assert rel(got, exact) <= rel(want, exact)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the dispatcher
    takes its card branches without a card."""

    @property
    def is_cuda(self):
        return True


class _FakeCudaDevice(_FakeCuda):
    """... that also names a CUDA device, for the kernel wrapper."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, cls=_FakeCuda):
    return torch.zeros(*shape).as_subclass(cls)


@pytest.fixture
def calls(monkeypatch):
    """Record the kernel wrapper the dispatcher calls."""
    seen = []
    monkeypatch.setattr(tfa, "fused_encoder_attention",
                        lambda q, *a, **kw: seen.append("encoder #3") or q)
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, *a, **kw: seen.append("flash #1") or q)
    return seen


def test_dispatch_encoder_branch(calls):
    q, k = _fake(2, 197, 4, 64), _fake(2, 197, 4, 64)
    bias = torch.zeros(1, 4, 197, 197)
    tatt.attention(q, k, k, bias=bias)
    assert calls == ["encoder #3"]
    tatt.attention(q, _fake(2, 2048, 4, 64), _fake(2, 2048, 4, 64))
    assert calls == ["encoder #3"] * 2  # S = 2048 is still whole-row


@pytest.mark.parametrize("kw,S", [
    (dict(causal=True), 197),                # the decoder's prefill
    (dict(), 2049),                          # the Kosmos-2.5 resampler
    (dict(key_padding_mask=True), 4096),     # the Pix2Struct tower
    (dict(causal=True, q_offset=3, kv_len=100), 197),
])
def test_dispatch_flash_branch(calls, kw, S):
    q, k = _fake(1, 64, 4, 64), _fake(1, S, 4, 64)
    if kw.get("key_padding_mask"):
        kw = dict(kw, key_padding_mask=torch.ones(1, S, dtype=torch.bool))
    tatt.attention(q, k, k, **kw)
    assert calls == ["flash #1"]


def test_dispatch_kpm_at_short_s_takes_doc_kernel(calls, monkeypatch):
    """A key-padding mask at S <= 2048 leaves the encoder kernel for the
    doc attention (#9, ops/doc_attention.py), as the JAX dispatcher does."""
    from unilm_tpu_torch.ops import doc_attention as da

    monkeypatch.setattr(da, "doc_attention",
                        lambda q, *a, **kw: calls.append("doc #9") or q)
    q, k = _fake(2, 50, 4, 64), _fake(2, 50, 4, 64)
    mask = torch.ones(2, 50, dtype=torch.bool)
    tatt.attention(q, k, k, key_padding_mask=mask)
    assert calls == ["doc #9"]


def test_dispatch_plain_paths(calls):
    """use_flash=False, or a CPU tensor, never reaches a kernel."""
    q = torch.randn(1, 8, 2, 64)
    tatt.attention(q, q, q)
    tatt.attention(q.as_subclass(_FakeCuda), q.as_subclass(_FakeCuda),
                   q.as_subclass(_FakeCuda), use_flash=False)
    assert calls == []


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 2, 80), "head_dim"),
    ((1, 8, 2, 64, 3000), "S <= 2048"),
])
def test_kernel_wrapper_raises_on_what_it_does_not_take(shape, match):
    """The CUDA wrapper raises before any launch; there is no fallback to
    the plain version for a CUDA tensor."""
    B, T, H, D = shape[:4]
    S = shape[4] if len(shape) > 4 else T
    with pytest.raises(ValueError, match=match):
        tfa._encoder_attention_cuda(
            _fake(B, T, H, D, cls=_FakeCudaDevice),
            _fake(B, S, H, D, cls=_FakeCudaDevice),
            _fake(B, S, H, D, cls=_FakeCudaDevice), None, D ** -0.5)


def test_kernel_wrapper_refuses_gradients(monkeypatch):
    """A CUDA call that needs a gradient is no longer refused: it runs
    under EncoderAttentionFn, forward through #3's wrapper and backward
    through #4's (`_vit_bwd_kernel`), each called once."""
    seen = []
    monkeypatch.setattr(tfa, "_encoder_attention_cuda",
                        lambda q, k, v, b, s: seen.append("#3") or q * 1.0)
    monkeypatch.setattr(
        tfa, "_encoder_backward_cuda",
        lambda q, k, v, b, do, s, want: seen.append("#4") or (
            do, do, do, None))
    q = _fake(1, 8, 2, 64, cls=_FakeCudaDevice).requires_grad_()
    out = tfa.fused_encoder_attention(q, q, q)
    assert out.grad_fn is not None and seen == ["#3"]
    out.sum().backward()
    assert seen == ["#3", "#4"] and q.grad is not None
