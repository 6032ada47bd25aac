"""Port parity for the blocked doc attention (kernels #9 and #10's
contract): unilm_tpu_torch.ops.doc_attention's plain twins (what a CPU
tensor runs) against the JAX package's `doc_attention` / `doc_backward` in
interpret mode, and the dispatcher's choice of branch for CUDA tensors.

Inputs come from numpy and go to both frameworks in float32 (JAX at matmul
precision 'highest', tests/conftest.py). Tolerances: forward 2e-5 abs,
backward 3e-5 abs, the bounds of the JAX package's own doc-attention
tests: the same fp32 exp2-domain math summed in another order.

No card is visible here, so the dispatch tests stand a CPU tensor in for
a CUDA one and record which kernel wrapper the dispatcher calls; the
kernels themselves are held against the plain twins on the card by
chip_smoke.py's doc_attn and doc_bwd phases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import doc_attention as jda
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.ops import attention as tatt
from unilm_tpu_torch.ops import doc_attention as da
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# tests/test_doc_attention.py's cases (B=2, T=S=37, H=4, D=32; bias
# batch/heads, mask), plus ragged T != S, a head-major bias (batch and
# batch-broadcast) and an example whose keys are all masked
CASES = {
    "none": (37, 37, None, False), "mask": (37, 37, None, True),
    "11": (37, 37, (1, 1), False), "1H_mask": (37, 37, (1, 4), True),
    "BH": (37, 37, (2, 4), False), "BH_mask": (37, 37, (2, 4), True),
    "ragged_BH_mask": (70, 45, (2, 4), True),
    "hm_mask": (41, 41, "hm", True), "hm1_mask": (33, 40, "hm1", True),
    "all_masked_row": (37, 40, (2, 4), "allfalse"),
}


def _inputs(case, seed=0):
    T, S, bias, kpm = case
    B, H, D = 2, 4, 32
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, T, H, D) * 0.4).astype(np.float32)
    k = (rng.randn(B, S, H, D) * 0.4).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    shape = {None: None, "hm": (H, B, T, S), "hm1": (H, 1, T, S)}.get(
        bias, None if not isinstance(bias, tuple) else (*bias, T, S))
    b = None if shape is None else (rng.randn(*shape) * 0.5).astype(np.float32)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.2
        mask[:, 0] = True
        if kpm == "allfalse":  # S is a multiple of 8: JAX pads no key
            mask[1] = False
    return q, k, v, g, b, mask, isinstance(bias, str)


def _both(b, hmajor):
    """The bias for JAX and for the port."""
    if b is None:
        return None, None
    if hmajor:
        return jda.HeadMajorBias(hbts=jnp.asarray(b)), da.HeadMajorBias(
            torch.from_numpy(b))
    return jnp.asarray(b), torch.from_numpy(b)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_interpret(name):
    q, k, v, _, b, mask, hm = _inputs(CASES[name])
    jb, tb = _both(b, hm)
    D = q.shape[-1]
    want = jda.doc_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jb, None if mask is None else jnp.asarray(mask),
                             D ** -0.5, 16, True)
    got = da.doc_attention(_t(q), _t(k), _t(v), tb, _t(mask))  # CPU: plain
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    again = da.doc_attention_plain(_t(q), _t(k), _t(v), tb, _t(mask), D ** -0.5)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax_interpret(name):
    """doc_backward_plain against JAX's `doc_backward` (interpret mode) and
    DocAttentionFn's autograd against jax.grad of `doc_attention`."""
    q, k, v, g, b, mask, hm = _inputs(CASES[name], seed=3)
    jb, tb = _both(b, hm)
    D = q.shape[-1]
    jmask = None if mask is None else jnp.asarray(mask)
    jbt = None if jb is None else (jb.hbts if hm else jb)
    want = jda.doc_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jbt, jmask, jnp.asarray(g), D ** -0.5, block_q=16,
                            interpret=True, hmajor=hm)
    got = da.doc_backward(_t(q), _t(k), _t(v), tb, _t(mask), _t(g))
    for name_, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        assert a.shape == w.shape, name_
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=0, err_msg=name_)

    def jloss(q, k, v, bias):
        bb = None if bias is None else (
            jda.HeadMajorBias(hbts=bias) if hm else bias)
        o = jda.doc_attention(q, k, v, bb, jmask, D ** -0.5, 16, True)
        return jnp.sum(o * jnp.asarray(g))

    jargs = [jnp.asarray(x) for x in (q, k, v)] + [jbt]
    nargs = 3 if b is None else 4
    jgrads = jax.grad(jloss, argnums=tuple(range(nargs)))(*jargs)
    targs = [_t(x).requires_grad_() for x in (q, k, v)]
    tbias = None
    if b is not None:
        tbias = _t(b).requires_grad_()
        targs.append(tbias)
    out = da.doc_attention(*targs[:3], None if tbias is None else (
        da.HeadMajorBias(tbias) if hm else tbias), _t(mask))
    tgrads = torch.autograd.grad((out * _t(g)).sum(), targs)
    for name_, a, w in zip(("dq", "dk", "dv", "dbias"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=0, err_msg=name_)


def test_all_masked_row_averages_v_uniformly():
    q, k, v, _, b, mask, _ = _inputs(CASES["all_masked_row"])
    out = da.doc_attention(_t(q), _t(k), _t(v), _t(b), _t(mask))
    want = v[1].mean(0)  # [H, D], every query row of example 1
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(
        want, out[1].shape), atol=1e-6)


def test_supports():
    q, k = torch.zeros(2, 37, 4, 64), torch.zeros(2, 37, 4, 64)
    kw = dict(causal=False, window=0, kv_len=None, q_offset=None)
    assert da.supports(q, k, torch.zeros(2, 4, 37, 37), **kw)
    assert da.supports(q, k, da.HeadMajorBias(torch.zeros(4, 1, 37, 37)), **kw)
    assert not da.supports(q, k, None, **dict(kw, causal=True))
    assert not da.supports(q, torch.zeros(2, 4096, 4, 64), None, **kw)
    assert not da.supports(torch.zeros(2, 37, 4, 80), k, None, **kw)
    assert not da.supports(q, k, torch.zeros(3, 4, 37, 37), **kw)


def test_head_major_bias_is_not_a_tuple():
    """core/transformer.py's Encoder reads a tuple or list as one bias per
    layer; a HeadMajorBias is one bias for every layer."""
    hb = da.HeadMajorBias(torch.zeros(4, 2, 5, 5))
    assert not isinstance(hb, (tuple, list))
    assert hb.bhts().shape == (2, 4, 5, 5)


# --------------------------------------------------------------------------- #
# dispatch on (stand-in) CUDA tensors
# --------------------------------------------------------------------------- #

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the dispatcher
    takes its card branches without a card."""

    @property
    def is_cuda(self):
        return True


class _FakeCudaDevice(_FakeCuda):
    """... that also names a CUDA device, for the kernel wrappers."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, cls=_FakeCuda):
    return torch.zeros(*shape).as_subclass(cls)


@pytest.fixture
def calls(monkeypatch):
    """Record the kernel wrapper the dispatcher calls and what it got."""
    seen = []

    def rec(name):
        def f(q, k, v, bias=None, key_padding_mask=None, scale=None, **kw):
            bias = kw.get("bias", bias)
            seen.append((name, key_padding_mask is not None,
                         type(bias).__name__, scale))
            return q
        return f

    monkeypatch.setattr(da, "doc_attention", rec("doc #9"))
    monkeypatch.setattr(tfa, "fused_encoder_attention", rec("encoder #3"))
    monkeypatch.setattr(tfa, "flash_attention", rec("flash #1"))
    return seen


@pytest.mark.parametrize("S", [50, 709, 2048])
def test_dispatch_mask_at_short_s_takes_doc_kernel(calls, S):
    q, k = _fake(2, 50, 4, 64), _fake(2, S, 4, 64)
    mask = torch.ones(2, S, dtype=torch.bool)
    tatt.attention(q, k, k, key_padding_mask=mask)
    assert calls == [("doc #9", True, "NoneType", None)]


def test_dispatch_head_major_bias_takes_doc_kernel(calls):
    q = _fake(2, 37, 4, 64)
    hb = da.HeadMajorBias(torch.zeros(4, 2, 37, 37))
    tatt.attention(q, q, q, bias=hb, scale=0.125)
    tatt.attention(q, q, q, bias=hb, key_padding_mask=torch.ones(
        2, 37, dtype=torch.bool))
    assert [c[0] for c in calls] == ["doc #9", "doc #9"]
    assert calls[0][2] == "HeadMajorBias" and calls[0][3] == 0.125


def test_dispatch_keeps_the_other_branches(calls):
    """No mask and no head-major bias stays on #3 (BEiT); a mask past 2048
    keys stays on #1 (the 4096-slot Pix2Struct tower), a head-major bias
    there is read through its [B, H, T, S] view."""
    q = _fake(2, 197, 4, 64)
    tatt.attention(q, q, q, bias=torch.zeros(1, 4, 197, 197))
    k = _fake(1, 4096, 4, 64)
    tatt.attention(_fake(1, 64, 4, 64), k, k,
                   key_padding_mask=torch.ones(1, 4096, dtype=torch.bool))
    tatt.attention(_fake(1, 64, 4, 64), k, k, bias=da.HeadMajorBias(
        torch.zeros(4, 1, 64, 4096)))
    assert [c[0] for c in calls] == ["encoder #3", "flash #1", "flash #1"]
    assert calls[2][2] == "Tensor"


def test_dispatch_plain_path_reads_head_major_bias():
    """On the CPU a head-major bias is permuted to [B, H, T, S] and the
    plain path runs: the same output as the [B, H, T, S] bias."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 4, 64).astype(np.float32))
               for _ in range(3))
    b = torch.from_numpy(rng.randn(2, 4, 9, 9).astype(np.float32))
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[1, 3:] = False
    a = tatt.attention(q, k, v, bias=da.HeadMajorBias(b.permute(1, 0, 2, 3)
                                                      .contiguous()),
                       key_padding_mask=mask)
    want = tatt.attention(q, k, v, bias=b, key_padding_mask=mask)
    np.testing.assert_array_equal(a.numpy(), want.numpy())


def test_pix2struct_tower_mask_reaches_doc_kernel(calls):
    """The Kosmos-2.5 tower at 1024 patch slots (<= 2048: the JAX package
    runs #9 there) sends its padding mask, unscaled (attn_scale 1.0), to
    the doc kernel in every layer; nothing raises."""
    cfg = tk.Pix2StructVisionConfig(hidden_size=64, num_layers=2, num_heads=1,
                                    d_ff=64, d_kv=64, max_rows=64)
    tower = tk.Pix2StructVisionEncoder(cfg)
    patches = torch.zeros(1, 1024, 2 + cfg.patch_dim)
    patches[0, :600, :2] = 1.0
    patches[0, :600, 2:] = 0.5
    tower(patches.as_subclass(_FakeCuda))
    assert calls == [("doc #9", True, "NoneType", 1.0)] * cfg.num_layers


# --------------------------------------------------------------------------- #
# the CUDA wrappers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape,match", [
    ((1, 8, 2, 80, 8), "head_dim"),
    ((1, 8, 2, 64, 3000), "S <= 2048"),
])
def test_kernel_wrappers_raise_on_what_they_do_not_take(shape, match):
    """The CUDA wrappers raise before any launch; there is no fallback to
    the plain version for a CUDA tensor."""
    B, T, H, D, S = shape
    f = lambda *s: _fake(*s, cls=_FakeCudaDevice)
    with pytest.raises(ValueError, match=match):
        da._doc_forward_cuda(f(B, T, H, D), f(B, S, H, D), f(B, S, H, D),
                             None, False, None, 1.0)
    with pytest.raises(ValueError, match=match):
        da._doc_backward_cuda(f(B, T, H, D), f(B, S, H, D), f(B, S, H, D),
                              None, False, None, f(B, T, H, D), 1.0)


def test_autograd_runs_both_kernels_once(monkeypatch):
    """A CUDA call that needs a gradient runs under DocAttentionFn: the
    forward through #9's wrapper, the backward through #10's, each once;
    the head-major dbias comes back in the bias's layout."""
    seen = []
    monkeypatch.setattr(da, "_doc_forward_cuda",
                        lambda q, k, v, b, hm, m, s: seen.append("#9")
                        or q * 1.0)

    def bwd(q, k, v, b, hm, m, do, s):
        seen.append(("#10", hm))
        return do, do, do, torch.ones(4, 1, 8, 8)

    monkeypatch.setattr(da, "_doc_backward_cuda", bwd)
    q = _fake(1, 8, 4, 64, cls=_FakeCudaDevice).requires_grad_()
    hb = torch.zeros(4, 1, 8, 8).requires_grad_()
    out = da.doc_attention(q, q, q, da.HeadMajorBias(hb),
                           torch.ones(1, 8, dtype=torch.bool))
    assert out.grad_fn is not None and seen == ["#9"]
    out.sum().backward()
    assert seen == ["#9", ("#10", True)]
    assert hb.grad is not None and hb.grad.shape == (4, 1, 8, 8)
