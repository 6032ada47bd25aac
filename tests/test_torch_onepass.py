"""Port parity for the one-pass short-sequence attention forward
(`_onepass_kernel`, #5; the port's `flash_forward_onepass`,
csrc/onepass_attention.cu) and its selector.

- `onepass_applies` against JAX's `_onepass_profitable` over a grid of
  shapes, bias shapes, windows and operand widths (exact: both are
  integer arithmetic);
- `flash_forward_onepass_plain` against JAX's `_flash_forward_onepass` in
  interpret mode, float32, out and lse within 2e-5 abs + 1e-5 rel (the same
  fp32 softmax; JAX's fast path takes it in the exp2 domain);
- the port's `flash_attention` at a shape the selector admits against
  JAX's `flash_attention` and its `jax.grad`: out, dq, dk, dv and dbias at
  float32 within 2e-5 abs + 1e-4 rel (the same fp32 functions, the
  backward summed in another order; tests/test_torch_flash_backward.py's
  bound);
- the dispatch on a (stand-in) CUDA tensor, and what the kernel wrapper
  refuses. The kernel itself is held against the twin by chip_smoke.py's
  onepass phase and the test marked `cuda` below.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

H, D = 2, 64


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# the selector
# --------------------------------------------------------------------------- #

GRID = dict(B=(1, 8), Hs=(1, 16, 32), T=(1, 8, 128, 700, 2048, 2049),
            S=(1, 200, 256, 384, 1024, 2048, 2049), D=(64, 96, 128),
            window=(0, 1024))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("bias", ["none", "1H", "B1"])
def test_selector_is_jaxs(itemsize, bias):
    seen = set()
    for B, Hh, T, S, Dd, window in itertools.product(*GRID.values()):
        b = None
        if bias != "none":
            b = types.SimpleNamespace(
                shape=(1, Hh, T, S) if bias == "1H" else (B, 1, T, S))
        want = jfa._onepass_profitable(B, Hh, T, S, Dd, b, window, itemsize)
        got = tfa.onepass_applies(B, Hh, T, S, Dd, b, window, itemsize)
        assert got == want, (B, Hh, T, S, Dd, window)
        seen.add(got)
    assert seen == {True, False}  # shapes on both sides of the budget


@pytest.mark.parametrize("name,shape,dtype,want", [
    # YOCO at yoco_base width (16 heads, D = 64), window 1024
    ("yoco chat prefill, 256-slot cache", (8, 16, 128, 256, 64), 2, True),
    ("yoco chat decode", (8, 16, 1, 256, 64), 2, True),
    ("yoco 384-slot cache", (8, 16, 128, 384, 64), 2, False),
    ("yoco fp32, 128-slot cache", (8, 16, 128, 128, 64), 4, True),
    ("yoco fp32, 256-slot cache", (8, 16, 128, 256, 64), 4, False),
    ("yoco long prefill", (1, 16, 4096, 4128, 64), 2, False),
    ("yoco long decode", (1, 16, 1, 4128, 64), 2, False),
    # the port's earlier main paths keep #1
    ("kosmos-2.5 prefill", (1, 16, 2052, 2052, 96), 2, False),
    ("1.3B train step", (2, 32, 2048, 2048, 64), 2, False),
    ("pix2struct tower", (1, 24, 4096, 4096, 64), 2, False),
    ("resampler", (1, 16, 2048, 6144, 96), 2, False),
])
def test_selector_on_the_main_paths(name, shape, dtype, want):
    B, Hh, T, S, Dd = shape
    assert tfa.onepass_applies(B, Hh, T, S, Dd, None, 1024, dtype) is want


# --------------------------------------------------------------------------- #
# the plain twin against the TPU kernel (interpret mode)
# --------------------------------------------------------------------------- #

# name: (B, T, S, causal, q_offset, kv_len, window, kpm, bias)
TWIN_CASES = {
    "causal_q_offset": (2, 16, 40, True, 24, None, 0, False, None),
    "window": (2, 48, 48, True, 0, None, 8, False, None),
    "limit": (2, 16, 64, True, 0, 16, 0, False, None),
    "decode_step": (2, 1, 64, True, 20, 21, 16, False, None),
    "kpm_dead_row": (2, 24, 40, False, 0, None, 0, True, None),
    "bias_1H": (2, 24, 40, False, 0, None, 0, False, "1H"),
    "bias_B1": (2, 24, 40, True, 0, None, 0, False, "B1"),
    "fast_path_S200": (2, 24, 200, False, 0, None, 0, False, None),
}


def _twin_inputs(B, T, S, kpm, bias, seed=0):
    rng = np.random.RandomState(seed)
    q = _rand(rng, B, T, H, D) * np.float32(D ** -0.5)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    mask = None
    if kpm:
        mask = rng.rand(B, S) > 0.3
        mask[1] = False  # example 1 sees no key: out 0, lse 0
    b = None
    if bias == "1H":
        b = _rand(rng, 1, H, T, S)
    elif bias == "B1":
        b = _rand(rng, B, 1, T, S)
    return q, k, v, mask, b


@pytest.mark.parametrize("name", sorted(TWIN_CASES))
def test_plain_twin_matches_the_tpu_kernel(name):
    B, T, S, causal, qoff, kvl, window, kpm, bias = TWIN_CASES[name]
    q, k, v, mask, b = _twin_inputs(B, T, S, kpm, bias)
    sw = lambda a: jnp.asarray(a).swapaxes(1, 2)
    full_kv = kvl is None and not qoff
    jo, jl = jfa._flash_forward_onepass(
        sw(q), sw(k), sw(v), None if b is None else jnp.asarray(b),
        None if mask is None else jnp.asarray(mask, jnp.int32),
        jnp.asarray([qoff], jnp.int32),
        jnp.asarray([S if kvl is None else kvl], jnp.int32),
        causal=causal, window=window, full_kv=full_kv, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    to, tl = tfa.flash_forward_onepass(t(q), t(k), t(v), t(b), t(mask), qoff,
                                       kvl, causal=causal, window=window)
    assert to.shape == (B, T, H, D) and tl.shape == (B, H, T)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo).swapaxes(1, 2),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-5)
    if kpm:  # the dead row: out 0, lse 0, on both sides
        assert float(to[1].abs().max()) == 0.0
        assert float(tl[1].abs().max()) == 0.0
        assert float(np.abs(np.asarray(jl)[1]).max()) == 0.0


# --------------------------------------------------------------------------- #
# flash_attention through the selector, forward and gradients
# --------------------------------------------------------------------------- #

def _recorder(monkeypatch, module, name, seen):
    orig = getattr(module, name)

    def f(*a, **kw):
        seen.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, f)


# name: (T, S, flash_attention kw, bias shape)
GRAD_CASES = {
    "causal_bias_BH": (48, 48, dict(causal=True), "BH"),
    "window_kpm": (40, 40, dict(causal=True, window=12), None),
    "cache_q_offset": (8, 32, dict(causal=True, q_offset=20, kv_len=28),
                       None),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_attention_matches_jax_through_onepass(name, monkeypatch):
    T, S, kw, bias = GRAD_CASES[name]
    B = 2
    rng = np.random.RandomState(4)
    q, g = _rand(rng, B, T, H, D), _rand(rng, B, T, H, D)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    b = _rand(rng, B, H, T, S) if bias == "BH" else None
    mask = None
    if name == "window_kpm":
        mask = rng.rand(B, S) > 0.2
    jseen, tseen = [], []
    _recorder(monkeypatch, jfa, "_flash_forward_onepass", jseen)
    _recorder(monkeypatch, tfa, "flash_forward_onepass", tseen)
    jkw = dict(kw)
    for key in ("q_offset", "kv_len"):
        if key in jkw:
            jkw[key] = jnp.asarray(jkw[key], jnp.int32)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v, b):
        out = jfa.flash_attention(q, k, v, bias=b, key_padding_mask=jm,
                                  interpret=True, **jkw)
        return jnp.sum(out * jnp.asarray(g)), out

    argn = (0, 1, 2, 3) if b is not None else (0, 1, 2)
    jargs = [jnp.asarray(a) for a in (q, k, v)] + [
        None if b is None else jnp.asarray(b)]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=argn,
                                           has_aux=True)(*jargs)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    out = tfa.flash_attention(
        *targs, bias=tb,
        key_padding_mask=None if mask is None else torch.from_numpy(mask),
        **kw)
    (out * torch.from_numpy(g)).sum().backward()
    assert jseen == ["_flash_forward_onepass"]
    assert tseen == ["flash_forward_onepass"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=1e-4)
    tgrads = [a.grad for a in targs] + ([] if tb is None else [tb.grad])
    for gname, tg, jg in zip(("dq", "dk", "dv", "dbias"), tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-5,
                                   rtol=1e-4, err_msg=gname)


# --------------------------------------------------------------------------- #
# on a (stand-in) CUDA tensor
# --------------------------------------------------------------------------- #

class _FakeCudaDevice(torch.Tensor):
    """A CPU tensor that names a CUDA device, so the wrappers take their
    kernel branch and their checks run (they raise before any launch)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*s, dt=torch.float32):
    return torch.zeros(*s, dtype=dt).as_subclass(_FakeCudaDevice)


@pytest.mark.parametrize("S,want", [(256, "#5"), (4128, "#1")])
def test_cuda_dispatch_takes_the_kernel_the_selector_names(S, want,
                                                            monkeypatch):
    """FlashAttentionFn on a CUDA tensor calls #5's launcher where the
    selector admits the shape and #1's where it does not; no plain code."""
    seen = []

    def rec(tag):
        def f(q, *a):
            seen.append(tag)
            return q * 1.0, torch.zeros(q.shape[0], q.shape[2], q.shape[1])
        return f

    monkeypatch.setattr(tfa, "_flash_forward_onepass_cuda", rec("#5"))
    monkeypatch.setattr(tfa, "_flash_forward_cuda", rec("#1"))
    monkeypatch.setattr(tfa, "flash_forward_plain", rec("plain"))
    q, k = _fake(2, 1, 16, 64, dt=torch.bfloat16), _fake(
        2, S, 16, 64, dt=torch.bfloat16)
    tfa.flash_attention(q, k, k, causal=True, q_offset=100, kv_len=101,
                        window=1024)
    assert seen == [want]


@pytest.mark.parametrize("case,match", [
    ("head_dim", "head_dim"), ("long_s", "S <= 2048"),
    ("negative_offset", "q_offset"), ("dtype", "float32/bfloat16")])
def test_kernel_wrapper_raises_on_what_it_does_not_take(case, match):
    Dd = 32 if case == "head_dim" else 64
    S = 3000 if case == "long_s" else 16
    dt = torch.float16 if case == "dtype" else torch.float32
    qoff = -1 if case == "negative_offset" else 0
    q, k = _fake(1, 8, 2, Dd, dt=dt), _fake(1, S, 2, Dd, dt=dt)
    with pytest.raises(ValueError, match=match):
        tfa.flash_forward_onepass(q, k, k, None, None, qoff, None,
                                  causal=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel builds with nvcc "
                    "at first use); chip_smoke.py runs it on the H100")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_kernel_matches_the_twin_on_the_card(card):
    """#5 against its twin at YOCO's chat shapes, bf16 (#1's tolerances in
    chip_smoke.py: 2e-2 abs + 2e-2 rel on out, 1e-3 on lse)."""
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(
        torch.bfloat16)
    for T, qoff, kvl in ((128, 0, 128), (1, 140, 141)):
        q = rn(8, T, 16, 64) * 0.125
        k, v = rn(8, 256, 16, 64), rn(8, 256, 16, 64)
        got = tfa.flash_forward_onepass(q, k, v, None, None, qoff, kvl,
                                        causal=True, window=1024)
        want = tfa.flash_forward_onepass_plain(q, k, v, None, None, qoff, kvl,
                                               causal=True, window=1024)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=0)
