"""Port parity for the JAX package's two opt-in flash schedules:
UNILM_TPU_TRI_FLASH, the lower-triangle causal forward (`_flash_tri_kernel`,
#2; the port's `flash_forward_tri`, csrc/flash_tri.cu), and
UNILM_TPU_FUSED_BWD, the one-pass dq/dk/dv backward (`_bwd_fused_kernel`,
#8; the port's `flash_backward_fused`, csrc/flash_bwd_fused.cu).

Inputs come from numpy; both sides run in float32, JAX at matmul precision
'highest' (tests/conftest.py) and its kernels in interpret mode. The
variables are set with monkeypatch and JAX is traced afresh under them
(it reads them at trace time). Tolerances, with their reasons:
- #2, out and lse: atol 2e-5, rtol 1e-4 (JAX's own bound for the schedule,
  tests/test_flash_attention.py): the same fp32 online softmax in another
  block order;
- #8, dq/dk/dv: 1e-5 abs + 1e-5 rel, tighter than JAX's 5e-4 / 1e-3
  against its dense reference: the port's twin repeats the kernel's fp32
  math, summed in another order;
- the tiny UniGPT train step: tests/test_torch_train.py's (loss and
  metrics 1e-5 relative, every gradient 1e-5 abs, params after one AdamW
  step 1e-5 abs).
The CUDA kernels themselves are held against their twins by the tests
marked `cuda`, which skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.ops import flash_attention as jfa
from unilm_tpu.ops import fused_ce as jce
from unilm_tpu.runtime import optim as joptim
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.core import attention as tcore_attention
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.ops import flash_attention as tfa
from unilm_tpu_torch.ops import fused_ce as tce
from unilm_tpu_torch.runtime import optim as toptim
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(1)

TRI, FUSED = "UNILM_TPU_TRI_FLASH", "UNILM_TPU_FUSED_BWD"
TOL = 1e-5
B, H, D = 2, 2, 64


def _recorder(monkeypatch, module, name, seen):
    """Replace module.name by a wrapper that notes its name in `seen`."""
    orig = getattr(module, name)

    def f(*a, **kw):
        seen.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, f)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# #2: the lower-triangle causal forward
# --------------------------------------------------------------------------- #

T_TRI = 160  # ragged against the 64-row block
# name: (key-padding mask, bias)
TRI_CASES = {"ragged": (False, None), "kpm_dead_row": (True, None),
             "bias": (False, "BH")}


def _tri_inputs(kpm, bias):
    rng = np.random.RandomState(0)
    q, k, v = (_rand(rng, B, T_TRI, H, D) for _ in range(3))
    mask = None
    if kpm:
        mask = rng.rand(B, T_TRI) > 0.3
        mask[0, 0] = True
        mask[1, 0] = False  # example 1's first query sees no key
    b = _rand(rng, B, H, T_TRI, T_TRI) if bias == "BH" else None
    return q, k, v, mask, b


@pytest.mark.parametrize("name", sorted(TRI_CASES))
def test_tri_forward_matches_jax(name, monkeypatch):
    q, k, v, mask, b = _tri_inputs(*TRI_CASES[name])
    monkeypatch.setenv(TRI, "1")
    jseen, tseen = [], []
    _recorder(monkeypatch, jfa, "_flash_forward_tri", jseen)
    _recorder(monkeypatch, tfa, "flash_forward_tri_plain", tseen)
    jm = None if mask is None else jnp.asarray(mask)
    jb = None if b is None else jnp.asarray(b)
    jout = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bias=jb, key_padding_mask=jm, causal=True,
                               interpret=True, block_q=64, block_k=64)
    tm = None if mask is None else torch.from_numpy(mask)
    tb = None if b is None else torch.from_numpy(b)
    tout = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), bias=tb,
                               key_padding_mask=tm, causal=True)
    assert jseen == ["_flash_forward_tri"]
    assert tseen == ["flash_forward_tri_plain"]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=1e-4)

    # the schedule itself: out and lse for pre-scaled q
    qs = q * np.float32(D ** -0.5)
    sw = lambda a: jnp.asarray(a).swapaxes(1, 2)
    jo, jl = jfa._flash_forward_tri(
        sw(qs), sw(k), sw(v), jb,
        None if mask is None else jnp.asarray(mask, jnp.int32),
        jnp.zeros((1,), jnp.int32), jnp.full((1,), T_TRI, jnp.int32),
        block=64, interpret=True)
    to, tl = tfa.flash_forward_tri(torch.from_numpy(qs), torch.from_numpy(k),
                                   torch.from_numpy(v), tb, tm)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo).swapaxes(1, 2),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=1e-4)
    if mask is not None:  # the dead row: out 0, lse 0, on both sides
        assert float(to[1, 0].abs().max()) == 0.0
        assert float(tl[1, :, 0].abs().max()) == 0.0
        assert float(np.abs(np.asarray(jl)[1, :, 0]).max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tri_plain_is_the_causal_plain_forward(dtype):
    """#2's twin is #1's twin with causal fixed, bit for bit."""
    q, k, v, mask, _ = _tri_inputs(True, None)
    b = _rand(np.random.RandomState(1), 1, H, T_TRI, T_TRI)
    t = lambda a: torch.from_numpy(a).to(dtype)
    got = tfa.flash_forward_tri_plain(t(q), t(k), t(v), t(b),
                                      torch.from_numpy(mask))
    want = tfa.flash_forward_plain(t(q), t(k), t(v), t(b),
                                   torch.from_numpy(mask), causal=True)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


# --------------------------------------------------------------------------- #
# #8: the one-pass backward
# --------------------------------------------------------------------------- #

# JAX's own cases (tests/test_flash_attention.py): name: (causal, T, S, mask)
FUSED_CASES = {"causal_96": (True, 96, 96, False),
               "masked_64_128": (False, 64, 128, True),
               "causal_256": (True, 256, 256, False)}


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_backward_matches_jax(name, monkeypatch):
    causal, T, S, with_mask = FUSED_CASES[name]
    rng = np.random.RandomState(2)
    q, g = _rand(rng, B, T, H, D), _rand(rng, B, T, H, D)
    k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, H, D)
    mask = None
    if with_mask:
        mask = np.broadcast_to(np.arange(S)[None, :] < S - 16, (B, S)).copy()
        mask[1, 3:40] = False
    monkeypatch.setenv(FUSED, "1")
    jseen, tseen = [], []
    _recorder(monkeypatch, jfa, "_flash_backward_fused", jseen)
    _recorder(monkeypatch, tfa, "flash_backward_fused_plain", tseen)

    def jloss(q, k, v):
        out = jfa.flash_attention(
            q, k, v, causal=causal,
            key_padding_mask=None if mask is None else jnp.asarray(mask),
            interpret=True, block_q=64, block_k=64)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(
        *targs, causal=causal,
        key_padding_mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    assert jseen == ["_flash_backward_fused"]
    assert tseen == ["flash_backward_fused_plain"]
    for gname, t, w in zip(("dq", "dk", "dv"), targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=gname)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_is_the_split_plain_backward(dtype):
    """#8's twin is #6/#7's twin without a bias and with its delta
    (rowsum(dO out) in fp32, the exact rowsum(p dp) in bf16, which the
    kernel takes from #6's sweep), bit for bit: a window, a query offset
    and kv_len, and a fully masked example."""
    rng = np.random.RandomState(3)
    T, S = 50, 70
    t = lambda *s: torch.from_numpy(_rand(rng, *s)).to(dtype)
    q, k, v, do = t(B, T, H, D), t(B, S, H, D), t(B, S, H, D), t(B, T, H, D)
    mask = torch.from_numpy(rng.rand(B, S) > 0.3)
    mask[1] = False
    out, lse = tfa.flash_forward_plain(q, k, v, None, mask, 10, 60,
                                       causal=True, window=24)
    kw = dict(causal=True, window=24)
    got = tfa.flash_backward_fused_plain(q, k, v, mask, 10, 60, out, lse, do,
                                         **kw)
    want = tfa.flash_backward_plain(q, k, v, None, mask, 10, 60, out, lse, do,
                                    **kw)
    assert len(got) == 3 and want[3] is None
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


# --------------------------------------------------------------------------- #
# the gates
# --------------------------------------------------------------------------- #

# calls the triangle schedule does not take: name: (T, S, flash_attention kw)
TRI_ELSEWHERE = {
    "non_causal": (48, 48, dict(causal=False)),
    "kv_len": (48, 48, dict(causal=True, kv_len=40)),
    "q_offset": (48, 48, dict(causal=True, q_offset=0)),
    "t_ne_s": (40, 56, dict(causal=True)),
}


def _grads(T, S, seed=4, bias=None, **kw):
    """out and (dq, dk, dv[, dbias]) of flash_attention on numpy inputs."""
    rng = np.random.RandomState(seed)
    args = [torch.from_numpy(_rand(rng, B, n, H, D)).requires_grad_()
            for n in (T, S, S)]
    mask = torch.from_numpy(rng.rand(B, S) > 0.2)
    g = torch.from_numpy(_rand(rng, B, T, H, D))
    tb = None
    if bias is not None:
        tb = torch.from_numpy(_rand(rng, *bias(T, S))).requires_grad_()
    out = tfa.flash_attention(*args, bias=tb, key_padding_mask=mask, **kw)
    (out * g).sum().backward()
    grads = [a.grad for a in args] + ([] if tb is None else [tb.grad])
    return [out.detach()] + grads


@pytest.mark.parametrize("name", sorted(TRI_ELSEWHERE))
def test_tri_variable_leaves_other_calls_alone(name, monkeypatch):
    T, S, kw = TRI_ELSEWHERE[name]
    want = _grads(T, S, **kw)
    monkeypatch.setenv(TRI, "1")
    seen = []
    _recorder(monkeypatch, tfa, "flash_forward_tri", seen)
    got = _grads(T, S, **kw)
    assert seen == []
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("bias", ["BH", "B1"])
def test_fused_variable_leaves_biased_backward_alone(bias, monkeypatch):
    """A biased backward keeps #6/#7 (or, head-broadcast, the recompute),
    whatever UNILM_TPU_FUSED_BWD says, as in JAX (:1944-1945)."""
    shape = ((lambda T, S: (B, H, T, S)) if bias == "BH" else
             (lambda T, S: (B, 1, T, S)))
    want = _grads(48, 48, bias=shape, causal=True)
    monkeypatch.setenv(FUSED, "1")
    seen = []
    _recorder(monkeypatch, tfa, "flash_backward_fused", seen)
    got = _grads(48, 48, bias=shape, causal=True)
    assert seen == []
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# name: (variables set, T, S, flash_attention kw, bias shape or None,
#        (forward, backward) wrappers the call must select). At T, S <= 64
# (B=2, H=2, D=64, fp32) every forward the triangle schedule does not take
# fits `onepass_applies`, so it is #5's, as in JAX's `_flash_impl`; 640
# keys pass the one-pass budget and keep #1.
DISPATCH = {
    "train_shape": ((TRI, FUSED), 64, 64, dict(causal=True), None,
                    ("flash_forward_tri", "flash_backward_fused")),
    "biased": ((TRI, FUSED), 64, 64, dict(causal=True), "BH",
               ("flash_forward_tri", "flash_backward")),
    "head_broadcast_bias": ((TRI, FUSED), 64, 64, dict(causal=True), "B1",
                            ("flash_forward_tri", None)),
    "kv_len": ((TRI, FUSED), 64, 64, dict(causal=True, kv_len=50), None,
               ("flash_forward_onepass", "flash_backward_fused")),
    "window": ((TRI, FUSED), 64, 64, dict(causal=True, window=16), None,
               ("flash_forward_onepass", "flash_backward_fused")),
    "non_causal": ((TRI, FUSED), 40, 64, dict(causal=False), None,
                   ("flash_forward_onepass", "flash_backward_fused")),
    "tri_only": ((TRI,), 64, 64, dict(causal=True), None,
                 ("flash_forward_tri", "flash_backward")),
    "fused_only": ((FUSED,), 64, 64, dict(causal=True), None,
                   ("flash_forward_onepass", "flash_backward_fused")),
    "neither": ((), 64, 64, dict(causal=True), None,
                ("flash_forward_onepass", "flash_backward")),
    "past_onepass_budget": ((FUSED,), 640, 640, dict(causal=True), None,
                            ("flash_forward", "flash_backward_fused")),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_selects_the_schedules(name, monkeypatch):
    """Which wrapper FlashAttentionFn calls, per case: the gates are plain
    Python, the same on a CPU tensor as on a CUDA one, so recorders on the
    five wrappers show it (the head-broadcast bias recomputes through
    autograd and calls no backward wrapper)."""
    names, T, S, kw, bias, expect = DISPATCH[name]
    for var in (TRI, FUSED):
        monkeypatch.delenv(var, raising=False)
    for var in names:
        monkeypatch.setenv(var, "1")
    seen = []
    for fn in ("flash_forward", "flash_forward_tri", "flash_forward_onepass",
               "flash_backward", "flash_backward_fused"):
        _recorder(monkeypatch, tfa, fn, seen)
    shapes = {"BH": lambda T, S: (B, H, T, S), "B1": lambda T, S: (B, 1, T, S)}
    _grads(T, S, bias=shapes.get(bias), **kw)
    assert seen == [n for n in expect if n is not None]


class _FakeCudaDevice(torch.Tensor):
    """A CPU tensor that names a CUDA device, so the wrappers take their
    kernel branch and their checks run (they raise before any launch)."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["tri_head_dim", "tri_t_ne_s",
                                  "fused_dtype", "fused_negative_offset"])
def test_kernel_wrappers_raise_on_what_they_do_not_take(case):
    f = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt).as_subclass(
        _FakeCudaDevice)
    if case == "tri_head_dim":
        # 48: a head dim JAX takes and no configuration uses (ROADMAP
        # Queue 3); 32 runs since TrOCR-Small and MiniLM's student need it
        x = f(1, 8, 2, 48)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_forward_tri(x, x, x)
    elif case == "tri_t_ne_s":
        with pytest.raises(ValueError, match="T == S"):
            tfa.flash_forward_tri(f(1, 8, 2, 64), f(1, 9, 2, 64),
                                  f(1, 9, 2, 64))
    else:
        dt = torch.float16 if case == "fused_dtype" else torch.float32
        x = f(1, 8, 2, 64, dt=dt)
        lse = f(1, 2, 8)
        qoff = -1 if case == "fused_negative_offset" else 0
        with pytest.raises(ValueError, match="float32/bfloat16|q_offset"):
            tfa.flash_backward_fused(x, x, x, None, qoff, None, x, lse, x,
                                     causal=True)


# --------------------------------------------------------------------------- #
# the slice: a tiny UniGPT train step under both variables
# --------------------------------------------------------------------------- #

# T = 1024: below it JAX's dispatcher sends a window-free call to XLA, not
# to flash_attention (ops/attention.py:203-208), so only this length puts
# #2 and #8 (interpret mode) on JAX's side of the comparison.
SLICE_KW = dict(vocab_size=256, embed_dim=64, num_layers=2, num_heads=2,
                ffn_dim=128, max_positions=1024, scale_length=512)
SLICE_T, LR = 1024, 1e-3


def _slice_batch():
    """[1, T] tokens whose first token is a pad (id 1), so its first query
    sees no key, and a few pads inside."""
    rng = np.random.RandomState(5)
    toks = rng.randint(4, SLICE_KW["vocab_size"], size=(1, SLICE_T))
    toks[0, 0] = 1
    toks[0, 300:304] = 1
    return toks.astype(np.int32)


def _jax_slice():
    """Under the variables the caller set and interpret-mode flash: params,
    the loss and grads of the batch, and one make_train_step update, traced
    afresh (JAX reads the variables at trace time); and which schedules
    the traces took."""
    seen = []
    tri, fused = jfa._flash_forward_tri, jfa._flash_backward_fused
    jfa._flash_forward_tri = lambda *a, **kw: (seen.append("tri"),
                                               tri(*a, **kw))[1]
    jfa._flash_backward_fused = lambda *a, **kw: (seen.append("fused"),
                                                  fused(*a, **kw))[1]
    try:
        cfg = jk.UniGPTConfig(**SLICE_KW)
        toks = jnp.asarray(_slice_batch())
        model = jk.UniGPT(cfg)
        params = model.init(jax.random.PRNGKey(0), toks)["params"]

        def loss_fn(p, batch, rng):
            out = model.apply({"params": p}, batch, return_features=True)
            s, n = jce.chunked_cross_entropy(
                out[:, :-1], p["embed_tokens"]["embedding"], batch[:, 1:],
                chunk=256)
            return s / n, {"ntok": n}

        (loss0, _), grads0 = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, toks, None)
        tx = optax.adamw(joptim.polynomial_decay_schedule(LR, 10, 0),
                         b1=0.9, b2=0.98, weight_decay=0.01)
        state = jtrain.TrainState.create(params, tx)
        step = jax.jit(jtrain.make_train_step(loss_fn, tx,
                                              clip_grad_norm=1.0))
        state, m = step(state, toks, jax.random.PRNGKey(0))
        metrics = {k: float(v) for k, v in m.items()}
    finally:
        jfa._flash_forward_tri, jfa._flash_backward_fused = tri, fused
    return (jax.device_get(params), float(loss0), jax.device_get(grads0),
            jax.device_get(state.params), metrics, tuple(seen))


def _flash_route(q, k, v, *, bias=None, key_padding_mask=None, scale=None,
                 causal=False, q_offset=None, kv_len=None, window=0,
                 dropout_rate=0.0, dropout_rng=None, use_flash=True):
    """ops.attention.attention's branch for a causal call on a CUDA tensor
    (fa.flash_attention), taken here on the CPU tensors of the test."""
    assert causal and use_flash and dropout_rate == 0.0
    return tfa.flash_attention(q, k, v, bias=bias,
                               key_padding_mask=key_padding_mask, scale=scale,
                               causal=causal, q_offset=q_offset, kv_len=kv_len,
                               window=window)


def _torch_loss(m, batch):
    out = m(batch, return_features=True)
    s, n = tce.chunked_cross_entropy(out[:, :-1], m.embed_tokens.weight,
                                     batch[:, 1:], chunk=256)
    return s / n, {"ntok": n}


def test_train_step_under_both_schedules_matches_jax(monkeypatch):
    """The port's make_train_step against JAX's, both under both schedules
    (JAX's #2 and #8 in interpret mode). On the CPU the port's dispatcher
    sends attention to the plain path, which gives a query with no visible
    key (the leading pad) the uniform average, as JAX's XLA path does, not
    the kernels' 0; so the model's attention calls go to fa.flash_attention
    here, as a causal call on the card does, and the port's gates pick #2
    and #8, whose plain twins run (2 layers: 2 of each per pass).
    Params after the step: 1e-5 abs where JAX's gradient is above 1e-6;
    below it Adam's first update g / (|g| + eps) is decided by fp32 noise in
    g (eps = 1e-8), so there only its bound, 2 lr, holds."""
    monkeypatch.setenv("UNILM_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setenv(TRI, "1")
    monkeypatch.setenv(FUSED, "1")
    params, loss0, grads0, params1, jmetrics, jseen = _jax_slice()
    # traced at least once per layer by each of the two jitted functions
    assert jseen.count("tri") >= 4 and jseen.count("fused") >= 4, jseen
    monkeypatch.setattr(tcore_attention, "attention", _flash_route)
    seen = []
    _recorder(monkeypatch, tfa, "flash_forward_tri_plain", seen)
    _recorder(monkeypatch, tfa, "flash_backward_fused_plain", seen)
    toks = torch.from_numpy(_slice_batch()).long()

    model = tk.UniGPT(tk.UniGPTConfig(**SLICE_KW))
    load_flax_params(model, params)
    loss, _ = _torch_loss(model, toks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss0, rtol=1e-5)
    jgrads = flax_to_state_dict(grads0)
    got = dict(model.named_parameters())
    assert set(jgrads) == set(got)
    for name, g in jgrads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   atol=1e-5, err_msg=name)
    assert seen == ["flash_forward_tri_plain"] * 2 + [
        "flash_backward_fused_plain"] * 2

    model = tk.UniGPT(tk.UniGPTConfig(**SLICE_KW))
    load_flax_params(model, params)
    tx = toptim.AdamW(toptim.polynomial_decay_schedule(LR, 10, 0), b1=0.9,
                      b2=0.98, weight_decay=0.01)
    state = ttrain.TrainState.create(model, tx)
    step = ttrain.make_train_step(_torch_loss, tx, clip_grad_norm=1.0)
    state, m = step(state, toks)
    for k in ("loss", "grad_norm", "ntok"):
        np.testing.assert_allclose(float(m[k]), jmetrics[k], rtol=1e-5,
                                   err_msg=k)
    want = flax_to_state_dict(params1)
    for name, p in model.named_parameters():
        err = np.abs(p.detach().numpy() - want[name].numpy())
        live = np.abs(jgrads[name].numpy()) > 1e-6
        assert err[live].max(initial=0.0) <= 1e-5, name
        assert err.max() <= 2 * LR, name
    assert len(seen) == 8  # the step's pass: 2 more of each


# --------------------------------------------------------------------------- #
# on the card: the kernels against their twins
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels build with nvcc "
                    "at first use); chip_smoke.py runs them on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(x, ref):
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,D", [(63, 64), (160, 96), (1000, 128), (2048, 32),
                                 (65, 32)])
def test_tri_kernel_matches_twin(card, dtype, T, D):
    """#2 against flash_forward_tri_plain: relative L2 <= 1e-2 (bf16: the
    tensor cores sum in another order and p is rounded against a running
    max) / 1e-4 (fp32)."""
    bound = 1e-2 if dtype == torch.bfloat16 else 1e-4
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)
    q, k, v = rn(2, T, 4, D) * D ** -0.5, rn(2, T, 4, D), rn(2, T, 4, D)
    mask = torch.rand(2, T, generator=card, device="cuda") > 0.2
    mask[1, 0] = False
    bias = rn(1, 4, T, T)
    out, lse = tfa.flash_forward_tri(q, k, v, bias, mask)
    ref, ref_lse = tfa.flash_forward_tri_plain(q, k, v, bias, mask)
    assert _rel(out, ref) <= bound and _rel(lse, ref_lse) <= bound
    assert float(out[1, 0].abs().max()) == 0.0 and float(lse[1, :, 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,S,D,causal,window", [
    (200, 200, 64, True, 0), (70, 263, 96, False, 0), (300, 300, 128, True, 50),
    (2048, 2048, 32, True, 0), (130, 70, 32, False, 0)])
def test_fused_kernel_matches_twin(card, dtype, T, S, D, causal, window):
    """#8 against flash_backward_fused_plain on the forward kernel's out
    and lse, same bounds; two runs bit-equal (the ordered dq turns)."""
    bound = 1e-2 if dtype == torch.bfloat16 else 1e-4
    rn = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)
    q, k, v, do = rn(2, T, 4, D) * D ** -0.5, rn(2, S, 4, D), rn(2, S, 4, D), rn(2, T, 4, D)
    mask = torch.rand(2, S, generator=card, device="cuda") > 0.2
    kw = dict(causal=causal, window=window)
    out, lse = tfa.flash_forward(q, k, v, None, mask, 0, None, **kw)
    got = tfa.flash_backward_fused(q, k, v, mask, 0, None, out, lse, do, **kw)
    again = tfa.flash_backward_fused(q, k, v, mask, 0, None, out, lse, do, **kw)
    ref = tfa.flash_backward_fused_plain(q, k, v, mask, 0, None, out, lse, do, **kw)
    for a, b2, r in zip(got, again, ref):
        assert _rel(a, r) <= bound and torch.equal(a, b2)
