"""Train-mode dropout and the "dots" remat policy of the port against
unilm_tpu on the CPU, fp32.

Dropout, record and replay: a JAX training forward (the looped stack) runs
with `jax.random.bernoulli` wrapped, which records every mask in call
order (flax's `nn.Dropout` and ops/attention.py's probability dropout both
call it when the forward runs; under `jax.jit` that is while it traces, so
the masks leave the jitted value_and_grad as aux outputs, the bits an
eager run draws from the same key). The port's one
draw helper, `ops.dropout.draw_keep`, is then monkeypatched to hand those
masks back in the same order, asserting each shape, so the port's
training forward must draw the same masks at the same sites in JAX's
order. Loss and gradients then equal JAX's (fp32: loss 1e-5 relative;
each gradient within 1e-4 relative plus the larger of 1e-5 of its
tensor's largest magnitude and 1e-6 of the model's, since sums of
thousands of terms of either sign round differently) for UniGPT, TrOCR,
LayoutLMv3, BEiT with attention dropout, and the core stacks with every
rate.

Also: a missing generator raises, evaluation is the identity, the same
masks come back under "full" and "dots" remat (gradients within 1e-6 of
the stack without remat), "dots" against JAX's `remat_policy="dots"`
(the UniGPT decoder and the BEiT encoder), and the kept divergence of
attention dropout at evaluation (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.core import Decoder as JDecoder
from unilm_tpu.core import Encoder as JEncoder
from unilm_tpu.core import TransformerConfig as JConfig
from unilm_tpu.models import beit as jb
from unilm_tpu.models import kosmos as jk
from unilm_tpu.models import layoutlmv3 as jl
from unilm_tpu.models import trocr as jt
from unilm_tpu.ops import attention as jatt
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.core import layers as tlayers
from unilm_tpu_torch.core.config import TransformerConfig as TConfig
from unilm_tpu_torch.core.transformer import Decoder as TDecoder
from unilm_tpu_torch.core.transformer import Encoder as TEncoder
from unilm_tpu_torch.models import beit as tb
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.models import layoutlmv3 as tl
from unilm_tpu_torch.models import trocr as tt
from unilm_tpu_torch.ops import attention as tatt
from unilm_tpu_torch.ops import doc_attention as tda
from unilm_tpu_torch.ops import dropout as tdropout
from unilm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_SCALE_ATOL = 1e-4, 1e-5
KEY = jax.random.PRNGKey(5)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _init(jm, *args):
    """Parameters for the flax module `jm` from a seeded numpy draw, in the
    tree its init gives (traced by eval_shape, never run): 0.1 * N(0, 1),
    plus 1 for the norms' scales."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(0)

    def leaf(path, s):
        x = 0.1 * rng.randn(*s.shape)
        if getattr(path[-1], "key", None) == "scale":
            x += 1.0
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _record(monkeypatch, jloss, params):
    """(loss, gradients, masks) of jloss(params, KEY) under a jitted
    value_and_grad with jax.random.bernoulli wrapped: each mask is an aux
    output, in draw order."""
    seen, orig = [], jax.random.bernoulli

    def rec(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out)
        return out

    def with_masks(p, key):
        seen.clear()
        return jloss(p, key), list(seen)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", rec)
        (want, masks), grads = jax.jit(
            jax.value_and_grad(with_masks, has_aux=True))(params, KEY)
    return want, grads, [np.asarray(x) for x in masks]


def _replay(monkeypatch, masks):
    """The port's draw helper hands back `masks` in order; returns the
    iterator (empty once every mask was taken)."""
    it = iter(masks)

    def draw(shape, rate, generator, device):
        m = next(it)
        assert tuple(shape) == m.shape, (tuple(shape), m.shape)
        assert generator is not None
        return torch.from_numpy(m.copy()).to(device)

    monkeypatch.setattr(tdropout, "draw_keep", draw)
    return it


def _grads_close(model, jgrads):
    """Every parameter's gradient against JAX's tree of them. A gradient
    that is 0 in exact arithmetic (k_proj's bias: softmax ignores a shift
    of every score of a row) is rounding noise on the scale of the whole
    model's gradients, hence the floor of 1e-6 of the largest of them."""
    jg = {k: v.numpy() for k, v in flax_to_state_dict(_np(jgrads)).items()}
    floor = 1e-6 * max(float(np.abs(v).max()) for v in jg.values())
    for name, p in model.named_parameters():
        want = jg[name]
        atol = max(GRAD_SCALE_ATOL * float(np.abs(want).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=name)


def _weights(shape, seed=11):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _parity(monkeypatch, jloss, params, model, tloss, n_masks):
    """JAX's masks replayed through the port: equal loss and gradients."""
    want, jgrads, masks = _record(monkeypatch, jloss, params)
    assert len(masks) == n_masks
    load_flax_params(model, params)
    model.train()
    it = _replay(monkeypatch, masks)
    loss = tloss(model, torch.Generator().manual_seed(0))
    loss.backward()
    assert next(it, None) is None, "the port drew fewer masks than JAX"
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(model, jgrads)


# ---- UniGPT ---------------------------------------------------------------

UNIGPT = dict(vocab_size=97, embed_dim=64, num_layers=2, num_heads=2,
              ffn_dim=128, max_positions=64, use_flash=False,
              image_tower=None, subln=True, xpos_rel_pos=True)


def _unigpt_setup(**kw):
    toks = np.random.RandomState(0).randint(3, 97, (2, 12)).astype(np.int32)
    toks[1, :2] = 1  # pads: masked keys
    jm = jk.UniGPT(jk.UniGPTConfig(**UNIGPT, **kw))
    params = _init(jm, jnp.asarray(toks))
    w = _weights((2, 12, 97))
    return jm, params, toks, w


def test_unigpt_dropout_matches_jax(monkeypatch):
    """cfg.dropout 0.1 (JAX's `decoder_cfg` :272): the residual branch
    after each attention and the FFN's output, 2 masks a layer."""
    jm, params, toks, w = _unigpt_setup(dropout=0.1)

    def jloss(p, key):
        out = jm.apply({"params": p}, jnp.asarray(toks), deterministic=False,
                       rngs={"dropout": key})
        return jnp.sum(out * w)

    def tloss(m, g):
        return (m(torch.from_numpy(toks).long(), generator=g)
                * torch.from_numpy(w)).sum()

    _parity(monkeypatch, jloss, params,
            tk.UniGPT(tk.UniGPTConfig(**UNIGPT, dropout=0.1)), tloss, 4)


def test_unigpt_dots_matches_jax_dots():
    """remat_policy "dots" on the UniGPT decoder: loss and gradients equal
    JAX's under its own "dots" policy."""
    jm, params, toks, w = _unigpt_setup(remat=True, remat_policy="dots")

    def jloss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(toks)) * w)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model = tk.UniGPT(tk.UniGPTConfig(**UNIGPT, remat=True,
                                      remat_policy="dots"))
    load_flax_params(model, params)
    loss = (model(torch.from_numpy(toks).long()) * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(model, jgrads)


# ---- the core stacks with every rate ----------------------------------------

RATES = dict(dropout=0.1, attention_dropout=0.2, activation_dropout=0.15)
STACK = dict(embed_dim=32, ffn_dim=64, num_layers=2, num_heads=4,
             use_flash=False)


def _stack_inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(2, 9, 32).astype(np.float32),
            rng.randn(2, 7, 24).astype(np.float32))


def _stack_pair(kind, **kw):
    """(JAX module, its params, port module, loss fns (jax, torch)) of a
    2-layer encoder or cross-attention decoder."""
    x, enc = _stack_inputs()
    w = _weights((2, 9, 32))
    jcfg, tcfg = JConfig(**STACK, **kw), TConfig(**STACK, **kw)
    if kind == "encoder":
        jm, tm = JEncoder(jcfg), TEncoder(tcfg)
        args, targs = (jnp.asarray(x),), {}
    else:
        jm = JDecoder(jcfg, has_cross_attention=True)
        tm = TDecoder(tcfg, has_cross_attention=True, encoder_dim=24)
        args = (jnp.asarray(x), jnp.asarray(enc))
        targs = dict(mode="train", encoder_out=torch.from_numpy(enc))
    params = _init(jm, *args)

    def jloss(p, key):
        out = jm.apply({"params": p}, *args, deterministic=False,
                       rngs={"dropout": key})
        return jnp.sum(out * w)

    def tloss(m, g):
        return (m(torch.from_numpy(x), generator=g, **targs)
                * torch.from_numpy(w)).sum()

    return jm, params, tm, jloss, tloss


@pytest.mark.parametrize("kind,n_masks", [("encoder", 8), ("decoder", 12)])
def test_stack_dropout_matches_jax(monkeypatch, kind, n_masks):
    """Every rate at once: the attention probabilities (the plain path, as
    JAX's XLA path), each attention branch (self, and cross in the
    decoder), the FFN's activation and output, in JAX's order."""
    _, params, tm, jloss, tloss = _stack_pair(kind, **RATES)
    _parity(monkeypatch, jloss, params, tm, tloss, n_masks)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_remat_replays_the_same_masks(kind):
    """The layer seeds come from the caller's generator before any layer
    runs and each layer reseeds its own generator, so a recompute under
    "full" or "dots" draws the same masks: gradients within 1e-6 of the
    stack without remat; another seed gives other masks."""
    _, params, _, _, tloss = _stack_pair(kind, **RATES)
    grads = []
    for remat, policy, seed in ((False, "full", 0), (True, "full", 0),
                                (True, "dots", 0), (False, "full", 1)):
        _, _, tm, _, _ = _stack_pair(kind, remat=remat, remat_policy=policy,
                                     **RATES)
        load_flax_params(tm, params)
        tloss(tm.train(), torch.Generator().manual_seed(seed)).backward()
        grads.append([p.grad for p in tm.parameters()])
    for other in grads[1:3]:
        for a, b in zip(other, grads[0]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert any(not torch.allclose(a, b) for a, b in zip(grads[3], grads[0]))


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_training_without_a_generator_raises_and_eval_is_identity(kind):
    """A training forward with a rate and no generator raises; in eval
    the rates do nothing: the output equals JAX's deterministic one and
    the rate-free stack's."""
    jm, params, tm, _, _ = _stack_pair(kind, **RATES)
    load_flax_params(tm, params)
    x, enc = _stack_inputs()
    targs = ({} if kind == "encoder" else
             dict(mode="train", encoder_out=torch.from_numpy(enc)))
    with pytest.raises(ValueError, match="generator"):
        tm.train()(torch.from_numpy(x), **targs)
    _, _, plain, _, _ = _stack_pair(kind)
    load_flax_params(plain, params)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), **targs)
        base = plain.train()(torch.from_numpy(x), **targs)
    args = (jnp.asarray(x),) + (() if kind == "encoder"
                                else (jnp.asarray(enc),))
    want = jax.jit(jm.apply)({"params": params}, *args)
    torch.testing.assert_close(got, base, atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---- TrOCR, LayoutLMv3, BEiT --------------------------------------------------

TROCR = dict(img_size=32, patch_size=16, enc_dim=32, enc_layers=2,
             enc_heads=4, enc_ffn=64, distilled=True, vocab_size=100,
             dec_dim=48, dec_layers=2, dec_heads=4, dec_ffn=96,
             max_positions=64, use_flash=False, dropout=0.1)


def test_trocr_dropout_matches_jax(monkeypatch):
    """TrOCR at dropout 0.1: the encoder's embedding (JAX :110) and
    layers, then the decoder's embedding (:161) and layers (the self and
    cross branches and the FFN output): 1 + 2 x 2 + 1 + 3 x 2 masks."""
    rng = np.random.RandomState(1)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    tok = rng.randint(4, 100, (2, 7)).astype(np.int32)
    w = _weights((2, 7, 100))
    jm = jt.TrOCRModel(jt.TrOCRConfig(**TROCR))
    params = _init(jm, jnp.asarray(img), jnp.asarray(tok))

    def jloss(p, key):
        out = jm.apply({"params": p}, jnp.asarray(img), jnp.asarray(tok),
                       deterministic=False, rngs={"dropout": key})
        return jnp.sum(out * w)

    def tloss(m, g):
        return (m(torch.from_numpy(img), torch.from_numpy(tok).long(),
                  generator=g) * torch.from_numpy(w)).sum()

    _parity(monkeypatch, jloss, params,
            tt.TrOCRModel(tt.TrOCRConfig(**TROCR), device="cpu"), tloss, 12)


LV3 = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2,
           ffn_dim=256, max_positions=64, coordinate_size=22, shape_size=20,
           input_size=32, patch_size=16, num_labels=5, dropout=0.1)


@pytest.mark.parametrize("head,n_masks", [("token", 8), ("seq", 9)])
def test_layoutlmv3_dropout_matches_jax(monkeypatch, head, n_masks):
    """LayoutLMv3 at dropout 0.1 with an image: the text embedding (:311),
    the visual stream (:326), the joint sequence (:331), each layer's two
    residual dropouts, then the head's (:439 for the linear token head;
    :418 and :421 in the dense-tanh head)."""
    rng = np.random.RandomState(0)
    B, L = 2, 24
    ids = rng.randint(3, 120, (B, L)).astype(np.int32)
    ids[0, 18:] = 1
    mask = (ids != 1).astype(np.int32)
    xy = np.sort(rng.randint(0, 900, (B, L, 2, 2)), axis=2)
    bbox = xy.transpose(0, 1, 3, 2).reshape(B, L, 4).astype(np.int32)
    imgs = rng.rand(B, 32, 32, 3).astype(np.float32)
    jcls, tcls = ((jl.LayoutLMv3ForTokenClassification,
                   tl.LayoutLMv3ForTokenClassification) if head == "token"
                  else (jl.LayoutLMv3ForSequenceClassification,
                        tl.LayoutLMv3ForSequenceClassification))
    jm = jcls(jl.LayoutLMv3Config(**LV3, use_flash=False))
    jargs = tuple(jnp.asarray(a) for a in (ids, bbox, mask, imgs))
    params = _init(jm, *jargs)
    w = _weights((B, L, 5) if head == "token" else (B, 5))

    def jloss(p, key):
        out = jm.apply({"params": p}, *jargs, deterministic=False,
                       rngs={"dropout": key})
        return jnp.sum(out * w)

    targs = (torch.from_numpy(ids).long(), torch.from_numpy(bbox).long(),
             torch.from_numpy(mask), torch.from_numpy(imgs))

    def tloss(m, g):
        return (m(*targs, generator=g) * torch.from_numpy(w)).sum()

    _parity(monkeypatch, jloss, params, tcls(tl.LayoutLMv3Config(**LV3)),
            tloss, n_masks)


BEIT = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
            num_layers=2, num_heads=2, ffn_dim=128, use_flash=False)


def _beit_images():
    return np.random.RandomState(2).rand(3, 32, 32, 3).astype(np.float32)


def test_beit_attention_dropout_matches_jax(monkeypatch):
    """BEiT with dropout 0.1 and attention_dropout 0.1: the embedding
    (:163), then per layer the attention probabilities, the attention
    branch and the FFN output."""
    kw = dict(BEIT, dropout=0.1, attention_dropout=0.1)
    img, w = _beit_images(), _weights((3, 10))
    jm = jb.BeitForImageClassification(jb.BeitConfig(**kw))
    params = _init(jm, jnp.asarray(img))

    def jloss(p, key):
        out = jm.apply({"params": p}, jnp.asarray(img), deterministic=False,
                       rngs={"dropout": key})
        return jnp.sum(out * w)

    def tloss(m, g):
        return (m(torch.from_numpy(img), g) * torch.from_numpy(w)).sum()

    _parity(monkeypatch, jloss, params,
            tb.BeitForImageClassification(tb.BeitConfig(**kw)), tloss, 7)


def test_beit_encoder_dots_matches_jax_dots():
    """remat_policy "dots" on BEiT's Encoder: loss and gradients equal
    JAX's under its "dots" policy."""
    kw = dict(BEIT, remat=True, remat_policy="dots")
    img, w = _beit_images(), _weights((3, 10))
    jm = jb.BeitForImageClassification(jb.BeitConfig(**kw))
    params = _init(jm, jnp.asarray(img))

    def jloss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(img)) * w)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model = tb.BeitForImageClassification(tb.BeitConfig(**kw))
    load_flax_params(model, params)
    loss = (model.train()(torch.from_numpy(img)) * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(model, jgrads)


# ---- attention dropout at evaluation: kept on purpose -------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the dispatcher
    takes its card branches without a card."""

    @property
    def is_cuda(self):
        return True


def test_eval_attention_dropout_takes_the_kernels_where_jax_takes_xla(
        monkeypatch):
    """JAX sends a call with a dropout rate to its XLA path even at
    evaluation (core/attention.py passes the rate when deterministic);
    the port launches the kernels whenever no mask is drawn. The function
    is the same: the port's eval output equals JAX's. With a mask drawn
    (training) the port takes the plain path, no kernel."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 10, 2, 16).astype(np.float32) for _ in range(3))
    xla = []
    orig = jatt.dot_product_attention
    monkeypatch.setattr(jatt, "dot_product_attention",
                        lambda *a, **kw: xla.append(1) or orig(*a, **kw))
    want = jatt.attention(*(jnp.asarray(t) for t in (q, k, v)),
                          dropout_rate=0.1, deterministic=True)
    assert xla == [1]

    launched = []
    monkeypatch.setattr(tfa, "fused_encoder_attention",
                        lambda q, *a, **kw: launched.append("#3") or q)
    monkeypatch.setattr(tda, "doc_attention",
                        lambda q, *a, **kw: launched.append("#9") or q)
    fake = [torch.from_numpy(t).as_subclass(_FakeCuda) for t in (q, k, v)]
    tatt.attention(*fake, dropout_rate=0.1)
    assert launched == ["#3"]
    got = tatt.attention(*(torch.from_numpy(t) for t in (q, k, v)),
                         dropout_rate=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    out = tatt.attention(*fake, dropout_rate=0.1,
                         dropout_rng=torch.Generator().manual_seed(0))
    assert launched == ["#3"] and out.shape == q.shape
