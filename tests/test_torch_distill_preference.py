"""Port parity for the q/k/v capture (core/attention.py `capture_qkv`),
runtime/distill.py (MiniLM v1 / v2) and runtime/preference.py (DPO
losses, pair construction) against unilm_tpu on the CPU.

Sizes: tests/test_distill.py's encoders (width 16-32, 2 heads, 2-3
layers, T = 8) and a 2-layer xPos decoder of width 32. Parameters come
from `jax.eval_shape` of the flax init plus a seeded numpy draw, loaded
through convert/from_jax.py; inputs from numpy seeds. Float32 on both
sides, JAX at matmul precision 'highest'. Tolerances: captured q/k/v 1e-5
abs + rel; the losses 1e-5 relative + 1e-6 abs, their gradients 1e-5;
log-probs 1e-5; pair construction and reward reductions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.core.config import TransformerConfig as JCfg
from unilm_tpu.core.transformer import Decoder as JDecoder
from unilm_tpu.core.transformer import Encoder as JEncoder
from unilm_tpu.runtime import distill as jd
from unilm_tpu.runtime import preference as jp
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.core import attention as tatt
from unilm_tpu_torch.core.config import TransformerConfig as TCfg
from unilm_tpu_torch.core.transformer import Decoder as TDecoder
from unilm_tpu_torch.core.transformer import Encoder as TEncoder
from unilm_tpu_torch.runtime import distill as td
from unilm_tpu_torch.runtime import preference as tp

from test_torch_seq2seq import close, draw_params, t

torch.set_num_threads(1)

EKW = dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=3,
           use_flash=False)


def _x(seed, B=2, T=8, E=16):
    return (0.5 * np.random.RandomState(seed).randn(B, T, E)).astype(
        np.float32)


def _mask():
    m = np.ones((2, 8), bool)
    m[1, 5:] = False
    return m


def _jax_capture(module, params, *args, **kw):
    _, inter = module.apply({"params": params}, *args,
                            mutable=["intermediates"], **kw)
    return jd.collect_qkv(inter["intermediates"])


@pytest.mark.parametrize("kind", ["encoder", "decoder_xpos"])
def test_capture_is_jaxs_sown_qkv_in_layer_order(kind):
    """The encoder with a key-padding mask; a decoder with xPos (the
    capture is after the rotation and the qscale)."""
    x = _x(0, E=32 if kind != "encoder" else 16)
    if kind == "encoder":
        jm, tm_cls, kw = JEncoder(JCfg(**EKW)), TEncoder, EKW
        args, targs = (x,), (t(x),)
        call = dict(key_padding_mask=_mask())
        tcall = dict(key_padding_mask=t(_mask()))
    else:
        kw = dict(embed_dim=32, num_heads=2, ffn_dim=64, num_layers=2,
                  xpos_rel_pos=True, use_flash=False)
        jm, tm_cls = JDecoder(JCfg(**kw)), TDecoder
        args, targs, call, tcall = (x,), (t(x),), {}, {}
    params = draw_params(jm, *args, **call)
    tm = tm_cls(TCfg(**kw))
    load_flax_params(tm, params)
    want = _jax_capture(jm, params, *args, **call)
    with torch.no_grad(), tatt.capture_qkv(tm) as rec:
        out_on = tm(*targs, **tcall)
    got = td.collect_qkv(rec)
    assert len(got) == len(want) == kw["num_layers"]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            close(a, b, 1e-5)
    # off: the same output, nothing recorded, no module left capturing
    with torch.no_grad():
        out_off = tm(*targs, **tcall)
    close(out_on, out_off.numpy(), 0)
    assert all(m.qkv_capture is None for m in tm.modules()
               if isinstance(m, tatt.MultiheadAttention))


def test_collect_qkv_orders_layers_numerically():
    rec = {f"encoder.layers.{i}.self_attn": (i,) * 3 for i in (10, 2, 0, 1)}
    assert [q[0] for q in td.collect_qkv(rec)] == [0, 1, 2, 10]


def test_capture_leaves_the_attention_call_alone(monkeypatch):
    """The same attention calls, argument for argument, with the capture
    on and off (so on a CUDA tensor the same kernels launch)."""
    calls = []
    orig = tatt.attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, tuple(sorted(
            (n, v if not isinstance(v, torch.Tensor) else tuple(v.shape))
            for n, v in kw.items()))))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(tatt, "attention", spy)
    tm = TEncoder(TCfg(**{**EKW, "use_flash": True}))
    tm.eval()
    with torch.no_grad():
        tm(t(_x(1)), key_padding_mask=t(_mask()))
        off = list(calls)
        calls.clear()
        with tatt.capture_qkv(tm) as rec:
            tm(t(_x(1)), key_padding_mask=t(_mask()))
    assert calls == off and len(off) == 3 and len(rec) == 3


def _qkv(seed, H, D, B=2, T=8):
    r = np.random.RandomState(seed)
    return tuple((0.5 * r.randn(B, T, H, D)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("masked", [False, True])
def test_minilm_losses_and_grads_match_jax(masked):
    mask = _mask() if masked else None
    tq, sq = _qkv(0, 4, 8), _qkv(1, 4, 6)
    jm = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else t(mask)
    close(td.relation_log_probs(t(tq[0]), 4, tmask),
          jd.relation_log_probs(jnp.asarray(tq[0]), 4, jm), 1e-5)

    def jv2(s):
        return jd.minilm_v2_loss(tq, s, 4, jm, (1.0, 0.5, 2.0))

    def jv1(s):
        return jd.minilm_v1_loss(tq, s, jm)

    for jfn, tfn in ((jv2, lambda s: td.minilm_v2_loss(
            tuple(map(t, tq)), s, 4, tmask, (1.0, 0.5, 2.0))),
                     (jv1, lambda s: td.minilm_v1_loss(
            tuple(map(t, tq)), s, tmask))):
        jl, jg = jax.value_and_grad(jfn)(tuple(map(jnp.asarray, sq)))
        s = tuple(t(x).requires_grad_() for x in sq)
        loss = tfn(s)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(s, jg):
            close(a.grad, b, 1e-5)
    # zero for identical relations, positive otherwise
    same = tuple(map(t, tq))
    assert float(td.minilm_v2_loss(same, same, 4, tmask)) < 1e-6
    assert float(td.minilm_v2_loss(same, tuple(map(t, sq)), 4, tmask)) > 0
    with pytest.raises(ValueError):
        td.minilm_v1_loss(same, tuple(map(t, _qkv(2, 2, 8))))


def test_sequence_log_probs_match_jax():
    r = np.random.RandomState(3)
    logits = r.randn(2, 6, 11).astype(np.float32)
    labels = r.randint(0, 11, (2, 6)).astype(np.int32)
    mask = r.rand(2, 5) > 0.3
    for avg in (False, True):
        close(tp.sequence_log_probs(t(logits), t(labels), t(mask), avg),
              jp.sequence_log_probs(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(mask), avg), 1e-5)


@pytest.mark.parametrize("loss_type,smoothing,ref", [
    ("sigmoid", 0.0, True), ("sigmoid", 0.1, True), ("hinge", 0.0, True),
    ("ipo", 0.0, True), ("sigmoid", 0.0, False)])
def test_dpo_losses_match_jax(loss_type, smoothing, ref):
    r = np.random.RandomState(4)
    pc, pr, rc, rr = (r.randn(3).astype(np.float32) * 3 for _ in range(4))
    refs = (rc, rr) if ref else (None, None)

    def jf(pc_, pr_):
        return jp.dpo_loss(pc_, pr_, *map(lambda a: None if a is None else
                                          jnp.asarray(a), refs), beta=0.3,
                           loss_type=loss_type, label_smoothing=smoothing)

    (jl, (jc, jr)), jg = jax.value_and_grad(
        lambda a, b: (lambda o: (o[0], o[1:]))(jf(a, b)), argnums=(0, 1),
        has_aux=True)(jnp.asarray(pc), jnp.asarray(pr))
    a, b = t(pc).requires_grad_(), t(pr).requires_grad_()
    loss, c, rj = tp.dpo_loss(a, b, *map(lambda x: None if x is None
                                         else t(x), refs), beta=0.3,
                              loss_type=loss_type,
                              label_smoothing=smoothing)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    close(c, jc, 1e-6)
    close(rj, jr, 1e-6)
    close(a.grad, jg[0], 1e-6)
    close(b.grad, jg[1], 1e-6)
    assert not c.requires_grad and not rj.requires_grad
    with pytest.raises(ValueError):
        tp.dpo_loss(a, b, loss_type="kto")


def test_pair_construction_and_rewards_are_jaxs():
    sols = [("s1", "42", 1.0), ("s2", "42", 0.6), ("s3", "7", 0.0),
            ("s4", None, None), ("s5", "7", 0.9), ("s6", "", 0.2)]
    ts = [tp.SampledSolution(*s) for s in sols]
    js = [jp.SampledSolution(*s) for s in sols]
    assert tp.majority_answer(ts) == jp.majority_answer(js)
    for kw in ({}, {"max_pairs": 1}, {"strategy": "test_cases"},
               {"strategy": "test_cases", "min_margin": 0.1}):
        assert (tp.build_preference_pairs(ts, **kw)
                == jp.build_preference_pairs(js, **kw))
    assert tp.build_preference_pairs([tp.SampledSolution("x")]) == []
    for red in ("product", "min", "mean"):
        assert (tp.aggregate_process_rewards([0.9, 0.5, 1.0], red)
                == jp.aggregate_process_rewards([0.9, 0.5, 1.0], red))
    assert tp.aggregate_process_rewards([], "min") == 0.0
    with pytest.raises(ValueError):
        tp.build_preference_pairs(ts, strategy="vote")


def test_minilm_v2_step_with_a_12x32_student_matches_jax():
    """One MiniLM v2 step as chip_smoke.py's distill phase takes it, at a
    small depth: a 2-layer student of MiniLM-L6-H384's width and heads
    (384 wide, 12 heads of 32) under a 64-wide teacher, both over a
    key-padding mask; the last layers' q/k/v relations (4 relation heads).
    The loss within 1e-5 relative + 1e-6 abs and every student gradient
    within 1e-5 of JAX's (`jax.value_and_grad` over the flax tree), as this
    file's other loss gradients."""
    from unilm_tpu_torch.convert.from_jax import flax_to_state_dict

    tkw = dict(embed_dim=64, num_heads=2, ffn_dim=64, num_layers=1,
               use_flash=False)
    skw = dict(embed_dim=384, num_heads=12, ffn_dim=64, num_layers=2,
               use_flash=False)
    assert skw["embed_dim"] // skw["num_heads"] == 32
    xt, xs, mask = _x(2, E=64), _x(3, E=384), _mask()
    jt_, js_ = JEncoder(JCfg(**tkw)), JEncoder(JCfg(**skw))
    tparams = draw_params(jt_, xt, key_padding_mask=mask, seed=1)
    sparams = draw_params(js_, xs, key_padding_mask=mask, seed=2)
    jm = jnp.asarray(mask)
    tqkv = _jax_capture(jt_, tparams, xt, key_padding_mask=mask)[-1]

    def jloss(p):
        sqkv = _jax_capture(js_, p, xs, key_padding_mask=mask)[-1]
        return jd.minilm_v2_loss(tqkv, sqkv, 4, jm)

    jl, jg = jax.value_and_grad(jloss)(sparams)
    teacher, student = TEncoder(TCfg(**tkw)), TEncoder(TCfg(**skw))
    load_flax_params(teacher, tparams)
    load_flax_params(student, sparams)
    tm = t(mask)
    with torch.no_grad(), tatt.capture_qkv(teacher) as rec:
        teacher(t(xt), key_padding_mask=tm)
    with tatt.capture_qkv(student) as srec:
        student(t(xs), key_padding_mask=tm)
    loss = td.minilm_v2_loss(td.collect_qkv(rec)[-1],
                             td.collect_qkv(srec)[-1], 4, tm)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in student.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        close(torch.zeros_like(want[n]) if g is None else g, want[n], 1e-5)
