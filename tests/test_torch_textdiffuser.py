"""Port parity for models/textdiffuser.py and models/textdiffuser2.py
against unilm_tpu on the CPU.

Sizes: the JAX tests' (tests/test_textdiffuser.py's UNet: 16 px, base 16,
mults (1, 2), time 32, T = 100; tests/test_textdiffuser2.py's planner: 2
layers of width 64, 2 heads). Parameters come from `jax.eval_shape` of
the flax init plus a seeded numpy draw (the UNet's zero-init `out` conv
drawn too, so that every path shows at the output), loaded through
convert/from_jax.py; JAX's draws (timesteps, noise) are replayed into the
port. Float32 on both sides, JAX at matmul precision 'highest' under
jax.jit. Tolerances: the UNet's ε 1e-5 abs + 1e-5 relative, the loss
1e-5; DDIM 1e-3 of the output's largest magnitude (relative: its first
step divides by sqrt(ᾱ(999/1000)) ~ 1.6e-3); planner logits 1e-4 (abs +
rel; four xPos layers); greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import textdiffuser as jtd
from unilm_tpu.models import textdiffuser2 as jtd2
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.models import textdiffuser as ttd
from unilm_tpu_torch.models import textdiffuser2 as ttd2

from test_torch_seq2seq import close, draw_params, t

torch.set_num_threads(1)

UKW = dict(img_size=16, base_channels=16, channel_mults=(1, 2),
           mask_channels=4, time_dim=32, timesteps=100)


# ---- TextDiffuser -----------------------------------------------------------

def test_render_char_mask_is_jaxs():
    boxes = [("ab", (0, 0, 8, 4)), ("1", (8, 8, 16, 12)),
             ("Hi there", (1, 2, 15, 9)), ("?x", (3, 3, 5, 5))]
    np.testing.assert_array_equal(ttd.render_char_mask(boxes, 16),
                                  jtd.render_char_mask(boxes, 16))
    assert ttd.DEFAULT_CHARSET == jtd.DEFAULT_CHARSET


def _masks(B=2):
    return np.stack([ttd.render_char_mask([("hi", (0, 0, 16, 16))], 16),
                     ttd.render_char_mask([("a1", (2, 4, 14, 10))], 16)
                     ][:B]).astype(np.int32)


@pytest.fixture(scope="module")
def unet():
    jm = jtd.TextDiffuserUNet(jtd.TextDiffuserConfig(**UKW))
    z = np.zeros((2, 16, 16, 3), np.float32)
    params = draw_params(jm, z, np.zeros(2, np.int32), _masks())
    tm = ttd.TextDiffuserUNet(ttd.TextDiffuserConfig(**UKW), device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("side", [16, 12])
def test_unet_matches_jax(unet, side):
    """16 px (even sides at every level: the stride-2 SAME conv pads (0, 1))
    and 12 px (6 at the second level) through both the strided conv and
    the nearest x2 upsampling."""
    jm, params, tm = unet
    rng = np.random.RandomState(side)
    z = rng.randn(2, side, side, 3).astype(np.float32)
    tt = np.array([3, 50], np.int32)
    mask = _masks()[:, :side, :side]
    want = jax.jit(lambda p: jm.apply({"params": p}, z, tt, mask))(params)
    with torch.no_grad():
        got = tm(t(z), t(tt), t(mask))
    assert got.shape == z.shape
    close(got, want, 1e-5)
    # the mask conditions the output
    with torch.no_grad():
        other = tm(t(z), t(tt), torch.zeros_like(t(mask)))
    assert float((other - got).abs().max()) > 1e-4


def test_unet_bf16_blocks_match_jax(unet):
    """cfg.dtype bfloat16: the ResBlocks' convs and projections compute in
    bf16 (core/layers.py ConvNHWC's `dtype`), the rest in float32, as
    flax's dtype / promotion does; relative L2 2e-2 (bf16 rounding)."""
    _, params, _ = unet
    jm = jtd.TextDiffuserUNet(jtd.TextDiffuserConfig(**UKW,
                                                     dtype=jnp.bfloat16))
    tm = ttd.TextDiffuserUNet(ttd.TextDiffuserConfig(
        **UKW, dtype=torch.bfloat16), device="cpu")
    load_flax_params(tm, params)
    z = np.random.RandomState(5).randn(2, 16, 16, 3).astype(np.float32)
    tt, mask = np.array([3, 50], np.int32), _masks()
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, z, tt, mask)
                              )(params), np.float32)
    with torch.no_grad():
        got = tm(t(z), t(tt), t(mask)).float().numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_nearest_upsampling_is_jax_image_resize():
    x = np.random.RandomState(0).randn(2, 3, 5, 4).astype(np.float32)
    want = jax.image.resize(x, (2, 6, 10, 4), "nearest")
    got = t(x).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    close(got, want, 0)


def _jax_loss_draws(key, B):
    r_t, r_e = jax.random.split(key)
    return (np.asarray(jax.random.randint(r_t, (B,), 0, UKW["timesteps"])),
            np.asarray(jax.random.normal(r_e, (B, 16, 16, 3))))


def test_diffusion_loss_and_grads_match_jax(unet):
    jm, params, tm = unet
    mask = _masks()
    images = ((mask[..., None] > 0).astype(np.float32).repeat(3, -1) - 0.5)
    key = jax.random.PRNGKey(3)
    cfg = jtd.TextDiffuserConfig(**UKW)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtd.diffusion_loss(jm, p, images, mask, key, cfg),
        has_aux=True))(params)
    tt, eps = _jax_loss_draws(key, 2)
    tm.zero_grad()
    loss, met = ttd.diffusion_loss(tm, t(images), t(mask), t=t(tt),
                                   eps=t(eps))
    loss.backward()
    close(loss, jl, 1e-5)
    assert met["mse"] is loss
    want = flax_to_state_dict(jax.device_get(jg))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the draws come from a generator when not given
    l1, _ = ttd.diffusion_loss(tm, t(images), t(mask),
                               torch.Generator().manual_seed(0))
    l2, _ = ttd.diffusion_loss(tm, t(images), t(mask),
                               torch.Generator().manual_seed(0))
    assert float(l1.detach()) == float(l2.detach())


@pytest.mark.parametrize("steps", [5, 20])
def test_ddim_matches_jax_relatively(unet, steps):
    jm, params, tm = unet
    mask = _masks()
    key = jax.random.PRNGKey(2)
    cfg = jtd.TextDiffuserConfig(**UKW)
    want = np.asarray(jax.jit(lambda p: jtd.ddim_sample(
        jm, p, mask, key, cfg, steps=steps))(params))
    z = np.asarray(jax.random.normal(key, (2, 16, 16, 3)))
    got = ttd.ddim_sample(tm, t(mask), steps=steps, z=t(z)).numpy()
    assert got.shape == (2, 16, 16, 3) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_ddim_timesteps_are_jaxs():
    for T, steps in ((1000, 20), (100, 5), (1000, 7), (100, 1)):
        want = np.asarray(jnp.linspace(T - 1, 0, steps).astype(jnp.int32))
        assert ttd.ddim_timesteps(T, steps) == want.tolist()


def test_fresh_unet_predicts_zero_and_a_step_moves_it():
    """`out` starts at zero (flax's zeros init); one AdamW step on the loss
    through the port's make_train_step moves it."""
    from unilm_tpu_torch.runtime.optim import AdamW
    from unilm_tpu_torch.runtime.train import TrainState, make_train_step

    tm = ttd.TextDiffuserUNet(ttd.TextDiffuserConfig(**UKW), device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    mask = t(_masks())
    z = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert float(tm(z, t(np.array([1, 2])), mask).abs().max()) == 0
    tx = AdamW(2e-3)
    step = make_train_step(lambda m, b: ttd.diffusion_loss(
        m, b["images"], b["mask"], torch.Generator().manual_seed(b["s"])),
        tx)
    state = TrainState.create(tm, tx)
    state, met = step(state, {"images": z, "mask": mask, "s": 0})
    assert np.isfinite(float(met["loss"]))
    assert float(tm.out.weight.detach().abs().max()) > 0


# ---- TextDiffuser-2 ---------------------------------------------------------

PKW = dict(embed_dim=64, ffn_dim=128, num_layers=2, num_heads=2,
           max_positions=128)


def test_layout_vocab_and_grammar_are_jaxs():
    layout = [("hello", (10, 20, 90, 40)), ("Sale 50%", (5, 60, 127, 100))]
    tv, jv = ttd2.LayoutVocab(), jtd2.LayoutVocab()
    assert tv.size == jv.size == ttd2.LayoutPlannerConfig().vocab_size
    ids = tv.encode_layout(layout)
    assert ids == jv.encode_layout(layout)
    assert tv.decode_layout(ids) == layout
    bad = ids[:-1] + tv.encode_text("junk") + [tv.SEP, tv.EOS]
    assert tv.decode_layout(bad) == jv.decode_layout(bad)
    np.testing.assert_array_equal(tv.encode_prompt("a poster", 16),
                                  jv.encode_prompt("a poster", 16))
    text = ("### header\nvisit foo.com 1,2,3,4\n\n"
            + ttd2.format_layout_text(layout) + "\nbig 0,0,500,500\nnobox")
    assert ttd2.parse_layout_text(text) == jtd2.parse_layout_text(text)
    for size in (32, 64):
        assert (ttd2.layout_to_pixel_boxes(layout + [("x", (127,) * 4)], size)
                == jtd2.layout_to_pixel_boxes(layout + [("x", (127,) * 4)],
                                              size))
    for a, b in zip(ttd2.planner_example(tv, "sale", layout, 40),
                    jtd2.planner_example(jv, "sale", layout, 40)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def planner():
    jm = jtd2.LayoutPlannerLM(jtd2.LayoutPlannerConfig(**PKW))
    vocab = ttd2.LayoutVocab()
    data = [("a poster of cats", [("cats", (16, 16, 112, 48))]),
            ("sale banner", [("sale", (8, 40, 64, 72)),
                             ("now", (72, 40, 120, 72))])]
    toks, masks = zip(*(ttd2.planner_example(vocab, c, l, 48)
                        for c, l in data))
    tokens, loss_mask = np.stack(toks), np.stack(masks)
    params = draw_params(jm, tokens)
    tm = ttd2.LayoutPlannerLM(ttd2.LayoutPlannerConfig(**PKW), device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm, tokens, loss_mask


def test_planner_logits_loss_and_grads_match_jax(planner):
    """Train mode with PAD keys masked (the examples are right-padded)."""
    jm, params, tm, tokens, loss_mask = planner
    assert (tokens == 0).any()
    want = jax.jit(lambda p: jm.apply({"params": p}, tokens))(params)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jtd2.planner_loss(
        jm, p, tokens, loss_mask)))(params)
    tm.zero_grad()
    with torch.no_grad():
        close(tm(t(tokens).long()), want, 1e-4)
    loss = ttd2.planner_loss(tm, t(tokens).long(), t(loss_mask))
    loss.backward()
    close(loss, jl, 1e-5)
    wg = flax_to_state_dict(jax.device_get(jg))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), wg[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_planner_prefill_decode_and_greedy_tokens_match_jax(planner):
    from unilm_tpu.runtime import generate as jgen

    jm, params, tm, _, _ = planner
    vocab = ttd2.LayoutVocab()
    prompt = vocab.encode_prompt("a poster of cats", 32)
    n = int((prompt != vocab.PAD).sum())
    prompt = prompt[None, :n]
    cache = n + 24
    jpf, jst = map(jax.jit, jtd2.make_planner_fns(jm, cache))
    tpf, tst = ttd2.make_planner_fns(tm, cache)
    jlog, jcache = jpf(params, jnp.asarray(prompt), None)
    tlog, tcache = tpf(t(prompt).long(), None)
    close(tlog, jlog, 1e-4)
    nxt = np.array([[7]], np.int32)
    close(tst(t(nxt).long(), tcache, None)[0],
          jst(params, jnp.asarray(nxt), jcache, None)[0], 1e-4)
    cfg = dict(max_new_tokens=24, eos=vocab.EOS, pad=vocab.PAD)
    want, _ = jgen.greedy_generate(
        jgen.GenerationConfig(**cfg), jpf, jst, params, jnp.asarray(prompt))
    pipe = ttd2.TextDiffuser2Pipeline(
        planner=tm, unet=ttd.TextDiffuserUNet(
            ttd.TextDiffuserConfig(**UKW), device="cpu"),
        prompt_len=32, max_new_tokens=24)
    got, n_valid = pipe.plan_tokens("a poster of cats")
    assert n_valid == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pipe.plan("a poster of cats") == vocab.decode_layout(
        np.asarray(want)[0, n:].tolist())


def test_pipeline_renders_a_planned_layout(planner, unet):
    """The two stages end to end: a sampled plan (from a torch generator,
    so only its validity is checked) and a greedy plan rendered by DDIM."""
    _, _, tm, _, _ = planner
    pipe = ttd2.TextDiffuser2Pipeline(planner=tm, unet=unet[2],
                                      prompt_len=32, max_new_tokens=16)
    g = torch.Generator().manual_seed(0)
    tokens, n = pipe.plan_tokens("sale banner", g, sample=True)
    assert tokens.shape == (1, n + 16)
    assert int(tokens.max()) < pipe.vocab.size and int(tokens.min()) >= 0
    img, layout = pipe("sale banner", torch.Generator().manual_seed(1),
                       steps=3)
    assert img.shape == (1, 16, 16, 3) and torch.isfinite(img).all()
    assert layout == pipe.plan("sale banner")
    boxes = [("sale", (8, 40, 64, 72))]
    z = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(2))
    want = ttd.ddim_sample(unet[2], t(ttd.render_char_mask(
        ttd2.layout_to_pixel_boxes(boxes, 16), 16))[None], steps=3, z=z)
    close(pipe.render(boxes, steps=3, z=z), want.numpy(), 0)
