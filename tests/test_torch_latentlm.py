"""Port parity for models/latentlm.py (the σ-VAE, the cosine schedule, the
diffusion head, LatentLM's train forward, its gradients and DDIM) against
unilm_tpu on the CPU.

Sizes: tests/test_latentlm.py's (a 2-layer decoder of width 32, 4 heads,
vocab 50, latents of 4; a VAE of channels (8, 16) over 16 px images).
Parameters come from `jax.eval_shape` of the flax init plus a seeded numpy
draw, loaded through convert/from_jax.py; JAX's own draws (t, the noise,
the posterior's noise, DDIM's z) are replayed into the port. Float32 on
both sides, JAX at matmul precision 'highest' under jax.jit. Tolerances:
the schedule and embeddings 1e-6; the VAE and the train forward 1e-5;
gradients 1e-5 abs + 1e-4 relative; DDIM 1e-3 of the output's largest
magnitude (relative: the first step divides by sqrt(ᾱ(1)) ~ 4.4e-8, so
float32 rounding of ~1e-7 grows to ~1e-5 of ~1e7-1e8 latents).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import latentlm as jl
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.models import latentlm as tl

from test_torch_seq2seq import close, draw_params, t

torch.set_num_threads(1)

LKW = dict(vocab_size=50, embed_dim=32, num_layers=2, num_heads=4,
           ffn_dim=64, latent_dim=4, use_flash=False)
B, T, Q = 2, 12, 3


def _inputs():
    tokens = np.random.RandomState(0).randint(4, 50, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), bool)
    mask[:, [3, 4, 5]] = True
    latents = np.random.RandomState(1).randn(B, Q, 4).astype(np.float32)
    return tokens, mask, latents


@pytest.fixture(scope="module")
def lm():
    jm = jl.LatentLM(jl.LatentLMConfig(**LKW))
    tokens, mask, latents = _inputs()
    params = draw_params(jm, tokens, latents, mask, jax.random.PRNGKey(3))
    tm = tl.LatentLM(tl.LatentLMConfig(**LKW), device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm


def test_schedule_and_timestep_embedding_match_jax():
    ts = np.linspace(0, 1, 11).astype(np.float32)
    close(tl.cosine_alpha_bar(t(ts)), jl.cosine_alpha_bar(jnp.asarray(ts)),
          1e-6)
    ab = tl.cosine_alpha_bar(t(ts)).numpy()
    assert ab[0] > 0.99 and ab[-1] < 0.01 and (np.diff(ab) < 0).all()
    tt = np.random.RandomState(2).rand(3, 5).astype(np.float32)
    close(tl.timestep_embedding(t(tt), 64),
          jl.timestep_embedding(jnp.asarray(tt), 64), 1e-6)


def test_sigma_vae_matches_jax_with_its_posterior_noise():
    cfg = dict(latent_dim=4, channels=(8, 16), sigma=0.1)
    jv = jl.SigmaVAE(jl.SigmaVAEConfig(**cfg))
    imgs = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    params = draw_params(jv, imgs, key)
    tv = tl.SigmaVAE(tl.SigmaVAEConfig(**cfg), device="cpu")
    load_flax_params(tv, params)
    recon, rloss, kl = jax.jit(lambda p: jv.apply({"params": p}, imgs, key)
                               )(params)
    mean = jax.jit(lambda p: jv.apply({"params": p}, imgs,
                                      method=jv.encode))(params)
    noise = np.asarray(jax.random.normal(key, mean.shape))
    with torch.no_grad():
        z = tv.encode(t(imgs))
        assert z.shape == (2, 4, 4, 4)
        close(z, mean, 1e-5)
        got = tv(t(imgs), noise=t(noise))
    close(got[0], recon, 1e-5)
    close(got[1], rloss, 1e-5)
    close(got[2], kl, 1e-5)
    assert float(got[1]) > 0 and float(got[2]) > 0


def test_diffusion_head_matches_jax():
    jh = jl.DiffusionHead(4)
    rng = np.random.RandomState(4)
    z = rng.randn(2, 3, 4).astype(np.float32)
    tt = rng.rand(2, 3).astype(np.float32)
    cond = rng.randn(2, 3, 32).astype(np.float32)
    params = draw_params(jh, z, tt, cond)
    th = tl.DiffusionHead(4, 32)
    load_flax_params(th, params)
    with torch.no_grad():
        close(th(t(z), t(tt), t(cond)),
              jh.apply({"params": params}, z, tt, cond), 1e-5)


def _jax_draws(key):
    r1, r2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(r1, (B, Q))),
            np.asarray(jax.random.normal(r2, (B, Q, 4))))


def test_train_forward_matches_jax_with_its_draws(lm):
    jm, params, tm = lm
    tokens, mask, latents = _inputs()
    key = jax.random.PRNGKey(4)
    jlog, jd = jax.jit(lambda p: jm.apply({"params": p}, tokens, latents,
                                          mask, key))(params)
    tt, noise = _jax_draws(key)
    with torch.no_grad():
        log, d = tm(t(tokens).long(), t(latents), t(mask), t=t(tt),
                    noise=t(noise))
        assert log.shape == (B, T, 50) and log.dtype == torch.float32
        close(log, jlog, 1e-5)
        close(d, jd, 1e-5)
        # the draws come from a generator when not given
        g = torch.Generator().manual_seed(0)
        _, d1 = tm(t(tokens).long(), t(latents), t(mask), g)
        g = torch.Generator().manual_seed(0)
        _, d2 = tm(t(tokens).long(), t(latents), t(mask), g)
    assert float(d1) == float(d2) and np.isfinite(float(d1))


def test_conditioning_takes_the_state_before_each_slot(lm):
    """Slots at different positions in each row: the k-th slot's condition
    is h at its position - 1 (JAX's scatter-by-order), checked through
    the head's input."""
    _, _, tm = lm
    tokens, _, latents = _inputs()
    mask = np.zeros((B, T), bool)
    mask[0, [1, 5, 9]] = True
    mask[1, [2, 3, 11]] = True
    seen = {}
    hook = tm.diffusion_head.register_forward_pre_hook(
        lambda m, args: seen.update(c=args[2]))
    try:
        with torch.no_grad():
            tm(t(tokens).long(), t(latents), t(mask),
               torch.Generator().manual_seed(0))
            h = tm.backbone(t(tokens).long(), t(latents), t(mask))
    finally:
        hook.remove()
    for b in range(B):
        pos = np.nonzero(mask[b])[0]
        close(seen["c"][b], h[b, pos - 1], 0)


def test_gradients_match_jax(lm):
    jm, params, tm = lm
    tokens, mask, latents = _inputs()
    key = jax.random.PRNGKey(5)

    def loss(p):
        lg, dl = jm.apply({"params": p}, tokens, latents, mask, key)
        return dl + 0.01 * jnp.mean(lg ** 2)

    jl_, jg = jax.jit(jax.value_and_grad(loss))(params)
    tt, noise = _jax_draws(key)
    tm.zero_grad()
    lg, dl = tm(t(tokens).long(), t(latents), t(mask), t=t(tt),
                noise=t(noise))
    got = dl + 0.01 * torch.mean(lg ** 2)
    got.backward()
    close(got, jl_, 1e-5)
    want = flax_to_state_dict(jax.device_get(jg))
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert float(tm.diffusion_head.fc1.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("steps", [8, 20])
def test_ddim_matches_jax_relatively(lm, steps):
    jm, params, tm = lm
    cond = np.random.RandomState(5).randn(B, 32).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, cond, key, steps, method=jm.sample_latent))(params))
    z0 = np.asarray(jax.random.normal(key, (B, 4)))
    got = tm.sample_latent(t(cond), z=t(z0), steps=steps).numpy()
    assert got.shape == (B, 4)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale


def test_ddim_amplification_of_the_reference_is_pinned():
    """At tests/test_latentlm.py's own config and init, the sampler starts
    at ᾱ(1) ~ 1.9e-15 and returns latents past 1e6 in JAX and in the port
    alike: the reference's fault, reproduced and not clamped."""
    assert float(tl.cosine_alpha_bar(torch.tensor(1.0))) < 1e-14
    jm = jl.LatentLM(jl.LatentLMConfig(**LKW))
    tokens, mask, latents = _inputs()
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), tokens, latents, mask,
                              jax.random.PRNGKey(3))["params"]
    tm = tl.LatentLM(tl.LatentLMConfig(**LKW), device="cpu")
    load_flax_params(tm, jax.device_get(params))
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (B, 32)))
    key = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, cond, key, 8, method=jm.sample_latent))(params))
    got = tm.sample_latent(t(cond), z=t(np.asarray(jax.random.normal(
        key, (B, 4)))), steps=8).numpy()
    assert np.abs(want).max() > 1e6 and np.abs(got).max() > 1e6
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
