"""Port parity for BEiT fine-tuning and pretraining: unilm_tpu_torch's train
step (layer-decay AdamW, cosine warmup, EMA, clipping) on
BeitForImageClassification, LAMB and SGD, the mixup/cutmix apply, the
random resized crop, MaskingGenerator, BeitForMaskedImageModeling and its
converter, DropPath and remat, and the cli.train_classification loop,
against unilm_tpu on the CPU.

A 2-layer BEiT (E=64, 2 heads, 32x32 images, patch 8, 10 classes, fp32)
is initialised by the JAX model with its rel-pos tables and LayerScale
filled with random values, and carried across by convert/from_jax.py;
inputs come from numpy, and the mixed batches are JAX's `mixup_cutmix`
output (which the port's apply reproduces from JAX's draws). Tolerances:
- losses and grad norms 1e-5 relative, parameters and EMA after three
  updates 1e-5 absolute: the same fp32 math in another order (readings
  ~1e-7). The key biases' gradient is zero but for rounding; under the
  warmup's small first steps that noise moves nothing, but the MIM step
  runs at lr 1e-3 from its first update, where Adam turns it into steps
  of up to ~1e-4, so there those biases are held to 5e-4;
- one LAMB and one SGD update 1e-6 absolute (elementwise arithmetic and
  norms only);
- mixup/cutmix images and soft targets 1e-6 absolute (the same float32
  scalars; XLA may fuse the blend into an FMA); the crop, the flip and the
  masks bit-equal (the same Python, numpy and PIL calls);
- MIM logits 1e-4 absolute, as tests/test_torch_beit.py holds the
  classifier's.
"""

import functools
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu.cli import train_classification as jcl
from unilm_tpu.convert.beit import convert_beit as jconvert
from unilm_tpu.data import masking as jmask
from unilm_tpu.data import transforms as jt
from unilm_tpu.models import beit as jb
from unilm_tpu.runtime import optim as joptim
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.cli import train_classification as tcl
from unilm_tpu_torch.convert.beit import convert_beit
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.core import layers as tlayers
from unilm_tpu_torch.data import masking as tmask
from unilm_tpu_torch.data import transforms as tt
from unilm_tpu_torch.models import beit as tb
from unilm_tpu_torch.runtime import optim as toptim
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(1)

TINY = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
            num_layers=2, num_heads=2, ffn_dim=128, use_flash=False)
B, LR, TOTAL, WARMUP = 4, 1e-3, 10, 2


def _randomize(tree, rng, names=("relative_position_bias_table", "gamma")):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, names)
        elif k in names:
            out[k] = rng.uniform(-1, 1, size=v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_classifier():
    jm = jb.BeitForImageClassification(jb.BeitConfig(**TINY))
    x = jnp.zeros((1, 32, 32, 3))
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    return jm, _randomize(jax.device_get(params), np.random.RandomState(1))


def _jax_draws(key, H, W, mixup_alpha=0.8, cutmix_alpha=1.0):
    """The draws of the JAX `mixup_cutmix` for `key` (its own split)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return tt.MixDraw(
        use_cutmix=bool(jax.random.bernoulli(k1, 0.5)),
        lam_mix=float(jax.random.beta(k2, mixup_alpha, mixup_alpha)),
        lam_cut=float(jax.random.beta(k3, cutmix_alpha, cutmix_alpha)),
        cy=int(jax.random.randint(k4, (), 0, H)),
        cx=int(jax.random.randint(k4, (), 0, W)))


def _mixed(step):
    """Step `step`'s images and labels, mixed by JAX's mixup_cutmix (and
    by the port's apply on JAX's draws, which must agree)."""
    rng = np.random.RandomState(10 + step)
    imgs = rng.rand(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, B)
    key = jax.random.PRNGKey(100 + step)
    jx, jsoft = jt.mixup_cutmix(key, jnp.asarray(imgs), jnp.asarray(labels),
                                10)
    tx, tsoft = tt.apply_mixup_cutmix(torch.from_numpy(imgs),
                                      torch.from_numpy(labels), 10,
                                      _jax_draws(key, 32, 32))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(jsoft), atol=1e-6)
    return np.array(jx), np.array(jsoft)


def test_train_steps_match_jax():
    """Three updates of the fine-tune step: soft-target CE on pre-mixed
    batches, clip 0.5, layer-decay AdamW (0.9) with weight decay over a
    cosine schedule with warmup, EMA 0.9."""
    jm, params = _jax_classifier()
    sched = joptim.cosine_schedule(LR, TOTAL, warmup_steps=WARMUP)
    jtx = joptim.create_optimizer(params, sched, weight_decay=0.05,
                                  layer_decay=0.9, num_layers=2)

    def jloss(p, batch, rng):
        return jcl.soft_cross_entropy(
            jm.apply({"params": p}, batch["x"]), batch["soft"]), {}

    jstate = jtrain.TrainState.create(params, jtx, ema=True)
    jstep = jax.jit(jtrain.make_train_step(jloss, jtx, ema_decay=0.9,
                                           clip_grad_norm=0.5))

    tm = tb.BeitForImageClassification(tb.BeitConfig(**TINY))
    load_flax_params(tm, params)
    tm.train()
    ttx = toptim.create_optimizer(
        list(tm.named_parameters()), toptim.cosine_schedule(
            LR, TOTAL, warmup_steps=WARMUP),
        weight_decay=0.05, layer_decay=0.9, num_layers=2)
    tstate = ttrain.TrainState.create(tm, ttx, ema=True)
    tstep = ttrain.make_train_step(
        lambda m, b: (tcl.soft_cross_entropy(m(b["x"]), b["soft"]), {}), ttx,
        ema_decay=0.9, clip_grad_norm=0.5)

    clipped = 0
    for i in range(3):
        x, soft = _mixed(i)
        jstate, jm_ = jstep(jstate, {"x": jnp.asarray(x),
                                     "soft": jnp.asarray(soft)},
                            jax.random.PRNGKey(i))
        tstate, tm_ = tstep(tstate, {"x": torch.from_numpy(x),
                                     "soft": torch.from_numpy(soft)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        clipped += float(jm_["grad_norm"]) > 0.5
    assert clipped, "no step exercised the clip"
    want = flax_to_state_dict(jax.device_get(jstate.params))
    want_ema = flax_to_state_dict(jax.device_get(jstate.ema_params))
    names = [n for n, _ in tm.named_parameters()]
    for name, p, e in zip(names, ttrain.trainable(tm), tstate.ema_params):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(),
                                   atol=1e-5, err_msg=f"ema {name}")
    moved = flax_to_state_dict(params)
    assert any(not np.allclose(want[n].numpy(), moved[n].numpy())
               for n in names)


def test_layer_decay_scales_match_jax_with_the_rel_pos_quirk():
    """Per-parameter scales equal JAX's per leaf. The reference quirk is
    kept: each per-layer rel-pos table sits outside `layers_i`, so both
    tables get layer id num_layers (upstream BEiT: i + 1)."""
    _, params = _jax_classifier()
    L, decay = 2, 0.9
    jscales = joptim.layer_decay_scales(params, decay, L)
    full = jax.tree.map(lambda s, p: np.full(np.shape(p), s, np.float32),
                        jscales, params)
    want = {n: float(t.reshape(-1)[0])
            for n, t in flax_to_state_dict(full).items()}
    tm = tb.BeitForImageClassification(tb.BeitConfig(**TINY))
    named = list(tm.named_parameters())
    got = dict(zip([n for n, _ in named],
                   toptim.layer_decay_scales(named, decay, L)))
    assert set(got) == set(want)
    for n in got:
        assert got[n] == pytest.approx(want[n], rel=1e-6), n
    for i in range(L):
        table = f"backbone.rel_pos_bias_{i}.relative_position_bias_table"
        assert got[table] == pytest.approx(decay ** 1)  # id L, not i + 1
    assert got["backbone.embeddings.cls_token"] == pytest.approx(decay ** 3)
    assert got["backbone.encoder.layers.0.ffn.fc1.weight"] == \
        pytest.approx(decay ** 2)
    assert got["head.weight"] == 1.0


@pytest.mark.parametrize("optimizer", ["lamb", "sgd"])
def test_lamb_and_sgd_match_optax(optimizer):
    """Two updates of the lamb (trust ratio, with a zero parameter for its
    zero-norm rule) and the sgd (momentum trace) branches, with layer decay
    and the optimizer's own global-norm clip, against create_optimizer's
    optax chains."""
    rng = np.random.RandomState(4)
    tree = {"backbone": {
        "embeddings": {"cls_token": rng.randn(1, 1, 8).astype(np.float32)},
        "encoder": {f"layers_{i}": {"fc": {
            "kernel": rng.randn(8, 6).astype(np.float32),
            "bias": np.zeros(6, np.float32)}} for i in range(2)}},
        "head": {"kernel": rng.randn(8, 3).astype(np.float32),
                 "bias": rng.randn(3).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32),
                          tree) for _ in range(2)]
    kw = dict(optimizer=optimizer, weight_decay=0.05, layer_decay=0.75,
              num_layers=2, clip_grad_norm=2.0)
    jtx = joptim.create_optimizer(tree, 0.1, **kw)
    jparams, jst = tree, jtx.init(tree)
    for g in grads:
        upd, jst = jtx.update(g, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)

    sd = flax_to_state_dict(tree)
    names = sorted(sd)
    params = [sd[n].clone() for n in names]
    ttx = toptim.create_optimizer(list(zip(names, params)), 0.1, **kw)
    state = ttx.init(params)
    for g in grads:
        gsd = flax_to_state_dict(g)
        ttx.update([gsd[n] for n in names], state, params)
    want = flax_to_state_dict(jax.device_get(jparams))
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), atol=1e-6,
                                   err_msg=n)


def _find_key(use_cutmix: bool):
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if _jax_draws(key, 32, 32).use_cutmix == use_cutmix:
            return key
    raise AssertionError("no key")


@pytest.mark.parametrize("branch", ["mixup", "cutmix"])
@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_mixup_cutmix_apply_matches_jax(branch, hw):
    """The port's apply on JAX's draws gives JAX's mixed images and soft
    targets, in both branches; the reference's cy == cx for square images
    holds in JAX and in the port's own draw."""
    H, W = hw
    key = _find_key(branch == "cutmix")
    rng = np.random.RandomState(7)
    imgs = rng.rand(6, H, W, 3).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    jx, jsoft = jt.mixup_cutmix(key, jnp.asarray(imgs), jnp.asarray(labels),
                                5, label_smoothing=0.2)
    draw = _jax_draws(key, H, W)
    assert draw.use_cutmix == (branch == "cutmix")
    tx, tsoft = tt.apply_mixup_cutmix(torch.from_numpy(imgs),
                                      torch.from_numpy(labels), 5, draw,
                                      label_smoothing=0.2)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(jsoft), atol=1e-6)
    if H == W:  # the reference draws cy and cx from one key
        assert draw.cy == draw.cx
        for seed in range(5):
            own = tt.draw_mixup_cutmix(torch.Generator().manual_seed(seed),
                                       H, W)
            assert own.cy == own.cx and 0 <= own.cy < H
    a = tt.draw_mixup_cutmix(torch.Generator().manual_seed(3), H, W)
    assert a == tt.draw_mixup_cutmix(torch.Generator().manual_seed(3), H, W)


def test_crop_and_flip_match_jax():
    """RandomResizedCropWithTwoPic (one and two views, and the centre-crop
    fallback of an image no box fits) and random_hflip under one seeded
    random.Random give JAX's arrays."""
    from PIL import Image

    rng = np.random.RandomState(8)
    for size, (h, w), kw in ((24, (50, 37), {}),
                             (16, (40, 44), {"second_size": 8}),
                             (16, (120, 9), {"scale": (0.9, 1.0),
                                             "ratio": (1.0, 1.0)})):
        img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        jc = jt.RandomResizedCropWithTwoPic(size, rng=random.Random(5), **kw)
        tc = tt.RandomResizedCropWithTwoPic(size, rng=random.Random(5), **kw)
        for _ in range(3):
            a, b = jc(img), tc(img)
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(x, y)
        ja, ta = random.Random(2), random.Random(2)
        for _ in range(4):
            np.testing.assert_array_equal(
                np.asarray(jt.random_hflip(img, ja)),
                np.asarray(tt.random_hflip(img, ta)))


def test_masking_generator_matches_jax():
    jg = jmask.MaskingGenerator((14, 14), 75, rng=np.random.default_rng(0))
    tg = tmask.MaskingGenerator((14, 14), 75, rng=np.random.default_rng(0))
    for _ in range(6):
        m = tg()
        np.testing.assert_array_equal(m, jg())
        assert m.shape == (14, 14) and 0 < m.sum() <= 75


MIM = dict(TINY, vocab_size=50, use_rel_pos_bias=False,
           use_shared_rel_pos_bias=True)


def test_mim_logits_and_step_match_jax():
    """BeitForMaskedImageModeling (shared rel-pos bias, mask token, norm
    and lm_head): logits, then one clipped AdamW step of the masked CE."""
    rng = np.random.RandomState(9)
    imgs = rng.randn(3, 32, 32, 3).astype(np.float32)
    masks = np.stack([tmask.MaskingGenerator(
        4, 6, min_num_patches=2, rng=np.random.default_rng(s))().reshape(-1)
        for s in range(3)]).astype(bool)
    targets = rng.randint(0, 50, (3, 16))
    jm = jb.BeitForMaskedImageModeling(jb.BeitConfig(**MIM))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs),
                     jnp.asarray(masks))["params"]
    params = _randomize(jax.device_get(params), rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(imgs),
                               jnp.asarray(masks)))
    tm = tb.BeitForMaskedImageModeling(tb.BeitConfig(**MIM))
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs), torch.from_numpy(masks))
    assert tuple(got.shape) == (3, 16, 50)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    def jloss(p, batch, rng_):
        logits = jm.apply({"params": p}, batch["x"], batch["mask"])
        s, n = jtrain.cross_entropy_loss(logits, batch["y"],
                                         mask=batch["mask"])
        return s / n, {}

    jtx = joptim.create_optimizer(params, 1e-3, weight_decay=0.05)
    jstate, jmet = jax.jit(jtrain.make_train_step(jloss, jtx,
                                                  clip_grad_norm=3.0))(
        jtrain.TrainState.create(params, jtx),
        {"x": jnp.asarray(imgs), "mask": jnp.asarray(masks),
         "y": jnp.asarray(targets)}, jax.random.PRNGKey(0))

    def tloss(m, batch):
        s, n = ttrain.cross_entropy_loss(m(batch["x"], batch["mask"]),
                                         batch["y"], mask=batch["mask"])
        return s / n, {}

    tm.train()
    ttx = toptim.create_optimizer(list(tm.named_parameters()), 1e-3,
                                  weight_decay=0.05)
    tstate, tmet = ttrain.make_train_step(tloss, ttx, clip_grad_norm=3.0)(
        ttrain.TrainState.create(tm, ttx),
        {"x": torch.from_numpy(imgs), "mask": torch.from_numpy(masks),
         "y": torch.from_numpy(targets)})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    # the key biases' gradient is zero but for rounding (a key bias shifts
    # every score of a row alike), and at lr 1e-3 from the first update
    # Adam turns that noise into steps of up to ~1e-4: they are held to
    # 5e-4; every other parameter to 1e-5
    wsd = flax_to_state_dict(jax.device_get(jstate.params))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), wsd[n].numpy(),
                                   atol=5e-4 if "k_proj.bias" in n else 1e-5,
                                   err_msg=n)


def test_mim_timm_checkpoint_converts_like_jax():
    """A timm-style pretraining state dict (lm_head, its norm, mask_token,
    the shared rel-pos table) converts to the same tensors as the JAX
    converter's flax tree, and loads strictly into the MIM model."""
    cfg = tb.BeitConfig(**MIM)
    E, L, rng = 64, 2, np.random.RandomState(11)
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    sd = {"cls_token": r(1, 1, E), "mask_token": r(1, 1, E),
          "patch_embed.proj.weight": r(E, 3, 8, 8),
          "patch_embed.proj.bias": r(E),
          "rel_pos_bias.relative_position_bias_table": r(7 * 7 + 3, 2),
          "norm.weight": r(E), "norm.bias": r(E),
          "lm_head.weight": r(50, E), "lm_head.bias": r(50)}
    for i in range(L):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": r(E), f"{p}.norm1.bias": r(E),
                   f"{p}.norm2.weight": r(E), f"{p}.norm2.bias": r(E),
                   f"{p}.attn.qkv.weight": r(3 * E, E),
                   f"{p}.attn.q_bias": r(E), f"{p}.attn.v_bias": r(E),
                   f"{p}.attn.proj.weight": r(E, E),
                   f"{p}.attn.proj.bias": r(E),
                   f"{p}.mlp.fc1.weight": r(128, E),
                   f"{p}.mlp.fc1.bias": r(128),
                   f"{p}.mlp.fc2.weight": r(E, 128), f"{p}.mlp.fc2.bias": r(E),
                   f"{p}.gamma_1": r(E), f"{p}.gamma_2": r(E)})
    got = convert_beit(sd, cfg)
    want = flax_to_state_dict(jconvert(sd, jb.BeitConfig(**MIM)))
    assert set(got) == set(want)
    for n in got:
        np.testing.assert_array_equal(got[n].numpy(), want[n].numpy(),
                                      err_msg=n)
    tb.BeitForMaskedImageModeling(cfg).load_state_dict(got, strict=True)


def test_drop_path_with_a_given_mask_and_remat_gradients():
    """DropPath applies the flags it is given (x / keep, or 0, in x's
    dtype); the encoder draws [L, 2, B] flags with layer 0 never dropping;
    with drop-path 0.5, the gradients with and without cfg.remat are
    equal, since the flags are drawn before any layer runs."""
    dp = tlayers.DropPath(0.25).train()
    x = torch.randn(3, 5, 4, dtype=torch.bfloat16)
    keep = torch.tensor([True, False, True])
    want = torch.where(keep[:, None, None], x / 0.75, 0.0)
    got = dp(x, keep)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(dp.eval()(x), x)

    grads = []
    for remat in (False, True):
        cfg = tb.BeitConfig(**dict(TINY, drop_path_rate=0.5, remat=remat))
        m = tb.BeitForImageClassification(cfg).train()
        m.init_weights(torch.Generator().manual_seed(0))
        flags = m.backbone.encoder.draw_drop_path(
            6, torch.Generator().manual_seed(1))
        assert flags.shape == (2, 2, 6) and bool(flags[0].all())
        assert not bool(flags[1].all())  # rate 0.5 drops some sample here
        x = torch.from_numpy(np.random.RandomState(2).rand(6, 32, 32, 3)
                             .astype(np.float32))
        m(x, torch.Generator().manual_seed(1)).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
    cfg = tb.BeitConfig(**dict(TINY, drop_path_rate=0.5, remat=True,
                               remat_policy="dots"))
    m = tb.BeitForImageClassification(cfg).train()
    m.init_weights(torch.Generator().manual_seed(0))
    m(x, torch.Generator().manual_seed(1)).square().sum().backward()
    for name, p in m.named_parameters():
        torch.testing.assert_close(p.grad, grads[0][name], atol=1e-6, rtol=0,
                                   msg=name)


def _tiny_registry(monkeypatch):
    monkeypatch.setattr(tb, "beit_tiny_test",
                        lambda **kw: tb.BeitConfig(**{**TINY, **kw}),
                        raising=False)


def _png_folder(root):
    from PIL import Image

    rng = np.random.RandomState(12)
    for c in ("cat", "dog"):
        os.makedirs(os.path.join(root, c))
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (40, 48, 3)).astype(
                np.uint8)).save(os.path.join(root, c, f"{i}.png"))


class _Stop(Exception):
    pass


def test_cli_resume_is_bit_equal(tmp_path, monkeypatch):
    """main() on a PNG folder at --device cpu: 4 steps straight against 2,
    save, a crash, resume, 2 more, bit-equal (params, EMA, optimizer
    state); the default --device cuda raises without a card."""
    _tiny_registry(monkeypatch)
    data = str(tmp_path / "imgs")
    _png_folder(data)
    base = ["--model", "beit_tiny_test", "--data_path", data, "--device",
            "cpu", "--no-bf16", "--batch_size", "2", "--epochs", "1",
            "--warmup_epochs", "0", "--lr", "1e-3", "--clip_grad", "3.0",
            "--drop_path", "0.5", "--ema_decay", "0.99", "--save_every", "2"]
    straight = tcl.main(base + ["--output_dir", str(tmp_path / "a")])
    assert straight.step == 4

    build = tcl.build_trainer

    def crashing(args, items=None, use_flash=True):
        tr = build(args, items, use_flash)
        real = tr.next_batch

        def next_batch(step):
            if step == 2:
                raise _Stop
            return real(step)

        tr.next_batch = next_batch
        return tr

    monkeypatch.setattr(tcl, "build_trainer", crashing)
    with pytest.raises(_Stop):
        tcl.main(base + ["--output_dir", str(tmp_path / "b")])
    monkeypatch.setattr(tcl, "build_trainer", build)
    resumed = tcl.main(base + ["--output_dir", str(tmp_path / "b")])
    assert resumed.step == 4
    a, b = straight.state_dict(), resumed.state_dict()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["ema_params"], b["ema_params"]):
        assert torch.equal(x, y)
    for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert torch.equal(x, y)
    init = tcl.build_trainer(tcl.build_parser().parse_args(
        base + ["--output_dir", str(tmp_path / "c")]))
    assert any(not torch.equal(p, a["model"][n])
               for n, p in init.model.state_dict().items())

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tcl.build_parser().parse_args(["--data_path", data])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device cpu"):
        tcl.build_trainer(args)


def test_random_init_ignores_seed_as_jax_does(monkeypatch):
    """Without --checkpoint the weights are seeded 0 whatever --seed, as
    the JAX CLI's PRNGKey(0) init (cli/run_class_finetuning.py
    `load_params`); --seed still drives the stream and the draws."""
    _tiny_registry(monkeypatch)
    items = [(f"x/{i}", i % 2) for i in range(8)]
    models = []
    for seed in ("0", "7"):
        args = tcl.build_parser().parse_args([
            "--model", "beit_tiny_test", "--data_path", "unused", "--device",
            "cpu", "--no-bf16", "--batch_size", "2", "--seed", seed])
        models.append(tcl.build_trainer(args, items))
    a, b = (t.model.state_dict() for t in models)
    assert all(torch.equal(a[k], b[k]) for k in a)
    first = [[next(t.stream) for _ in range(4)] for t in models]
    assert first[0] != first[1]
