"""Port parity for the TrOCR fine-tune step: runtime/train.make_train_step
over its `teacher_forced_loss` (TrOCR's teacher-forced forward and the
cross-entropy) against JAX's make_train_step over `TrOCRModel.__call__`
with optax.adamw, on the CPU.

Inputs come from numpy; JAX runs in float32 at matmul precision 'highest'
(tests/conftest.py); the JAX init is moved off its init values (zero cls,
dist and position tokens) by seeded noise. Tolerances, as the other
fine-tune parity tests (tests/test_torch_layoutlmv3.py): losses and grad
norms 1e-5 relative, every parameter within 1e-6 + 1e-5 relative after two
AdamW steps (lr 1e-5, weight decay 0.01, clip 1.0), the key biases (zero
gradient up to rounding) within 5e-5. Labels carry padding,
masked out of the loss, and label smoothing 0.1 as JAX's TrOCR benchmark
step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu.models import trocr as jt
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.models import trocr as tt
from unilm_tpu_torch.runtime import optim as toptim
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(2)

KW = dict(img_size=32, patch_size=16, enc_dim=32, enc_layers=2, enc_heads=4,
          enc_ffn=64, distilled=True, vocab_size=100, dec_dim=48,
          dec_layers=2, dec_heads=4, dec_ffn=96, max_positions=64)
B, T, PAD = 3, 12, 1
LR, WD, CLIP, SMOOTH = 1e-5, 0.01, 1.0, 0.1


def _batch():
    rng = np.random.RandomState(1)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    tokens = rng.randint(4, KW["vocab_size"], (B, T + 1)).astype(np.int32)
    tokens[:, 0] = 0  # bos
    tokens[0, 9:] = PAD
    tokens[2, 5:] = PAD
    return images, tokens


def _jax_params():
    model = jt.TrOCRModel(jt.TrOCRConfig(**KW))
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 2), jnp.int32))["params"])
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda x: np.asarray(x) + (0.05 * rng.randn(
        *x.shape)).astype(np.float32), params)


@pytest.mark.parametrize("smoothing", [0.0, SMOOTH])
def test_train_steps_match_jax(smoothing):
    params = _jax_params()
    images, tokens = _batch()
    jmodel = jt.TrOCRModel(jt.TrOCRConfig(**KW))

    def jloss(p, batch, rng):
        logits = jmodel.apply({"params": p}, batch["images"],
                              batch["tokens"][:, :-1])
        tgt = batch["tokens"][:, 1:]
        s, n = jtrain.cross_entropy_loss(logits, tgt, mask=tgt != PAD,
                                         label_smoothing=smoothing)
        return s / n, {}

    tx = optax.adamw(LR, weight_decay=WD)
    state = jtrain.TrainState.create(params, tx)
    step = jax.jit(jtrain.make_train_step(jloss, tx, clip_grad_norm=CLIP))
    jbatch = {"images": jnp.asarray(images), "tokens": jnp.asarray(tokens)}
    jm = []
    for i in range(2):
        state, m = step(state, jbatch, jax.random.PRNGKey(i))
        jm.append({k: float(v) for k, v in m.items()})
    want = flax_to_state_dict(jax.device_get(state.params))

    model = tt.TrOCRModel(tt.TrOCRConfig(**KW), device="cpu").train()
    load_flax_params(model, params)
    ttx = toptim.AdamW(LR, weight_decay=WD)
    tstate = ttrain.TrainState.create(model, ttx)
    tstep = ttrain.make_train_step(
        lambda m, b: ttrain.teacher_forced_loss(
            m, b, label_smoothing=smoothing, pad=PAD),
        ttx, clip_grad_norm=CLIP)
    tbatch = {"images": torch.from_numpy(images),
              "tokens": torch.from_numpy(tokens).long()}
    for i in range(2):
        tstate, m = tstep(tstate, tbatch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jm[i][k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    # the key biases' gradient is zero but for rounding (a key bias shifts
    # every score of a row alike), and Adam turns that noise into steps of
    # up to lr each: they are held to 5e-5 (2.5x two steps at lr 1e-5), as
    # tests/test_torch_beit_train.py holds them
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), want[name].numpy(),
            atol=5e-5 if name.endswith("k_proj.bias") else 1e-6, rtol=1e-5,
            err_msg=name)


def test_train_loss_without_pad_scores_every_target():
    """Without `pad` every target counts, as JAX's benchmark step's loss."""
    params = _jax_params()
    images, tokens = _batch()
    model = tt.TrOCRModel(tt.TrOCRConfig(**KW), device="cpu").eval()
    load_flax_params(model, params)
    batch = {"images": torch.from_numpy(images),
             "tokens": torch.from_numpy(tokens).long()}
    with torch.no_grad():
        loss, metrics = ttrain.teacher_forced_loss(model, batch)
        logits = model(batch["images"], batch["tokens"][:, :-1])
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, KW["vocab_size"]),
        batch["tokens"][:, 1:].reshape(-1))
    assert metrics == {}
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_dropout_step_draws_from_the_generator():
    """At the config's dropout a training step needs a generator; two steps
    from one seed are equal, from another seed differ."""
    params = _jax_params()
    images, tokens = _batch()
    batch = {"images": torch.from_numpy(images),
             "tokens": torch.from_numpy(tokens).long()}
    losses = []
    for seed in (3, 3, 4):
        model = tt.TrOCRModel(tt.TrOCRConfig(**KW, dropout=0.1),
                              device="cpu").train()
        load_flax_params(model, params)
        loss, _ = ttrain.teacher_forced_loss(
            model, batch, torch.Generator().manual_seed(seed), pad=PAD)
        losses.append(float(loss.detach()))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="generator"):
        ttrain.teacher_forced_loss(model, batch, pad=PAD)
