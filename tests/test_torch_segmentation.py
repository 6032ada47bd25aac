"""Port parity for BEiT UperNet segmentation: unilm_tpu_torch's
models/segmentation.py, scoring_segmentation.py and
cli/train_segmentation.py against unilm_tpu's on the CPU.

Inputs come from numpy seeds; JAX runs jitted in float32 at matmul
precision 'highest' (tests/conftest.py), the port in float32; weights go
from JAX to the port through convert/from_jax.py. The model: 4 layers of
width 64 at 64 px, UperNet channels 64, aux channels 32, 5 classes.
Tolerances, with their reasons:
- `_resize` against jax.image.resize: 1e-6 abs at every factor the
  model takes (x2, x4, x8, the PPM's bins to the map, the identity):
  the same two-tap interpolation in fp32;
- the logits and the aux logits: 1e-4 abs (fp32 through four layers,
  GroupNorms and the resizes, summed in other orders);
- segmentation_loss: 1e-6 relative, its gradient with respect to the
  logits 1e-6 relative + 1e-9 abs (fp32 softmax probabilities of
  ~1e-8 differ in their last bits); mIoU equal to JAX's scorer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rcnn import close, draw, port_cfg, t
from unilm_tpu import scoring_segmentation as jss
from unilm_tpu.models import segmentation as jseg
from unilm_tpu.models.beit import BeitConfig
from unilm_tpu_torch import scoring_segmentation as tss
from unilm_tpu_torch.cli import train_segmentation as tcli
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.models import segmentation as tseg

torch.set_num_threads(2)


@pytest.mark.parametrize("src,dst", [(4, 8), (4, 16), (2, 16), (8, 64),
                                     (1, 4), (3, 4), (4, 4), (6, 32)])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(src * dst).randn(2, src, src, 3).astype(
        np.float32)
    want = jax.image.resize(x, (2, dst, dst, 3), method="bilinear")
    close(tseg._resize(t(x), (dst, dst)), want, 1e-6)


def test_upernet_matches_jax():
    beit = BeitConfig(img_size=64, embed_dim=64, num_layers=4, num_heads=4,
                      ffn_dim=128, use_mean_pooling=False)
    cfg = jseg.UperNetConfig(beit=beit, num_classes=5,
                             out_indices=(0, 1, 2, 3), channels=64,
                             aux_channels=32)
    jm = jseg.BeitForSemanticSegmentation(cfg)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    params = draw(jm, jnp.asarray(x), return_aux=True)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x, return_aux=True))(
        params, jnp.asarray(x))
    pm = tseg.BeitForSemanticSegmentation(port_cfg(cfg), device="cpu").eval()
    load_flax_params(pm, params)
    with torch.no_grad():
        got = pm(t(x), return_aux=True)
        plain = pm(t(x))
    assert got[0].shape == (2, 64, 64, 5) == got[1].shape
    close(got[0], want[0], 1e-4)
    close(got[1], want[1], 1e-4)
    close(plain, got[0], 0)


def test_segmentation_loss_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 8, 8, 5).astype(np.float32) * 3
    aux = rng.randn(2, 8, 8, 5).astype(np.float32)
    labels = rng.randint(0, 5, (2, 8, 8))
    labels[rng.rand(2, 8, 8) < 0.3] = 255

    def jloss(lg, ax):
        return jseg.segmentation_loss(lg, labels, ax, aux_weight=0.4)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, (0, 1), has_aux=True))(
        logits, aux)
    tl_ = t(logits).requires_grad_()
    ta = t(aux).requires_grad_()
    tl, tm = tseg.segmentation_loss(tl_, t(labels), ta, aux_weight=0.4)
    tl.backward()
    close(tl, jl, 0, 1e-6)
    for k in jm:
        close(tm[k], jm[k], 0, 1e-6)
    close(tl_.grad, jg[0], 1e-9, 1e-6)
    close(ta.grad, jg[1], 1e-9, 1e-6)
    # every label ignored: the loss is 0, not nan
    none = tseg.segmentation_loss(t(logits), t(np.full_like(labels, 255)))[0]
    assert float(none) == 0.0


def test_miou_matches_jax():
    rng = np.random.RandomState(2)
    preds = [rng.randint(0, 6, (16, 16)) for _ in range(3)]
    labels = [np.where(rng.rand(16, 16) < 0.1, 255, rng.randint(0, 6, (16, 16)))
              for _ in range(3)]
    assert tss.evaluate_segmentation(preds, labels, 6) == \
        jss.evaluate_segmentation(preds, labels, 6)
    raw = rng.randint(0, 4, (5, 5)).astype(np.uint8)
    np.testing.assert_array_equal(tss.reduce_zero_label(raw),
                                  jss.reduce_zero_label(raw))
    cm = tss.confusion_matrix(preds[0], labels[0], 6)
    np.testing.assert_array_equal(cm, jss.confusion_matrix(preds[0],
                                                           labels[0], 6))


def test_cli_tiny_synthetic_cpu():
    """main() trains and evaluates at --tiny on the CPU; its synthetic
    fixtures are JAX's; the default --device cuda raises without a card."""
    argv = ["--tiny", "--synthetic", "--synthetic-n", "8", "--img-size", "64",
            "--batch-size", "4", "--steps", "3", "--eval"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(argv)
    state, res = tcli.main(argv + ["--device", "cpu"])
    assert state.step == 3
    assert set(res) == {"mIoU", "aAcc", "mAcc"}
    assert all(np.isfinite(v) for v in res.values())
    from unilm_tpu.cli import train_segmentation as jcli

    for a, b in zip(tcli.synthetic_seg_dataset(3, 32, 4, 5),
                    jcli.synthetic_seg_dataset(3, 32, 4, 5)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
