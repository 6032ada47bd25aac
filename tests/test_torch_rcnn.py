"""Port parity for Cascade/Mask R-CNN: unilm_tpu_torch/models/rcnn.py and
convert/detection.py against unilm_tpu's on the CPU.

Inputs come from numpy seeds; JAX runs jitted in float32 at matmul
precision 'highest' (tests/conftest.py), the port in float32; weights go
from JAX to the port through convert/from_jax.py. The model is
tests/test_rcnn.py's `tiny_cfg` (4 layers of width 32, 64 px images).
Tolerances, with their reasons:
- box ops and RoIAlign: 1e-5 abs (the same fp32 formulas; RoIAlign's
  mean over the samples sums in another order), 1e-4 against the
  float64 loop oracle `naive_roi_align` (the JAX test's bound);
- `nms_keep`: equal to JAX's mask bit for bit, tied scores, dead (-inf)
  entries and `idx_cat` included;
- the forward: boxes and proposals 2e-4 abs (pixel coordinates up to 64
  through exp/clip of fp32 deltas: ~1e-6 relative), scores and masks 1e-5
  abs, classes / valid / the proposals' liveness equal;
- `convert_rcnn`: every tensor equal to JAX's converter followed by the
  bridge (both copy, permute and flip);
- `rcnn_loss` with JAX's sampling noise replayed: loss and each metric
  1e-5 relative, every gradient within 2e-5 abs + 1e-4 relative (fp32
  backward through four layers, the heads and RoIAlign, summed in other
  orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rcnn import build_synthetic_sd, naive_roi_align, tiny_cfg
from unilm_tpu.convert import detection as jconv
from unilm_tpu.models import rcnn as jr
from unilm_tpu_torch.convert import detection as tconv
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.core.layers import ConvTransposeNHWC
from unilm_tpu_torch.models import beit as tbeit
from unilm_tpu_torch.models import rcnn as tr

torch.set_num_threads(2)


def port_cfg(cfg):
    """A JAX config dataclass -> the port's class of the same name and
    fields (a nested BeitConfig converted too; JAX's dtype dropped)."""
    import unilm_tpu_torch.models.detection as td
    import unilm_tpu_torch.models.detection_head as tdh
    import unilm_tpu_torch.models.segmentation as ts

    classes = {"BeitConfig": tbeit.BeitConfig, "RCNNConfig": tr.RCNNConfig,
               "ViTDetBackboneConfig": td.ViTDetBackboneConfig,
               "FCOSConfig": tdh.FCOSConfig, "UperNetConfig": ts.UperNetConfig}
    kw = {}
    for f in dataclasses.fields(cfg):
        if f.name == "dtype":
            continue
        v = getattr(cfg, f.name)
        kw[f.name] = port_cfg(v) if dataclasses.is_dataclass(v) else v
    return classes[type(cfg).__name__](**kw)


def draw(module, *args, seed=1, **kw):
    """A flax param tree of the module's shapes (jax.eval_shape, no
    compile) from a numpy seed: N(0, 0.1^2); norm scales 1 + N(0, 0.1^2);
    a FrozenBN `var` 0.5 + |N(0, 0.1^2)|."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, **kw))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        x = 0.1 * rng.randn(*s.shape)
        name = getattr(path[-1], "key", None)
        if name == "scale":
            x = x + 1.0
        elif name == "var":
            x = np.abs(x) + 0.5
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def close(got, want, atol, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def t(x):
    return torch.from_numpy(np.array(x))


def rand_boxes(rng, n, size=40.0, min_wh=1.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size * 0.75 + min_wh
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---- box ops -----------------------------------------------------------------


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    src, tgt = rand_boxes(rng, 30), rand_boxes(rng, 30)
    d = (rng.randn(30, 4) * 2).astype(np.float32)
    d[0, 2:] = 9.0  # past the scale clamp
    w = (10.0, 10.0, 5.0, 5.0)
    close(tr.apply_deltas(t(d), t(src), w),
          jax.jit(jr.apply_deltas, static_argnums=2)(d, src, w), 1e-5, 1e-6)
    close(tr.get_deltas(t(src), t(tgt), w),
          jax.jit(jr.get_deltas, static_argnums=2)(src, tgt, w), 1e-5, 1e-6)
    wide = src * 2 - 10
    close(tr.clip_boxes(t(wide), (48, 56)), jr.clip_boxes(wide, (48, 56)), 0)
    close(tr.box_iou(t(src), t(tgt)), jax.jit(jr.box_iou)(src, tgt), 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_matches_jax_bitwise(seed):
    """Tied scores (a few distinct values: the stable order decides),
    dead -inf entries, clusters of heavy overlap (long suppression
    chains), with and without categories."""
    rng = np.random.RandomState(seed)
    N = 120
    boxes = rand_boxes(rng, N, size=30.0)
    boxes[:40] = boxes[0] + rng.rand(40, 4).astype(np.float32) * 3  # chain
    scores = np.round(rng.rand(N) * 6).astype(np.float32) / 6  # ties
    scores[rng.rand(N) < 0.1] = -np.inf
    cats = rng.randint(0, 3, N)
    f = jax.jit(jr.nms_keep, static_argnums=2)
    for th in (0.3, 0.7):
        want = np.asarray(f(boxes, scores, th, jnp.asarray(cats)))
        got = tr.nms_keep(t(boxes), t(scores), th, idx_cat=t(cats))
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(f(boxes, scores, th))
        np.testing.assert_array_equal(
            tr.nms_keep(t(boxes), t(scores), th).numpy(), want)
    # batched: each row its own mask
    b2 = np.stack([boxes, boxes[::-1].copy()])
    s2 = np.stack([scores, scores[::-1].copy()])
    got = tr.nms_keep(t(b2), t(s2), 0.5)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(f(b2[i], s2[i], 0.5)))


# ---- RoIAlign ---------------------------------------------------------------


def test_roi_align_matches_jax_and_oracle():
    rng = np.random.RandomState(0)
    feat = rng.randn(9, 11, 3).astype(np.float32)
    boxes = np.array([
        [4.0, 8.0, 30.0, 20.0],
        [0.0, 0.0, 44.0, 36.0],
        [10.0, 10.0, 11.5, 12.0],   # tiny box
        [-8.0, -4.0, 20.0, 16.0],   # out-of-bounds corner
        [0.0, 0.0, 0.0, 0.0],       # degenerate dead box
        [-1e4, -1e4, -1e4, -1e4],   # a padded gt slot
    ], np.float32)
    got = tr.roi_align(t(feat), t(boxes), 4, 5, 2)
    close(got, jax.jit(jr.roi_align, static_argnums=(2, 3, 4))(
        feat, boxes, 4, 5, 2), 1e-5)
    close(got, naive_roi_align(feat, boxes, stride=4, out=5, sr=2), 1e-4)


def test_multilevel_roi_align_matches_jax():
    """Each RoI on its own level (the port) against every level blended
    by the mask (JAX), batched over two images."""
    rng = np.random.RandomState(1)
    feats = {f"p{k}": rng.randn(2, 256 >> k, 256 >> k, 4).astype(np.float32)
             for k in range(2, 6)}
    # sqrt(area) from 4 to ~1000: every level 2..5 taken
    xy = rng.rand(2, 24, 2) * 100
    side = np.exp(rng.uniform(np.log(4), np.log(800), (2, 24, 1)))
    boxes = np.concatenate([xy, xy + side * rng.uniform(0.5, 1.5, (2, 24, 2))],
                           -1).astype(np.float32)
    lv = tr.roi_levels(t(boxes))
    assert set(lv.flatten().tolist()) == {2, 3, 4, 5}
    got = tr.multilevel_roi_align({k: t(v) for k, v in feats.items()},
                                  t(boxes), 7, 2)
    f = jax.jit(jax.vmap(lambda fs, b: jr.multilevel_roi_align(fs, b, 7, 2)))
    close(got, f(feats, boxes), 1e-5)
    one = tr.multilevel_roi_align({k: t(v[1]) for k, v in feats.items()},
                                  t(boxes[1]), 7, 2)
    close(one, got[1], 0)


# ---- the graph --------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its drawn params, the port model loaded from them,
    two seeded images)."""
    cfg = tiny_cfg()
    jm = jr.CascadeRCNN(cfg)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    params = draw(jm, jnp.asarray(x))
    pm = tr.CascadeRCNN(port_cfg(cfg), device="cpu").eval()
    load_flax_params(pm, params)
    return jm, params, pm, x


def test_cascade_rcnn_forward_matches_jax(tiny):
    jm, params, pm, x = tiny
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    tr.reset_nms_stats()
    with torch.no_grad():
        got = pm(t(x))
    assert tr.NMS_STATS["calls"] == 2 and tr.NMS_STATS["sweeps"] >= 2
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    live = np.isfinite(np.asarray(want["proposal_scores"]))
    np.testing.assert_array_equal(
        torch.isfinite(got["proposal_scores"]).numpy(), live)
    close(got["proposal_scores"].numpy()[live],
          np.asarray(want["proposal_scores"])[live], 1e-5)
    close(got["proposals"], want["proposals"], 2e-4)
    close(got["boxes"], want["boxes"], 2e-4)
    for k in ("scores", "masks"):
        close(got[k], want[k], 1e-5)
    assert got["valid"].any()


def test_conv_transpose_bridge_flips_by_value():
    """A flax ConvTranspose with I == O (the shape the unflipped mapping
    would also accept) through the bridge against the port's module."""
    import flax.linen as nn

    rng = np.random.RandomState(3)
    for k in (2, 4):
        x = rng.randn(2, 3, 5, 6).astype(np.float32)
        mod = nn.ConvTranspose(6, (k, k), strides=(k, k))
        p = draw(mod, jnp.asarray(x), seed=k)
        want = mod.apply({"params": p}, jnp.asarray(x))
        port = ConvTransposeNHWC(6, 6, k)
        name = "up4" if k == 4 else "deconv"
        sd = flax_to_state_dict({name: p})
        port.load_state_dict({n.split(".", 1)[1]: v for n, v in sd.items()})
        with torch.no_grad():
            close(port(t(x)), want, 1e-5)
        # the unflipped [O, I, kh, kw] of a Conv kernel has the same shape
        w = sd[f"{name}.weight"].numpy()
        assert w.shape == p["kernel"].transpose(3, 2, 0, 1).shape
        assert not np.allclose(w, p["kernel"].transpose(3, 2, 0, 1))


def test_convert_rcnn_matches_jax_converter_and_bridge(tiny):
    """The port's detectron2 converter against JAX's converter followed by
    the bridge, tensor for tensor; the converted model runs."""
    cfg = tiny_cfg()
    sd = build_synthetic_sd(cfg)
    got = tconv.convert_rcnn(sd, cfg)
    params = jconv.convert_rcnn(sd, cfg)
    want = flax_to_state_dict(params)
    for k in ("mean", "var"):  # FrozenBN's buffers, named by the bridge
        assert f"vit.fpn1_bn.running_{k}" in want
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k].numpy(), 0)
    pm = tr.CascadeRCNN(port_cfg(cfg), device="cpu").eval()
    pm.load_state_dict(got, strict=True)
    with torch.no_grad():
        out = pm(t(np.random.RandomState(1).rand(1, 64, 64, 3)
                   .astype(np.float32)))
    assert torch.isfinite(out["scores"]).all()


# ---- the training loss ------------------------------------------------------


def jax_noise(rng_key, cfg, B, n_anchors, R):
    """JAX's `_subsample` draws inside rcnn_loss, in the port's order: the
    RPN's [B, anchors], then each stage's [B, R]."""
    rngs = jax.random.split(rng_key, 1 + len(cfg.cascade_ious))
    out = [np.stack([np.asarray(jax.random.uniform(r, (n_anchors,)))
                     for r in jax.random.split(rngs[0], B)])]
    for k in range(len(cfg.cascade_ious)):
        out.append(np.stack([np.asarray(jax.random.uniform(r, (R,)))
                             for r in jax.random.split(rngs[1 + k], B)]))
    return out


def test_rcnn_loss_matches_jax(tiny, monkeypatch):
    jm, params, pm, x = tiny
    cfg = tiny_cfg()
    rng = np.random.RandomState(2)
    gt_boxes = np.array([[[8, 8, 32, 40], [20, 4, 60, 28], [0, 0, 0, 0]],
                         [[4, 30, 50, 62], [0, 0, 0, 0], [0, 0, 0, 0]]],
                        np.float32)
    gt_classes = np.array([[0, 2, 0], [1, 0, 0]], np.int32)
    gt_valid = np.array([[True, True, False], [True, False, False]])
    gt_masks = rng.rand(2, 3, 64, 64) > 0.5
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jr.rcnn_loss(jm, p, jnp.asarray(x), gt_boxes, gt_classes,
                            gt_valid, key, jnp.asarray(gt_masks))

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    n_anchors = sum(3 * (64 >> k) ** 2 for k in (2, 3, 4, 5)) + 3
    noise = jax_noise(key, cfg, 2, n_anchors, cfg.rpn_post_nms_topk + 3)
    draws = []

    def replay(shape, generator, device):
        draws.append(tuple(shape))
        return torch.from_numpy(noise[len(draws) - 1])

    monkeypatch.setattr(tr, "draw_noise", replay)
    pm.zero_grad()
    loss, met = tr.rcnn_loss(pm, t(x), t(gt_boxes), t(gt_classes),
                             t(gt_valid), torch.Generator(), t(gt_masks))
    loss.backward()
    assert draws == [n.shape for n in noise]
    close(loss, jloss, 0, 1e-5)
    assert set(met) == set(jmet)
    for k in jmet:
        close(met[k], jmet[k], 1e-6, 1e-5)
    want = flax_to_state_dict(jax.device_get(jgrads))
    named = dict(pm.named_parameters())
    assert set(named) == set(want) - {"vit.fpn1_bn.running_mean",
                                      "vit.fpn1_bn.running_var"}
    for name, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        close(g, want[name].numpy(), 2e-5, 1e-4)
    for part in ("rpn_head", "box_head_0", "box_head_2", "mask_head", "vit"):
        assert any(float(p.grad.abs().max()) > 0 for n, p in named.items()
                   if n.startswith(part) and p.grad is not None), part


# ---- FrozenBN under the CLIs' AdamW step ------------------------------------


def test_frozen_bn_statistics_move_in_jax_and_stay_in_the_port(monkeypatch):
    """One step of each CLI's optimizer from the same tree: JAX's FrozenBN
    keeps `mean` / `var` as params, so optax.adamw (cli/train_detection.py
    :142) moves them; the port keeps them as buffers (detectron2's frozen
    statistics), so `build_trainer`'s step leaves them. Every other leaf
    agrees within the gradient check's 2e-5 + 1e-4 relative; an element
    whose gradient is itself within that bound of 0 (the port's, which
    test_rcnn_loss_matches_jax holds to JAX's) may take Adam's first step
    (lr * sign(g)) the other way, so it is held to 2 lr."""
    import optax

    from unilm_tpu.cli import train_detection as jcli
    from unilm_tpu.runtime.train import TrainState as JState
    from unilm_tpu.runtime.train import make_train_step as jstep
    from unilm_tpu_torch.cli import train_detection as tcli

    args = tcli.build_parser().parse_args(
        ["--head", "rcnn", "--tiny", "--synthetic", "--img-size", "64",
         "--device", "cpu"])
    cfg, jm = jcli.build_rcnn(args)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    params = draw(jm, jnp.asarray(x), seed=4)
    boxes = np.array([[[8, 8, 32, 40], [20, 4, 60, 28], [0, 0, 0, 0]],
                      [[4, 30, 50, 62], [0, 0, 0, 0], [0, 0, 0, 0]]],
                     np.float32)
    labels = np.array([[0, 2, 0], [1, 0, 0]], np.int32)
    valid = np.array([[True, True, False], [True, False, False]])

    def loss_fn(p, batch, rng):
        return jr.rcnn_loss(jm, p, batch["images"], batch["boxes"],
                            batch["labels"], batch["valid"], rng)

    tx = optax.adamw(args.lr)
    key = jax.random.PRNGKey(0)  # the JAX CLI's key of step 0
    jbatch = {"images": x, "boxes": boxes, "labels": labels, "valid": valid}
    state, _ = jax.jit(jstep(loss_fn, tx, clip_grad_norm=1.0))(
        JState.create(params, tx), jbatch, key)
    want = flax_to_state_dict(jax.device_get(state.params))
    before = flax_to_state_dict(params)

    tr_ = tcli.build_trainer(args)
    load_flax_params(tr_.model, params)
    noise_keys = jax.random.split(key, 1 + len(cfg.cascade_ious))

    def replay(shape, generator, device):
        # the RPN's [B, anchors], then each stage's [B, R], JAX's draws
        rk = noise_keys[len(drawn)]
        drawn.append(tuple(shape))
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(r, shape[1:]))
            for r in jax.random.split(rk, shape[0])]))

    drawn = []
    monkeypatch.setattr(tr, "draw_noise", replay)
    batch = {**tcli.to_device(jbatch, "cpu"), "step": 0}
    tcli.make_loss_fn(args, cfg, "cpu")(tr_.model, batch)[0].backward()
    grads = {n: p.grad.clone() for n, p in tr_.model.named_parameters()
             if p.grad is not None}
    drawn.clear()
    tr_.step(tr_.state, batch)
    assert len(drawn) == 1 + len(cfg.cascade_ious)
    got = tr_.model.state_dict()
    stats = [f"vit.fpn1_bn.running_{k}" for k in ("mean", "var")]
    for name in stats:
        assert not np.allclose(want[name].numpy(), before[name].numpy())
        assert torch.equal(got[name], before[name])
    lr = args.lr
    for name, w in want.items():
        if name in stats:
            continue
        g, w = got[name].numpy(), w.numpy()
        off = np.abs(g - w) > 2e-5 + 1e-4 * np.abs(w)
        if off.any():
            gp = grads[name].numpy()
            assert (np.abs(gp[off]) <= 2e-5 + 1e-4 * np.abs(gp).max()
                    ).all(), name
            assert (np.abs(g - w)[off] <= 2.01 * lr).all(), name
    # the step moved the parameters the loss reaches
    assert not np.allclose(got["rpn_head.conv.weight"].numpy(),
                           before["rpn_head.conv.weight"].numpy())
