"""Port parity for the FCOS detection path: unilm_tpu_torch's
models/detection.py, models/detection_head.py, data/detection.py,
scoring_detection.py and cli/train_detection.py against unilm_tpu's on
the CPU.

Inputs come from numpy seeds; JAX runs jitted in float32 at matmul
precision 'highest' (tests/conftest.py), the port in float32; weights go
from JAX to the port through convert/from_jax.py. Tiny configs: 2 layers
of width 64 at 64 px, one tower conv of 32 channels. Tolerances, with
their reasons:
- the FCOS forward: logits and centerness 1e-4 abs, the side distances
  (exp(reg * scale) * stride, up to a few hundred pixels) 1e-4 relative:
  fp32 through two layers, the adapters' tanh GELU and GroupNorms summed
  in other orders; locations equal;
- fcos_targets: classes equal, distances and centerness 1e-5 abs (the
  same fp32 formulas); fcos_loss and its gradients with respect to the
  head's outputs 1e-5 relative;
- decode_detections: valid and labels equal, boxes 1e-4 abs, scores 1e-6;
- the scorers: equal to JAX's (the same numpy code).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rcnn import close, draw, port_cfg, t
from unilm_tpu import scoring_detection as jsd
from unilm_tpu.models import detection_head as jdh
from unilm_tpu_torch import scoring_detection as tsd
from unilm_tpu_torch.cli import train_detection as tcli
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.data import detection as tdata
from unilm_tpu_torch.models import detection_head as tdh

torch.set_num_threads(2)

TINY = dict(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128)


def jax_cfg(preset):
    make = (jdh.dit_base_detection if preset == "dit"
            else jdh.layoutlmv3_base_detection)
    cfg = make(img_size=64, num_classes=3, **TINY)
    return dataclasses.replace(cfg, tower_convs=1, tower_channels=32)


def gt_set(seed, B=2, M=5, img=64):
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, M, 2) * img * 0.6
    wh = rng.rand(B, M, 2) * img * 0.5 + 4
    boxes = np.concatenate([xy, np.minimum(xy + wh, img)], -1)
    labels = rng.randint(0, 3, (B, M)).astype(np.int32)
    valid = rng.rand(B, M) < 0.8
    valid[:, 0] = True
    return boxes.astype(np.float32), labels, valid


@pytest.fixture(scope="module", params=["dit", "layoutlmv3"])
def fcos(request):
    """(JAX config, JAX outputs, port outputs) of one seeded batch."""
    cfg = jax_cfg(request.param)
    jm = jdh.FCOSDetector(cfg)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    params = draw(jm, jnp.asarray(x))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    pm = tdh.FCOSDetector(port_cfg(cfg), device="cpu").eval()
    load_flax_params(pm, params)
    with torch.no_grad():
        got = pm(t(x))
    return cfg, jax.device_get(want), got


def test_fcos_forward_matches_jax(fcos):
    cfg, want, got = fcos
    for k in ("xy", "level", "lo", "hi", "stride"):
        close(got["locations"][k], want["locations"][k], 0)
    close(got["logits"], want["logits"], 1e-4)
    close(got["ctr"], want["ctr"], 1e-4)
    close(got["reg"], want["reg"], 1e-4, 1e-4)


def test_fcos_targets_and_loss_match_jax(fcos):
    cfg, want, got = fcos
    boxes, labels, valid = gt_set(1)
    jt = jax.jit(jdh.fcos_targets)(want["locations"], boxes, labels, valid)
    tt = tdh.fcos_targets(got["locations"], t(boxes), t(labels), t(valid))
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    assert (tt[0] >= 0).any()
    close(tt[1], jt[1], 1e-5)
    close(tt[2], jt[2], 1e-5)

    # the loss and its gradients with respect to the head's outputs, both
    # on JAX's outputs
    heads = {k: np.asarray(want[k]) for k in ("logits", "reg", "ctr")}

    def jloss(h):
        return jdh.fcos_loss({**h, "locations": want["locations"]},
                             boxes, labels, valid, cfg)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(heads)
    th = {k: t(v).requires_grad_() for k, v in heads.items()}
    tl, tm = tdh.fcos_loss({**th, "locations": got["locations"]}, t(boxes),
                           t(labels), t(valid), port_cfg(cfg))
    tl.backward()
    close(tl, jl, 0, 1e-5)
    for k in jm:
        close(tm[k], jm[k], 1e-7, 1e-5)
    for k in th:
        close(th[k].grad, jg[k], 1e-8, 1e-5)


def test_decode_detections_matches_jax(fcos):
    """On the model's outputs and on outputs with tied scores (a few
    distinct logits) whose NMS decides by the pre-sorted order."""
    cfg, want, got = fcos
    rng = np.random.RandomState(2)
    L = want["logits"].shape[1]
    tied = {"logits": np.round(rng.randn(2, L, 3)).astype(np.float32),
            "ctr": np.round(rng.randn(2, L)).astype(np.float32),
            "reg": (rng.rand(2, L, 4) * 20 + 1).astype(np.float32)}
    f = jax.jit(lambda o: jdh.decode_detections(o, img_size=64.0,
                                                max_dets=20))
    for outs in ({k: want[k] for k in ("logits", "reg", "ctr")}, tied):
        jo = f({**outs, "locations": want["locations"]})
        to = tdh.decode_detections(
            {**{k: t(v) for k, v in outs.items()},
             "locations": got["locations"]}, img_size=64.0, max_dets=20)
        np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
        np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))
        close(to[0], jo[0], 1e-4)
        close(to[1], jo[1], 1e-6)
        assert to[3].any()


def test_load_coco_json_roundtrip(tmp_path):
    coco = {
        "images": [{"id": 7, "width": 100, "height": 50, "file_name": "x.png"},
                   {"id": 9, "width": 40, "height": 40, "file_name": "y.png"}],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 11, "bbox": [10, 5, 30, 20]},
            {"id": 2, "image_id": 7, "category_id": 13, "bbox": [50, 10, 20, 30]},
        ],
        "categories": [{"id": 11, "name": "text"}, {"id": 13, "name": "table"}],
    }
    p = tmp_path / "coco.json"
    p.write_text(json.dumps(coco))
    ex = tdata.load_coco_json(str(p), "", img_size=200)
    assert [e.image_id for e in ex] == [7, 9]
    np.testing.assert_allclose(ex[0].boxes, [[20, 20, 80, 100],
                                             [100, 40, 140, 160]])
    assert list(ex[0].labels) == [0, 1] and ex[1].boxes.shape == (0, 4)
    b = tdata.pad_batch(ex, max_boxes=3)
    assert b["images"].shape == (2, 200, 200, 3)
    np.testing.assert_array_equal(b["valid"], [[1, 1, 0], [0, 0, 0]])
    from unilm_tpu.data import detection as jdata

    syn = (tdata.synthetic_detection_dataset(6, img_size=48, seed=3),
           jdata.synthetic_detection_dataset(6, img_size=48, seed=3))
    for a, c in zip(tdata.batches(syn[0], 4, max_boxes=5, shuffle=True,
                                  seed=1, drop_last=False),
                    jdata.batches(syn[1], 4, max_boxes=5, shuffle=True,
                                  seed=1, drop_last=False)):
        for k in a:
            np.testing.assert_array_equal(a[k], c[k])


def _pred_sets(seed, n_img=5, C=3):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_img):
        g = rng.randint(0, 6)
        gb = np.concatenate([rng.rand(g, 2) * 60,
                             rng.rand(g, 2) * 60 + 70], -1)
        p = rng.randint(0, 8)
        pb = np.concatenate([rng.rand(p, 2) * 60,
                             rng.rand(p, 2) * 60 + 70], -1)
        if g and p:  # some near-duplicates of the ground truth
            pb[: min(g, p)] = gb[: min(g, p)] + rng.randn(min(g, p), 4) * 3
        gts.append({"boxes": gb, "labels": rng.randint(0, C, g),
                    "ignore": rng.rand(g) < 0.2})
        preds.append({"boxes": pb, "labels": rng.randint(0, C, p),
                      "scores": np.round(rng.rand(p), 1)})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1])
def test_scorers_match_jax(seed):
    preds, gts = _pred_sets(seed)
    assert tsd.evaluate_detections(preds, gts, 3) == \
        jsd.evaluate_detections(preds, gts, 3)
    order = [p["boxes"][np.argsort(-p["scores"], kind="stable")]
             for p in preds]
    gtb = [g["boxes"] for g in gts]
    assert tsd.evaluate_icdar_table_detection(order, gtb) == \
        jsd.evaluate_icdar_table_detection(order, gtb)
    assert tsd.evaluate_text_detection(preds, gts) == \
        jsd.evaluate_text_detection(preds, gts)
    a, b = preds[0]["boxes"], gtb[1]
    close(tsd.box_iou_np(a, b), jsd.box_iou_np(a, b), 0)


@pytest.mark.parametrize("head,protocol", [("fcos", "icdar_table"),
                                           ("rcnn", "funsd_text")])
def test_cli_tiny_synthetic_cpu(head, protocol):
    """Both heads train and evaluate through main() at --tiny on the CPU;
    the default --device cuda raises without a card."""
    argv = ["--head", head, "--tiny", "--synthetic", "--synthetic-n", "8",
            "--num-classes", "2", "--img-size", "64", "--batch-size", "4",
            "--steps", "2", "--eval", "--eval-protocol", protocol]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(argv)
    state, res = tcli.main(argv + ["--device", "cpu"])
    assert state.step == 2
    assert {"mAP", "AP50", "AP75"} <= set(res)
    assert ("wF1" if protocol == "icdar_table" else "best_hmean") in res
    assert all(np.isfinite(v) for v in res.values())
