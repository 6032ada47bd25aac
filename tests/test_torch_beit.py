"""Port parity for the BEiT eval slice: unilm_tpu_torch's Encoder,
BeitForImageClassification, BEiT checkpoint converter and the
run_class_finetuning --eval CLI against unilm_tpu (and HF transformers)
on the CPU.

Weights are initialised by the JAX model (rel-pos tables and LayerScale
filled with random values so they matter) and carried across by
convert/from_jax.py; inputs come from numpy. Tolerances: float32 logits
and hidden states 1e-4 abs (the same fp32 math in another order; readings
are ~1e-7); the HF converter 2e-4 abs + 1e-3 rel, as
tests/test_beit_parity.py holds the JAX converter; bfloat16 logits 0.05
abs (about 6 bf16 ulps at |logit| < 1: the frameworks round at different
points of the norms and matmuls).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.cli import run_class_finetuning as jcli
from unilm_tpu.convert.beit import convert_beit as jconvert
from unilm_tpu.core import config as jconfig
from unilm_tpu.core import transformer as jtr
from unilm_tpu.models import beit as jb
from unilm_tpu_torch.cli import run_class_finetuning as tcli
from unilm_tpu_torch.convert.beit import convert_beit
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.core import config as tconfig
from unilm_tpu_torch.core import transformer as ttr
from unilm_tpu_torch.models import beit as tb

torch.set_num_threads(1)

ATOL = 1e-4
SMALL = dict(img_size=64, patch_size=16, num_classes=10, embed_dim=64,
             num_layers=2, num_heads=4, ffn_dim=128, use_flash=False)


def _randomize(tree, rng, names=("relative_position_bias_table", "gamma")):
    """Fill the leaves the JAX initialisers set to constants (zero tables,
    LayerScale init_values) with random values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, names)
        elif k in names:
            out[k] = rng.uniform(-1, 1, size=v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("pre_ln,bias_kind", [
    (True, "per_layer"), (True, "shared"), (False, "per_layer")])
def test_encoder_matches_jax(pre_ln, bias_kind):
    """Encoder with LayerScale, a key-padding mask, pre- or post-LN, a
    per-layer list of biases or one shared bias, the final LayerNorm and
    return_all_hiddens."""
    kw = dict(embed_dim=32, ffn_dim=64, num_layers=2, num_heads=4,
              normalize_before=pre_ln, use_flash=False, layernorm_eps=1e-6)
    B, T, H, L = 2, 9, 4, 2
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, 32).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    biases = [rng.randn(1, H, T, T).astype(np.float32) for _ in range(L)]
    bias = biases if bias_kind == "per_layer" else biases[0]
    jenc = jtr.Encoder(jconfig.TransformerConfig(**kw))
    call = dict(key_padding_mask=jnp.asarray(mask), layer_scale_init=0.1,
                return_all_hiddens=True,
                attn_bias=([jnp.asarray(b) for b in bias]
                           if bias_kind == "per_layer" else jnp.asarray(bias)))
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), **call)["params"]
    params = _randomize(jax.device_get(params), rng)
    want, want_h = jenc.apply({"params": params}, jnp.asarray(x), **call)

    tenc = ttr.Encoder(tconfig.TransformerConfig(**kw),
                       layer_scale_init=0.1).eval()
    load_flax_params(tenc, params)
    tb_ = ([torch.from_numpy(b) for b in bias] if bias_kind == "per_layer"
           else torch.from_numpy(bias))
    with torch.no_grad():
        got, got_h = tenc(torch.from_numpy(x),
                          key_padding_mask=torch.from_numpy(mask),
                          attn_bias=tb_, return_all_hiddens=True)
    assert hasattr(tenc, "layer_norm") == pre_ln
    assert len(got_h) == L
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for a, b in zip(got_h, want_h):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@functools.lru_cache(maxsize=None)
def _beit(shared: bool, dtype: str):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(SMALL, use_rel_pos_bias=not shared,
              use_shared_rel_pos_bias=shared)
    rng = np.random.RandomState(1)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    jm = jb.BeitForImageClassification(jb.BeitConfig(dtype=jdt, **kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img, jdt))["params"]
    params = _randomize(jax.device_get(params), rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img, jdt)))
    tm = tb.BeitForImageClassification(tb.BeitConfig(dtype=tdt, **kw)).eval()
    load_flax_params(tm, params)
    return tm, img, want


@pytest.mark.parametrize("shared", [False, True])
def test_beit_logits_match_jax(shared):
    tm, img, want = _beit(shared, "float32")
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_beit_bf16_promotes_like_flax():
    """bf16 model: the encoder runs in bf16, fc_norm and head in float32
    (flax dtype=None over float32 params), so the logits are float32."""
    tm, img, want = _beit(False, "bfloat16")
    assert want.dtype == np.float32
    acts = {}
    hook = lambda name: (lambda m, i, o: acts.__setitem__(name, o.dtype))
    tm.backbone.register_forward_hook(hook("backbone"))
    tm.fc_norm.register_forward_hook(hook("fc_norm"))
    with torch.no_grad():
        got = tm(torch.from_numpy(img).to(torch.bfloat16))
    assert acts == {"backbone": torch.bfloat16, "fc_norm": torch.float32}
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


def test_flax_conv_kernel_becomes_the_patch_projection():
    """The [p, p, C, E] flax Conv kernel lands on proj.weight [E, p*p*C]
    in (kh, kw, C) order: the patch projection of a one-hot patch picks
    the kernel's tap."""
    tm, _, _ = _beit(False, "float32")
    proj = tm.backbone.embeddings.patch_embed.proj
    w = proj.weight.detach()
    img = torch.zeros(1, 64, 64, 3)
    img[0, 16 + 3, 32 + 5, 2] = 1.0  # patch (1, 2), tap (3, 5), channel 2
    with torch.no_grad():
        out = proj(img) - proj.bias
    idx = (3 * 16 + 5) * 3 + 2
    torch.testing.assert_close(out[0, 1 * 4 + 2], w[:, idx])


def test_training_mode_raises_for_drop_path():
    """Drop-path in training draws its flags from the generator the caller
    passes (the same seed, the same output; another seed, another); without
    one it raises rather than reach for the global RNG. Eval is the
    identity, as flax's deterministic=True."""
    cfg = tb.BeitConfig(drop_path_rate=0.5, **SMALL)
    m = tb.BeitForImageClassification(cfg)
    m.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 64, 64, 3)
                         .astype(np.float32))
    with pytest.raises(ValueError, match="draw_drop_path"):
        m(x)
    with torch.no_grad():
        a = m(x, torch.Generator().manual_seed(1))
        b = m(x, torch.Generator().manual_seed(1))
        c = m(x, torch.Generator().manual_seed(2))
        ev = m.eval()(x)
        ev2 = m(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(ev, ev2)


def _hf(shared: bool):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BeitConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, image_size=32, patch_size=8, num_labels=10,
        use_relative_position_bias=not shared,
        use_shared_relative_position_bias=shared, layer_scale_init_value=0.1,
        use_mean_pooling=True, hidden_act="gelu")
    torch.manual_seed(0)
    hf = transformers.BeitForImageClassification(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_()
    cfg = tb.BeitConfig(img_size=32, patch_size=8, num_classes=10,
                        embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
                        use_rel_pos_bias=not shared,
                        use_shared_rel_pos_bias=shared, init_values=0.1,
                        layernorm_eps=1e-12, use_flash=False)
    return hf, cfg


@pytest.mark.parametrize("shared", [False, True])
def test_convert_beit_matches_hf(shared):
    hf, cfg = _hf(shared)
    m = tb.BeitForImageClassification(cfg).eval()
    m.load_state_dict(convert_beit(hf.state_dict(), cfg), strict=True)
    img = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(img)).logits.numpy()
        got = m(torch.from_numpy(img.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def _timm_state_dict(cfg, rng):
    """A random timm/unilm-format BEiT state dict (beit/modeling_finetune.py
    names) for cfg, per-layer tables, LayerScale, q/v biases."""
    E, F, L, H = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers, cfg.num_heads
    p, n = cfg.patch_size, (2 * cfg.grid_size[0] - 1) ** 2 + 3
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    sd = {"cls_token": r(1, 1, E), "patch_embed.proj.weight": r(E, 3, p, p),
          "patch_embed.proj.bias": r(E), "fc_norm.weight": r(E),
          "fc_norm.bias": r(E), "head.weight": r(cfg.num_classes, E),
          "head.bias": r(cfg.num_classes)}
    for i in range(L):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": r(E), f"{b}.norm1.bias": r(E),
                   f"{b}.norm2.weight": r(E), f"{b}.norm2.bias": r(E),
                   f"{b}.attn.qkv.weight": r(3 * E, E),
                   f"{b}.attn.q_bias": r(E), f"{b}.attn.v_bias": r(E),
                   f"{b}.attn.proj.weight": r(E, E),
                   f"{b}.attn.proj.bias": r(E),
                   f"{b}.attn.relative_position_bias_table": r(n, H),
                   f"{b}.mlp.fc1.weight": r(F, E), f"{b}.mlp.fc1.bias": r(F),
                   f"{b}.mlp.fc2.weight": r(E, F), f"{b}.mlp.fc2.bias": r(E),
                   f"{b}.gamma_1": r(E), f"{b}.gamma_2": r(E)})
    return sd


def test_convert_beit_timm_matches_the_jax_converter():
    """A timm-format checkpoint converts to the same weights through the
    port's converter as through the JAX converter and the flax bridge."""
    cfg = tb.BeitConfig(**SMALL)
    sd = _timm_state_dict(cfg, np.random.RandomState(2))
    direct = tb.BeitForImageClassification(cfg)
    direct.load_state_dict(convert_beit(sd, cfg), strict=True)
    bridged = tb.BeitForImageClassification(cfg)
    load_flax_params(bridged, jconvert(sd, jb.BeitConfig(**SMALL)))
    b = bridged.state_dict()
    for k, v in direct.state_dict().items():
        torch.testing.assert_close(v, b[k], rtol=0, atol=0, msg=k)


def test_eval_cli_matches_jax_on_a_png_folder(tmp_path, monkeypatch):
    """The --eval CLI on a tiny folder of PNGs, --device cpu: the same
    top-1/top-5 as the JAX CLI from the same HF checkpoint, and the
    evaluation loop's logits equal to HF's on the same transformed
    images."""
    from PIL import Image

    hf, cfg = _hf(False)
    ckpt = tmp_path / "beit.pt"
    torch.save(hf.state_dict(), ckpt)
    rng = np.random.RandomState(3)
    for c in range(3):
        (tmp_path / "val" / f"class{c}").mkdir(parents=True)
        for j in range(3):
            arr = rng.randint(0, 256, size=(40 + 4 * j, 36, 3)).astype(np.uint8)
            Image.fromarray(arr).save(tmp_path / "val" / f"class{c}" / f"{j}.png")
    tiny = lambda **kw: dict(img_size=32, patch_size=8, num_classes=10,
                             embed_dim=64, num_layers=2, num_heads=4,
                             ffn_dim=128, init_values=0.1,
                             layernorm_eps=1e-12, use_flash=False, **kw)
    monkeypatch.setattr(jb, "beit_tiny", lambda **kw: jb.BeitConfig(
        **tiny(**kw)), raising=False)
    monkeypatch.setattr(tb, "beit_tiny", lambda **kw: tb.BeitConfig(
        **tiny(**kw)), raising=False)
    argv = ["--model", "beit_tiny", "--data_path", str(tmp_path / "val"),
            "--checkpoint", str(ckpt), "--eval", "--batch_size", "4",
            "--no-bf16"]
    got = tcli.main(argv + ["--device", "cpu"])
    jargs = tcli.build_parser().parse_args(argv)
    want = jcli.evaluate(jargs)
    assert (got["acc1"], got["acc5"]) == (want["acc1"], want["acc5"])

    args = tcli.build_parser().parse_args(argv + ["--device", "cpu"])
    model = tcli.build_model(args, torch.device("cpu"))
    items, _ = tcli.list_image_folder(args.data_path)
    logits, labels = tcli.evaluate_batches(
        model, tcli.folder_batches(items, 32, 4))
    imgs = np.concatenate([b for b, _ in tcli.folder_batches(items, 32, 4)])
    with torch.no_grad():
        ref = hf(torch.from_numpy(imgs.transpose(0, 3, 1, 2))).logits.numpy()
    assert labels.tolist() == [c for _, c in items]
    np.testing.assert_allclose(logits, ref, atol=2e-4, rtol=1e-3)


def test_eval_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tcli.build_parser().parse_args(["--data_path", "x", "--eval"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="device cpu"):
        tcli.evaluate(args)
    # without --eval it points at the training entry, as the JAX CLI does
    with pytest.raises(SystemExit, match="cli.train_classification"):
        tcli.main(["--data_path", "x"])


def test_eval_transform_and_accuracy_match_the_jax_package():
    from PIL import Image

    from unilm_tpu import scoring as jscoring
    from unilm_tpu.data import transforms as jt
    from unilm_tpu_torch import scoring as tscoring
    from unilm_tpu_torch.data import transforms as tt

    rng = np.random.RandomState(5)
    img = Image.fromarray(rng.randint(0, 256, size=(50, 37, 3)).astype(
        np.uint8))
    for size, crop in ((32, None), (24, 0.9)):
        np.testing.assert_array_equal(
            tt.eval_transform(img, size, crop_pct=crop),
            jt.eval_transform(img, size, crop_pct=crop))
    logits = rng.randn(20, 7).astype(np.float32)
    labels = rng.randint(0, 7, size=20)
    assert tscoring.accuracy_topk(logits, labels) == \
        jscoring.accuracy_topk(logits, labels)


def test_vision_embedding_mask_token_matches_jax():
    """VisionEmbedding's cls token and mask-token substitution."""
    from unilm_tpu.core.embedding import VisionEmbedding as JVE
    from unilm_tpu_torch.core.embedding import VisionEmbedding as TVE

    rng = np.random.RandomState(6)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    masked = rng.rand(2, 16) > 0.5
    jm = JVE(img_size=32, patch_size=8, embed_dim=24, use_mask_token=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img),
                     jnp.asarray(masked))["params"]
    want = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(masked))
    tm = TVE(img_size=32, patch_size=8, embed_dim=24, use_mask_token=True)
    load_flax_params(tm, jax.device_get(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(masked))
    assert tuple(got.shape) == (2, 17, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
