"""Port parity for the multiway core, BEiT-3 and VLMo (core/multiway.py,
core/attention.py and core/transformer.py under cfg.multiway,
core/embedding.py's TextEmbedding / PositionalEmbedding,
models/beit3.py, models/vlmo.py, models/registry.py) against unilm_tpu
on the CPU, and the attention dispatcher's choice of kernel for every
call shape of the BEiT-family slice against JAX's own predicates.

Sizes: 2 layers, width 32, 4 heads, 16 px images in 8 px patches (4
patches + cls), vocab 50. Params come from a JAX init with every leaf
moved off its init value by seeded noise (so the A and B experts, norms
and biases all matter) and reach the port through convert/from_jax.py;
images and tokens come from numpy seeds. JAX runs its XLA paths
(use_flash=False) at matmul precision `highest`, the port its plain path
in float32. Tolerance: 1e-5 relative + 1e-5 absolute (the same fp32 math
in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.core import config as jconfig
from unilm_tpu.core import multiway as jmw
from unilm_tpu.core import transformer as jtr
from unilm_tpu.models import beit3 as jb3
from unilm_tpu.models import registry as jreg
from unilm_tpu.models import vlmo as jvlmo
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.core import config as tconfig
from unilm_tpu_torch.core import multiway as tmw
from unilm_tpu_torch.core import transformer as ttr
from unilm_tpu_torch.models import beit3 as tb3
from unilm_tpu_torch.models import registry as treg
from unilm_tpu_torch.models import vlmo as tvlmo

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
KW = dict(vocab_size=50, embed_dim=32, num_layers=2, num_heads=4,
          ffn_dim=64, img_size=16, patch_size=8, max_text_len=16,
          use_flash=False, num_classes=7)
B, LT = 2, 5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _noisy(params, seed):
    """Every leaf moved off its init value by seeded noise."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + (0.1 * rng.randn(
        *x.shape)).astype(np.float32), jax.device_get(params))


def _inputs(seed=0, lt=LT):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, 16, 16, 3).astype(np.float32)
    txt = rng.randint(4, 50, (B, lt)).astype(np.int32)
    pad = np.zeros((B, lt), bool)
    pad[1, 3:] = True
    return img, txt, pad


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- the multiway modules ------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "position", "mask_1d", "mask_2d"])
def test_multiway_dense_and_norm_match_jax(kind):
    """MultiwayDense and MultiwayNorm with no split (all A: B holds
    params and does no work), a split position (the port slices the
    sequence), and [T] / [B, T] masks (where-select, as JAX)."""
    T, E, F = 6, 8, 12
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, E).astype(np.float32)
    jmask = {"none": None,
             "position": jmw.split_mask_from_position(T, jnp.asarray(2)),
             "mask_1d": jnp.asarray([1, 0, 1, 1, 0, 0], bool),
             "mask_2d": jnp.asarray(rng.rand(B, T) > 0.5)}[kind]
    tsplit = {"none": None, "position": 2,
              "mask_1d": torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.bool),
              "mask_2d": _t(np.asarray(jmask)) if kind == "mask_2d"
              else None}[kind]
    cfg = tconfig.TransformerConfig(embed_dim=E)
    for jmod, tmod in ((jmw.MultiwayDense(F), tmw.MultiwayDense(cfg, E, F)),
                       (jmw.MultiwayNorm(), tmw.MultiwayNorm(cfg))):
        params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jmask)["params"]
        assert set(params) == {"A", "B"}
        params = _noisy(params, 2)
        want = jmod.apply({"params": params}, jnp.asarray(x), jmask)
        load_flax_params(tmod, params)
        with torch.no_grad():
            got = tmod(_t(x), tsplit)
        _close(got, want)
    if kind == "position":
        got_mask = tmw.split_mask_from_position(T, 2)
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(
            tmw.split_mask_from_position(T, -1).numpy(),
            np.asarray(jmw.split_mask_from_position(T, jnp.asarray(-1))))


def _multiway_encoder(num_layers=2):
    kw = dict(embed_dim=32, ffn_dim=64, num_layers=num_layers, num_heads=4,
              multiway=True, subln=True, use_flash=False)
    return (jtr.Encoder(jconfig.TransformerConfig(**kw)),
            ttr.Encoder(tconfig.TransformerConfig(**kw)).eval())


def _copy_a_to_b(tree):
    if not isinstance(tree, dict):
        return tree
    out = {k: _copy_a_to_b(v) for k, v in tree.items()}
    if "A" in out and "B" in out:
        out["B"] = out["A"]
    if "ffn_A" in out and "ffn_B" in out:
        out["ffn_B"] = out["ffn_A"]
    return out


@functools.lru_cache(maxsize=None)
def _encoder_params():
    jenc, _ = _multiway_encoder()
    x = jnp.zeros((B, 6, 32))
    params = jenc.init(jax.random.PRNGKey(1), x,
                       multiway_split_mask=jnp.zeros(6, bool))["params"]
    return _noisy(params, 3)


def test_multiway_encoder_with_b_copied_from_a_is_single_expert():
    """With every B subtree a copy of its A, the split makes no
    difference: the port's split forward equals its all-A forward and
    JAX's split forward (tests/test_beit3.py's equivalence)."""
    jenc, tenc = _multiway_encoder()
    params = _copy_a_to_b(_encoder_params())
    x = np.random.RandomState(4).randn(B, 6, 32).astype(np.float32)
    jmask = jmw.split_mask_from_position(6, jnp.asarray(3))
    want = jenc.apply({"params": params}, jnp.asarray(x),
                      multiway_split_mask=jmask)
    load_flax_params(tenc, params)
    with torch.no_grad():
        split = tenc(_t(x), multiway_split_mask=3)
        all_a = tenc(_t(x), multiway_split_mask=None)
    _close(split, want)
    _close(split, all_a)


@pytest.mark.parametrize("split", [0, 3, -1, "mask_2d"])
def test_multiway_encoder_matches_jax(split):
    """The multiway encoder (multiway norms, sub-LN attention and FFN
    pairs, the final multiway LayerNorm) with a key-padding mask, at a
    split position (0: all B; -1: all A) or a [B, T] mask."""
    jenc, tenc = _multiway_encoder()
    params = _encoder_params()
    rng = np.random.RandomState(5)
    x = rng.randn(B, 6, 32).astype(np.float32)
    kpm = np.ones((B, 6), bool)
    kpm[1, 4:] = False
    if split == "mask_2d":
        m = rng.rand(B, 6) > 0.5
        jmask, tsplit = jnp.asarray(m), _t(m)
    else:
        jmask = jmw.split_mask_from_position(6, jnp.asarray(split))
        tsplit = split
    want = jenc.apply({"params": params}, jnp.asarray(x),
                      key_padding_mask=jnp.asarray(kpm),
                      multiway_split_mask=jmask)
    load_flax_params(tenc, params)
    with torch.no_grad():
        got = tenc(_t(x), key_padding_mask=_t(kpm),
                   multiway_split_mask=tsplit)
    _close(got, want)


# ---- BEiT-3 ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_head(name):
    """(flax module, noisy params) of a JAX BEiT-3 / VLMo module."""
    cfg = jb3.BEiT3Config(**KW)
    img, txt, pad = _inputs()
    img, txt = jnp.asarray(img), jnp.asarray(txt)
    mods = {
        "model": (jb3.BEiT3Model(cfg), (txt, img, jnp.asarray(pad))),
        "model_masked": (jb3.BEiT3Model(cfg),
                         (None, img, None, jnp.zeros((B, 4), bool))),
        "cls": (jb3.BEiT3ForImageClassification(cfg), (img,)),
        "retrieval": (jb3.BEiT3ForRetrieval(cfg), (img, txt)),
        "captioning": (jb3.BEiT3ForCaptioning(cfg), (img, txt)),
        "vqa": (jb3.BEiT3ForVisualQuestionAnswering(cfg, num_answers=11),
                (img, txt)),
        "nlvr2": (jb3.BEiT3ForVisualReasoning(cfg), (img, img, txt)),
        "itm": (jvlmo.VLMoForImageTextMatching(cfg), (img, txt)),
        "mlm": (jvlmo.VLMoForMaskedLM(cfg), (img, txt)),
    }
    mod, args = mods[name]
    params = mod.init(jax.random.PRNGKey(7), *args)["params"]
    return mod, _noisy(params, 8)


def _port(cls, params, **kw):
    m = cls(tb3.BEiT3Config(**KW), **kw).eval()
    load_flax_params(m, params)
    return m


@pytest.mark.parametrize("call", ["vision", "text", "joint"])
def test_beit3_model_matches_jax(call):
    """BEiT3Model's vision-only (all A), text-only (all B, the split at
    0) and joint calls, the text padding mask turned into the key
    padding, and the split position returned."""
    jm, params = _jax_head("model")
    tm = _port(tb3.BEiT3Model, params)
    img, txt, pad = _inputs(1)
    ji = dict(vision=(None, jnp.asarray(img), None),
              text=(jnp.asarray(txt), None, jnp.asarray(pad)),
              joint=(jnp.asarray(txt), jnp.asarray(img),
                     jnp.asarray(pad)))[call]
    want, wsplit = jm.apply({"params": params}, *ji)
    ti = [None if a is None else _t(a) for a in ji]
    with torch.no_grad():
        got, split = tm(*ti)
    assert split == wsplit == {"vision": 5, "text": 0, "joint": 5}[call]
    _close(got, want)


def test_beit3_model_mask_token_matches_jax():
    """vision_masked_position substitutes the mask token (a model built
    with use_mask_token, whose tree has `mask_token` as the JAX one
    does after an init with a mask)."""
    jm, params = _jax_head("model_masked")
    tm = _port(tb3.BEiT3Model, params, text=False, use_mask_token=True)
    img = _inputs(2)[0]
    m = np.zeros((B, 4), bool)
    m[0, 1:3] = m[1, 0] = True
    want, _ = jm.apply({"params": params}, None, jnp.asarray(img), None,
                       jnp.asarray(m))
    with torch.no_grad():
        got, _ = tm(None, _t(img), None, _t(m))
    _close(got, want)
    with pytest.raises(ValueError, match="use_mask_token"):
        _port(tb3.BEiT3Model, _jax_head("model")[1])(None, _t(img), None,
                                                     _t(m))


@pytest.mark.parametrize("name", ["cls", "retrieval", "captioning", "vqa",
                                  "nlvr2", "itm", "mlm"])
def test_heads_match_jax(name):
    """The five BEiT-3 heads and VLMo's ITM and MLM, with a text padding
    mask where the head takes one."""
    cls = {"cls": tb3.BEiT3ForImageClassification,
           "retrieval": tb3.BEiT3ForRetrieval,
           "captioning": tb3.BEiT3ForCaptioning,
           "vqa": functools.partial(tb3.BEiT3ForVisualQuestionAnswering,
                                    num_answers=11),
           "nlvr2": tb3.BEiT3ForVisualReasoning,
           "itm": tvlmo.VLMoForImageTextMatching,
           "mlm": tvlmo.VLMoForMaskedLM}[name]
    jm, params = _jax_head(name)
    tm = _port(cls, params)
    img, txt, pad = _inputs(3)
    img2 = np.flip(img, 1).copy()
    ja = {"cls": (img,), "retrieval": (img, txt, pad),
          "captioning": (img, txt), "vqa": (img, txt, pad),
          "nlvr2": (img, img2, txt, pad), "itm": (img, txt, pad),
          "mlm": (img, txt, pad)}[name]
    want = jm.apply({"params": params}, *map(jnp.asarray, ja))
    with torch.no_grad():
        got = tm(*map(_t, ja))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    if name == "retrieval":
        wv = jm.apply({"params": params}, jnp.asarray(img),
                      method=jm.encode_image)
        wt = jm.apply({"params": params}, jnp.asarray(txt), jnp.asarray(pad),
                      method=jm.encode_text)
        with torch.no_grad():
            _close(tm.encode_image(_t(img)), wv)
            _close(tm.encode_text(_t(txt), _t(pad)), wt)
    if name == "mlm":  # the text-only call: every token through B
        want = jm.apply({"params": params}, None, jnp.asarray(txt),
                        jnp.asarray(pad))
        with torch.no_grad():
            _close(tm(None, _t(txt), _t(pad)), want)


def test_captioning_bias_and_causality():
    """The uni-mask equals JAX's, and changing a later text token leaves
    the earlier text logits unchanged (and changes its own)."""
    _close(tb3.captioning_attn_bias(5, 4), jb3.captioning_attn_bias(5, 4))
    jm, params = _jax_head("captioning")
    tm = _port(tb3.BEiT3ForCaptioning, params)
    img, txt, _ = _inputs(4)
    txt2 = txt.copy()
    txt2[:, 4] = (txt2[:, 4] + 1) % 50
    with torch.no_grad():
        l1, l2 = tm(_t(img), _t(txt)), tm(_t(img), _t(txt2))
    np.testing.assert_array_equal(l1[:, :4].numpy(), l2[:, :4].numpy())
    assert float((l1[:, 4] - l2[:, 4]).abs().max()) > 1e-4
    _close(l2, jm.apply({"params": params}, jnp.asarray(img),
                        jnp.asarray(txt2)))


# ---- the registry ----------------------------------------------------------

PORTED = ("beit_base_patch16_224", "beit_base_patch16_384",
          "beit_large_patch16_224", "beit_large_patch16_384",
          "beit_large_patch16_512", "dit_base_patch16_224",
          "dit_large_patch16_224", "beit3_base", "beit3_large",
          "layoutlm_base", "layoutlmv2_base", "layoutlmv3_base",
          "layoutlmv3_large", "markuplm_base", "trocr_small",
          "trocr_base", "trocr_large", "kosmos2", "kosmos2_5", "yoco_base",
          "retnet_base", "retnet_medium", "xlmt_base", "xlmt_big",
          "diff_transformer_base", "unilm_seq2seq_base", "wavlm_base",
          "e5_base")


def test_registry_names_equal_jax():
    assert treg.names() == jreg.names()
    assert sorted(PORTED) == treg.names()


@pytest.mark.parametrize("name", PORTED)
def test_registry_builds_ported_arch(name):
    """The config equals the JAX factory's on every field the two share
    (dtypes aside), and the model is the JAX class's port (on the meta
    device: the tree without memory)."""
    cfg, model = treg.build(name, device="meta")
    jcfg_fn, jcls = jreg._ARCHS[name]
    jcfg = jcfg_fn()
    assert type(model).__name__ == jcls.__name__
    skip = {"dtype", "param_dtype", "clip", "pix2struct", "audio"}
    shared = [f for f in jcfg.__dataclass_fields__
              if f not in skip and f in cfg.__dataclass_fields__]
    assert len(shared) >= 5, shared
    for f in shared:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert all(p.device.type == "meta" for p in model.parameters())


def test_registry_build_overrides_and_device():
    cfg, model = treg.build("beit3_base", device="cpu", num_layers=1,
                            embed_dim=32, num_heads=4, ffn_dim=64,
                            vocab_size=50, num_classes=3)
    assert (cfg.num_layers, cfg.num_classes) == (1, 3)
    assert isinstance(model, tb3.BEiT3ForImageClassification)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            treg.build("beit3_base")


# ---- the dispatcher's choice of kernel -------------------------------------

# Every attention call shape of the slice's smoke phases (chip_smoke.py
# `beit3` and `beit2`): (B, T, H, D, key padding mask, bias shape).
SLICE_CALLS = {
    "beit3 classification / retrieval image tower": (64, 197, 12, 64,
                                                     False, None),
    "beit3 vqa / vlmo": (32, 237, 12, 64, True, None),
    "beit3 nlvr2": (16, 237, 12, 64, True, None),
    "beit3 captioning": (32, 229, 12, 64, False, (1, 1, 229, 229)),
    "beit3 retrieval text tower": (64, 40, 12, 64, True, None),
    "vq-kd encoder": (64, 196, 12, 64, False, None),
    "beit2 backbone": (64, 197, 12, 64, False, (1, 12, 197, 197)),
}


def _jax_choice(monkeypatch, B_, T, H, D, masked, bias):
    """The kernel unilm_tpu's dispatcher picks for a bf16 call on its
    kernel path, traced abstractly (jax.eval_shape) with the kernels'
    entry points replaced by recorders."""
    from unilm_tpu.ops import attention as jatt
    from unilm_tpu.ops import doc_attention as jda
    from unilm_tpu.ops import flash_attention as jfa

    seen = []
    monkeypatch.setenv("UNILM_TPU_FLASH_INTERPRET", "1")
    monkeypatch.delenv("UNILM_TPU_DISABLE_FLASH", raising=False)
    monkeypatch.setattr(jfa, "fused_encoder_attention",
                        lambda q, *a, **k: seen.append("#3") or q)
    monkeypatch.setattr(jda, "doc_attention",
                        lambda q, *a, **k: seen.append("#9") or q)
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda q, *a, **k: seen.append("flash") or q)
    sds = jax.ShapeDtypeStruct
    q = sds((B_, T, H, D), jnp.bfloat16)
    args = [q, q, q,
            sds((B_, T), jnp.bool_) if masked else None,
            None if bias is None else sds(bias, jnp.bfloat16)]
    jax.eval_shape(lambda q, k, v, m, b: jatt.attention(
        q, k, v, bias=b, key_padding_mask=m), *args)
    return seen or ["xla"]


class _FakeCuda(torch.Tensor):
    """A tensor that reports itself as a CUDA one, so the dispatcher takes
    its card branches without a card."""

    @property
    def is_cuda(self):
        return True


def _port_choice(monkeypatch, B_, T, H, D, masked, bias):
    from unilm_tpu_torch.ops import attention as tatt
    from unilm_tpu_torch.ops import doc_attention as tda
    from unilm_tpu_torch.ops import flash_attention as tfa

    seen = []
    monkeypatch.setattr(tfa, "fused_encoder_attention",
                        lambda q, *a, **k: seen.append("#3") or q)
    monkeypatch.setattr(tda, "doc_attention",
                        lambda q, *a, **k: seen.append("#9") or q)
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, *a, **k: seen.append("flash") or q)
    fake = lambda *s, dt=torch.bfloat16: torch.empty(
        *s, dtype=dt, device="meta").as_subclass(_FakeCuda)
    q = fake(B_, T, H, D)
    tatt.attention(q, q, q,
                   key_padding_mask=fake(B_, T, dt=torch.bool) if masked
                   else None,
                   bias=None if bias is None else fake(*bias))
    return seen or ["plain"]


@pytest.mark.parametrize("call", sorted(SLICE_CALLS))
def test_dispatch_matches_jax(monkeypatch, call):
    """For every call shape of the slice the port launches the kernel
    JAX's dispatcher picks (unilm_tpu/ops/attention.py:139-195): #3
    without a mask (its backward #4 under autograd), #9 with one. The
    backward follows the forward's autograd Function, as in JAX."""
    shape = SLICE_CALLS[call]
    want = _jax_choice(monkeypatch, *shape)
    got = _port_choice(monkeypatch, *shape)
    assert got == want
    assert want == (["#9"] if shape[4] else ["#3"])
