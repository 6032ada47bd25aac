"""Port parity for the rest of Document AI: LayoutLM, MarkupLM (token
classification and QA), LayoutLMv2 (with and without images, its
ConvBackbone alone, the RE head), convert/docai.py, the fine-tune steps
and the attention route, unilm_tpu_torch against unilm_tpu (and HF
transformers) on the CPU.

Inputs come from numpy; JAX runs in float32 at matmul precision
'highest' (tests/conftest.py), weights go from JAX to the port through
convert/from_jax.py. Tolerances, with their reasons:
- logits: 3e-4 abs against JAX (XLA and, for LayoutLMv2, the
  interpret-mode doc kernel) and against HF, the bound of the JAX
  package's own HF parity tests (fp32 through 2 layers and LayerNorms,
  summed in other orders);
- the backbone's features: 1e-5 abs (fp32 convolutions and the same
  triangle filter, summed in other orders);
- the RE head: 1e-5 abs (one fp32 biaffine contraction);
- two AdamW steps (lr 1e-5, weight decay 0.01, clip 1.0): losses and grad
  norms 1e-5 relative, every parameter within 1e-6 + 1e-5 relative (as
  tests/test_torch_layoutlmv3.py), those with a zero gradient up to
  rounding (key biases, the backbone's conv biases before a one-channel
  GroupNorm group) within 5e-5;
- the doc route against the plain attention: logits 1e-5 abs, gradients
  1e-6 abs + 1e-4 relative (the two plain twins sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu.models import layoutlm as jl1
from unilm_tpu.models import layoutlmv2 as jl2
from unilm_tpu.models import markuplm as jml
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.convert.docai import convert_layoutlm, convert_markuplm
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.core import attention as tcore_attention
from unilm_tpu_torch.models import layoutlm as tl1
from unilm_tpu_torch.models import layoutlmv2 as tl2
from unilm_tpu_torch.models import markuplm as tml
from unilm_tpu_torch.ops import doc_attention as tda
from unilm_tpu_torch.runtime import optim as toptim
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(2)

# 2 layers, hidden 128, 2 heads of D=64 (a head width the CUDA kernels take)
COMMON = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2,
              ffn_dim=256, num_labels=5)
KW = {
    "layoutlm": dict(COMMON, max_positions=64, max_2d_positions=1024),
    "markuplm": dict(COMMON, max_positions=64, max_depth=4,
                     max_xpath_tag_units=16, max_xpath_subs_units=20,
                     xpath_unit_hidden=8, tag_pad_id=15, subs_pad_id=19),
    # 4 * 22 + 2 * 20 = 128; 32x32 pages through two stride-2 convs to a
    # 2x2 grid (4 visual tokens)
    "layoutlmv2": dict(COMMON, max_positions=64, coordinate_size=22,
                       shape_size=20, image_feature_pool_shape=(2, 2),
                       backbone_channels=(8, 16)),
}
B, L = 2, 24


def _inputs(seed=0, pad_id=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, COMMON["vocab_size"], (B, L)).astype(np.int32)
    ids[0, 18:] = pad_id
    mask = (ids != pad_id).astype(np.int32)
    xs, ys = (np.sort(rng.randint(0, 900, (B, L, 2)), -1) for _ in "xy")
    bbox = np.stack([xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1]],
                    -1).astype(np.int32)  # x0 <= x1, y0 <= y1
    imgs = rng.rand(B, 32, 32, 3).astype(np.float32)
    tags = rng.randint(0, 16, (B, L, 4)).astype(np.int32)
    subs = rng.randint(0, 20, (B, L, 4)).astype(np.int32)
    labels = rng.randint(0, COMMON["num_labels"], (B, L)).astype(np.int32)
    labels[0, 18:] = -100
    labels[1, ::5] = -100
    return dict(ids=ids, mask=mask, bbox=bbox, imgs=imgs, tags=tags,
                subs=subs, labels=labels)


# (JAX class, port class, config classes, the call's inputs by name)
MODELS = {
    "layoutlm": (jl1.LayoutLMForTokenClassification,
                 tl1.LayoutLMForTokenClassification,
                 jl1.LayoutLMConfig, tl1.LayoutLMConfig,
                 ("ids", "bbox", "mask")),
    "markuplm": (jml.MarkupLMForTokenClassification,
                 tml.MarkupLMForTokenClassification,
                 jml.MarkupLMConfig, tml.MarkupLMConfig,
                 ("ids", "tags", "subs", "mask")),
    "markuplm_qa": (jml.MarkupLMForQuestionAnswering,
                    tml.MarkupLMForQuestionAnswering,
                    jml.MarkupLMConfig, tml.MarkupLMConfig,
                    ("ids", "tags", "subs", "mask")),
    "layoutlmv2": (jl2.LayoutLMv2ForTokenClassification,
                   tl2.LayoutLMv2ForTokenClassification,
                   jl2.LayoutLMv2Config, tl2.LayoutLMv2Config,
                   ("ids", "bbox", "mask", "imgs")),
    "layoutlmv2_text": (jl2.LayoutLMv2ForTokenClassification,
                        tl2.LayoutLMv2ForTokenClassification,
                        jl2.LayoutLMv2Config, tl2.LayoutLMv2Config,
                        ("ids", "bbox", "mask")),
}


def _kw(name):
    return KW[name.split("_")[0]]


def _pad_id(name):
    return 1 if name.startswith("markuplm") else 0


def _jax_setup(name, **cfg_kw):
    """(JAX model, its params from init on the full inputs, the inputs)."""
    jcls, _, jcfg_cls, _, _ = MODELS[name]
    x = _inputs(pad_id=_pad_id(name))
    full = MODELS[name.replace("_text", "")][4]
    jm = jcls(jcfg_cls(**_kw(name), **cfg_kw))
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(x[k]) for k in full))["params"])
    return jm, params, x


def _port(name, params, **cfg_kw):
    _, tcls, _, tcfg_cls, _ = MODELS[name]
    model = tcls(tcfg_cls(**_kw(name), **cfg_kw)).eval()
    load_flax_params(model, params)
    return model


def _targs(name, x):
    return [torch.from_numpy(x[k]).long() if x[k].dtype == np.int32
            else torch.from_numpy(x[k]) for k in MODELS[name][4]]


def _close(got, want, atol=3e-4):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    """Every head on the same weights and inputs: LayoutLM, MarkupLM's
    token and QA heads, LayoutLMv2 with images (text + 4 visual tokens,
    the dense bias over both) and without."""
    jm, params, x = _jax_setup(name)
    want = jm.apply({"params": params},
                    *(jnp.asarray(x[k]) for k in MODELS[name][4]))
    model = _port(name, params)
    with torch.no_grad():
        got = model(*_targs(name, x))
    _close(got, want)


def test_layoutlmv2_matches_jax_doc_kernel(monkeypatch):
    """LayoutLMv2 against the JAX model whose attention runs the
    interpret-mode doc kernel (the TPU route of the dense per-example bias
    with the key-padding mask)."""
    monkeypatch.setenv("UNILM_TPU_FLASH_INTERPRET", "1")
    jm, params, x = _jax_setup("layoutlmv2", use_flash=True)
    want = jm.apply({"params": params},
                    *(jnp.asarray(x[k]) for k in MODELS["layoutlmv2"][4]))
    with torch.no_grad():
        got = _port("layoutlmv2", params)(*_targs("layoutlmv2", x))
    _close(got, want)


@pytest.mark.parametrize("hw,channels,grid", [
    ((32, 32), (8, 16), (2, 2)),  # even sides: SAME pads (0, 1); shrink 8->2
    ((33, 30), (8, 16), (2, 3)),  # odd and even sides, shrink by 4.5 / 2.7
    ((16, 16), (8, 16, 32), (7, 7)),  # 2x2 features grown to 7x7
])
def test_conv_backbone_matches_jax(hw, channels, grid):
    """The backbone alone: flax's SAME padding at stride 2, GroupNorm at eps
    1e-6 and jax.image.resize's antialiased bilinear, against JAX."""
    cfg_kw = dict(_kw("layoutlmv2"), backbone_channels=channels,
                  image_feature_pool_shape=grid)
    imgs = np.random.RandomState(3).randn(2, *hw, 3).astype(np.float32)
    jb = jl2.ConvBackbone(jl2.LayoutLMv2Config(**cfg_kw))
    params = jax.device_get(jb.init(jax.random.PRNGKey(1),
                                    jnp.asarray(imgs))["params"])
    # non-trivial GroupNorm affines
    rng = np.random.RandomState(4)
    for k, v in params.items():
        if k.startswith("gn_"):
            params[k] = {n: a + rng.randn(*a.shape).astype(np.float32) * 0.1
                         for n, a in v.items()}
    want = jb.apply({"params": params}, jnp.asarray(imgs))
    tb = tl2.ConvBackbone(tl2.LayoutLMv2Config(**cfg_kw))
    tb.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(imgs))
    assert got.shape == (2, grid[0] * grid[1], channels[-1])
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("n", [5, 6, 7, 224, 225])
def test_same_pad_is_flax_same(n):
    """same_pad's (low, high) gives flax's output length ceil(n / 2) with
    the odd pixel at the high end."""
    lo, hi = tl2.same_pad(n)
    assert (n + lo + hi - 3) // 2 + 1 == -(-n // 2)
    assert hi - lo in (0, 1)
    assert tl2.same_pad(224) == (0, 1)


def test_visual_grid_bbox_matches_jax():
    for grid in ((7, 7), (2, 3)):
        np.testing.assert_array_equal(tl2.visual_grid_bbox(grid),
                                      jl2.visual_grid_bbox(grid))


def test_re_head_matches_jax():
    rng = np.random.RandomState(5)
    seq = rng.randn(B, L, 32).astype(np.float32)
    hidx = rng.randint(0, L, (B, 6)).astype(np.int32)
    tidx = rng.randint(0, L, (B, 6)).astype(np.int32)
    jre = jl2.RelationExtractionHead(hidden_size=32, num_relations=3)
    args = tuple(map(jnp.asarray, (seq, hidx, tidx)))
    params = jax.device_get(jre.init(jax.random.PRNGKey(2), *args)["params"])
    want = jre.apply({"params": params}, *args)
    tre = tl2.RelationExtractionHead(32, 3)
    load_flax_params(tre, params)
    with torch.no_grad():
        got = tre(torch.from_numpy(seq), torch.from_numpy(hidx).long(),
                  torch.from_numpy(tidx).long())
    assert got.shape == (B, 6, 3)
    _close(got, want, atol=1e-5)


# --------------------------------------------------------------------------- #
# convert/docai.py against HF transformers (random weights)
# --------------------------------------------------------------------------- #

def _hf(kind, qa=False):
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=COMMON["vocab_size"],
                  hidden_size=COMMON["hidden_size"], num_hidden_layers=2,
                  num_attention_heads=COMMON["num_heads"],
                  intermediate_size=COMMON["ffn_dim"],
                  max_position_embeddings=64, num_labels=2 if qa else 5,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    if kind == "layoutlm":
        cfg = transformers.LayoutLMConfig(max_2d_position_embeddings=1024,
                                          **common)
        return transformers.LayoutLMForTokenClassification(cfg).eval()
    cfg = transformers.MarkupLMConfig(
        max_depth=4, max_xpath_tag_unit_embeddings=16,
        max_xpath_subs_unit_embeddings=20, xpath_unit_hidden_size=8,
        tag_pad_id=15, subs_pad_id=19, type_vocab_size=2, pad_token_id=1,
        **common)
    cls = (transformers.MarkupLMForQuestionAnswering if qa
           else transformers.MarkupLMForTokenClassification)
    return cls(cfg).eval()


@pytest.mark.parametrize("name", ["layoutlm", "markuplm", "markuplm_qa"])
def test_convert_docai_matches_hf(name):
    """Three ways: HF, the port with convert/docai.py's tree, and the JAX
    model with the JAX converter's tree, on the valid positions (HF and
    the two ports treat a padded query row alike only up to its mask)."""
    from unilm_tpu.convert import docai as jconvert

    kind = name.split("_")[0]
    hf = _hf(kind, qa=name.endswith("qa"))
    x = _inputs(pad_id=_pad_id(name))
    t = {k: torch.from_numpy(v).long() for k, v in x.items()
         if k != "imgs"}
    with torch.no_grad():
        if kind == "layoutlm":
            out = hf(input_ids=t["ids"], bbox=t["bbox"],
                     attention_mask=t["mask"])
        else:
            out = hf(input_ids=t["ids"], xpath_tags_seq=t["tags"],
                     xpath_subs_seq=t["subs"], attention_mask=t["mask"])
    ref = ([out.start_logits, out.end_logits] if name.endswith("qa")
           else [out.logits])
    convert = convert_layoutlm if kind == "layoutlm" else convert_markuplm
    jfn = (jconvert.convert_layoutlm if kind == "layoutlm"
           else jconvert.convert_markuplm)
    _, tcls, jcfg_cls, tcfg_cls, keys = MODELS[name]
    jcls = MODELS[name][0]
    model = tcls(tcfg_cls(**_kw(name))).eval()
    load_flax_params(model, convert(hf.state_dict(), model.cfg))
    with torch.no_grad():
        got = model(*_targs(name, x))
    jcfg = jcfg_cls(**_kw(name), use_flash=False)
    want = jcls(jcfg).apply({"params": jfn(hf.state_dict(), jcfg)},
                            *(jnp.asarray(x[k]) for k in keys))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    valid = x["mask"].astype(bool)
    for g, r, w in zip(got, ref, want):
        g = g.numpy()
        np.testing.assert_allclose(g[valid], r.numpy()[valid], atol=3e-4,
                                   rtol=0)
        np.testing.assert_allclose(g, np.asarray(w), atol=3e-4, rtol=0)


# --------------------------------------------------------------------------- #
# fine-tuning: two steps against make_train_step + optax.adamw
# --------------------------------------------------------------------------- #

LR, WD, CLIP = 1e-5, 0.01, 1.0


@pytest.mark.parametrize("name", ["layoutlm", "markuplm", "layoutlmv2"])
def test_finetune_steps_match_jax(name):
    jm, params, x = _jax_setup(name)
    keys = MODELS[name][4]

    def jloss(p, batch, rng):
        lg = jm.apply({"params": p}, *batch[:-1])
        s, n = jtrain.cross_entropy_loss(lg, jnp.maximum(batch[-1], 0),
                                         mask=batch[-1] != -100)
        return s / n, {}

    jbatch = tuple(jnp.asarray(x[k]) for k in (*keys, "labels"))
    tx = optax.adamw(LR, weight_decay=WD)
    state = jtrain.TrainState.create(params, tx)
    step = jax.jit(jtrain.make_train_step(jloss, tx, clip_grad_norm=CLIP))
    jm_ = []
    for i in range(2):
        state, m = step(state, jbatch, jax.random.PRNGKey(i))
        jm_.append({k: float(v) for k, v in m.items()})
    want = flax_to_state_dict(jax.device_get(state.params))

    model = _port(name, params).train()
    targs = _targs(name, x)
    labels = torch.from_numpy(x["labels"]).long()

    def tloss(m, batch):
        s, n = ttrain.cross_entropy_loss(m(*targs), labels.clamp(min=0),
                                         mask=labels != -100)
        return s / n, {}

    ttx = toptim.AdamW(LR, weight_decay=WD)
    tstate = ttrain.TrainState.create(model, ttx)
    tstep = ttrain.make_train_step(tloss, ttx, clip_grad_norm=CLIP)
    for i in range(2):
        tstate, m = tstep(tstate, None)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jm_[i][k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    # parameters whose gradient is zero but for rounding (a key bias
    # shifts every score of a row alike; a conv bias feeds a GroupNorm of
    # one channel a group), which Adam turns into steps of up to lr each:
    # held to 5e-5 (2.5x two steps at lr 1e-5), as in
    # tests/test_torch_beit_train.py
    for pname, p in model.named_parameters():
        zero_grad = pname.endswith("k_proj.bias") or (
            ".visual.conv_" in pname and pname.endswith(".bias"))
        np.testing.assert_allclose(p.detach().numpy(), want[pname].numpy(),
                                   atol=5e-5 if zero_grad else 1e-6,
                                   rtol=1e-5, err_msg=pname)


# --------------------------------------------------------------------------- #
# the attention route of the dense per-example bias
# --------------------------------------------------------------------------- #

def test_doc_route_gradients_match_plain(monkeypatch):
    """LayoutLMv2's masked, biased attention through the doc attention's
    autograd Function (DocAttentionFn: on the card #9 / #10; here their
    twins) gives the plain path's logits and gradients, the three bias
    tables' included: dbias comes back as the [B, H, T, T] plane, through
    the cast and the gather into each table."""
    _, params, x = _jax_setup("layoutlmv2")
    labels = torch.from_numpy(x["labels"]).long()
    calls = []

    def doc_route(q, k, v, *, bias=None, key_padding_mask=None, scale=None,
                  **kw):
        assert key_padding_mask is not None and bias is not None
        assert bias.shape == (B, 2, L + 4, L + 4) and bias.is_contiguous()
        calls.append(1)
        return tda.doc_attention(q, k, v, bias, key_padding_mask, scale)

    out = []
    for route in (False, True):
        if route:
            monkeypatch.setattr(tcore_attention, "attention", doc_route)
        model = _port("layoutlmv2", params).train()
        logits = model(*_targs("layoutlmv2", x))
        s, n = ttrain.cross_entropy_loss(logits, labels.clamp(min=0),
                                         mask=labels != -100)
        names, ps = zip(*model.named_parameters())
        out.append((logits.detach(), torch.autograd.grad(s / n, ps)))
    assert len(calls) == 2  # both layers
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(),
                               atol=1e-5)
    for name, a, b in zip(names, out[1][1], out[0][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)
    tables = [g for nm, g in zip(names, out[1][1]) if "rel_pos" in nm]
    assert len(tables) == 3 and all(float(t.abs().sum()) > 0 for t in tables)


class _FakeCuda(torch.Tensor):
    """A tensor that reports itself as a CUDA one, so the dispatcher takes
    its card branches without a card."""

    @property
    def is_cuda(self):
        return True


# The smoke's Document AI calls (chip_smoke.py `docai`): (B, T, H, D, bias)
DOCAI_CALLS = {
    "layoutlm / markuplm": (32, 512, 12, 64, False),
    "layoutlmv2 with images": (32, 561, 12, 64, True),
    "layoutlmv2 fine-tune": (16, 561, 12, 64, True),
}


@pytest.mark.parametrize("call", sorted(DOCAI_CALLS))
def test_dispatch_matches_jax(monkeypatch, call):
    """A masked call, with LayoutLMv2's dense float32 [B, H, T, T] bias or
    none, takes the doc kernel (#9, its backward #10) in both packages'
    dispatchers (unilm_tpu/ops/attention.py:176-195), traced abstractly
    on the JAX side with the kernels' entry points replaced by
    recorders."""
    from unilm_tpu.ops import attention as jatt
    from unilm_tpu.ops import doc_attention as jda
    from unilm_tpu.ops import flash_attention as jfa
    from unilm_tpu_torch.ops import attention as tatt
    from unilm_tpu_torch.ops import flash_attention as tfa

    Bc, T, H, D, biased = DOCAI_CALLS[call]
    seen = {"jax": [], "port": []}

    def record(who, tag):
        return lambda q, *a, **k: seen[who].append(tag) or q

    monkeypatch.setenv("UNILM_TPU_FLASH_INTERPRET", "1")
    monkeypatch.delenv("UNILM_TPU_DISABLE_FLASH", raising=False)
    monkeypatch.setattr(jfa, "fused_encoder_attention", record("jax", "#3"))
    monkeypatch.setattr(jda, "doc_attention", record("jax", "#9"))
    monkeypatch.setattr(jfa, "flash_attention", record("jax", "flash"))
    sds = jax.ShapeDtypeStruct
    q = sds((Bc, T, H, D), jnp.bfloat16)
    jax.eval_shape(lambda q, k, v, m, b: jatt.attention(
        q, k, v, bias=b, key_padding_mask=m), q, q, q,
        sds((Bc, T), jnp.bool_),
        sds((Bc, H, T, T), jnp.float32) if biased else None)

    monkeypatch.setattr(tfa, "fused_encoder_attention", record("port", "#3"))
    monkeypatch.setattr(tda, "doc_attention", record("port", "#9"))
    monkeypatch.setattr(tfa, "flash_attention", record("port", "flash"))
    fake = lambda *s, dt=torch.bfloat16: torch.empty(
        *s, dtype=dt, device="meta").as_subclass(_FakeCuda)
    tq = fake(Bc, T, H, D)
    tatt.attention(tq, tq, tq, key_padding_mask=fake(Bc, T, dt=torch.bool),
                   bias=fake(Bc, H, T, T, dt=torch.float32) if biased
                   else None)
    assert seen["port"] == seen["jax"] == ["#9"]


@pytest.mark.parametrize("name,device", [
    (n, d) for n in ("layoutlm_base", "layoutlmv2_base", "markuplm_base")
    for d in ("meta", "cpu")])
def test_registry_builds_docai(name, device):
    """The registry's Document AI names build the JAX classes' ports on
    the meta device (no memory) and on the CPU (cut to one layer), and a
    CPU model runs."""
    from unilm_tpu_torch.models import registry

    kw = {} if device == "meta" else dict(num_layers=1)
    cfg, model = registry.build(name, device=device, **kw)
    assert all(p.device.type == device for p in model.parameters())
    if device == "cpu":
        model.init_weights(torch.Generator().manual_seed(0)).eval()
        ids = torch.randint(3, 100, (1, 8))
        bbox = torch.tensor([[10, 20, 110, 60]]).expand(1, 8, 4)
        with torch.no_grad():
            out = (model(ids) if name == "markuplm_base"
                   else model(ids, bbox))
        assert out.shape == (1, 8, cfg.num_labels)
        assert bool(torch.isfinite(out).all())
