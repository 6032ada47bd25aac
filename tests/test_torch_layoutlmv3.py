"""Port parity for the LayoutLMv3 slice: the T5 buckets, the bucket-bias
machinery, LayoutLMv3ForTokenClassification, its fine-tune step and the
FUNSD CLI's data side, unilm_tpu_torch against unilm_tpu (and HF
transformers) on the CPU.

Inputs come from numpy; JAX runs in float32 at matmul precision
'highest' (tests/conftest.py). Tolerances, with their reasons:
- buckets, packing, tokenization, the FUNSD reader, entity F1: exact;
- the dense bias: 1e-6 (the same table values summed in the same order);
- table gradients: 1e-5 relative (fp32 sums over every position, in
  another order: one-hot products here, XLA's reductions there);
- logits: 3e-4 abs against JAX (dense and the interpret-mode doc kernel)
  and against HF, the bound of the JAX package's own HF parity test
  (fp32 through 2 layers and LayerNorms, summed in other orders);
- two AdamW steps (lr 1e-5, weight decay 0.01, clip 1.0): losses and grad
  norms 1e-5 relative, every parameter within 1e-6 + 1e-5 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu.cli import run_funsd as jfunsd
from unilm_tpu.core import positional as jpos
from unilm_tpu.data import document_datasets as jdocs
from unilm_tpu.models import layoutlmv3 as jl
from unilm_tpu.ops import bucket_bias as jbb
from unilm_tpu import scoring as jscoring
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.cli import run_funsd as tfunsd
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.convert.layoutlmv3 import convert_layoutlmv3
from unilm_tpu_torch.core import positional as tpos
from unilm_tpu_torch.data import document_datasets as tdocs
from unilm_tpu_torch.models import layoutlmv3 as tl
from unilm_tpu_torch.ops import bucket_bias as tbb
from unilm_tpu_torch.ops import doc_attention as tda
from unilm_tpu_torch import scoring as tscoring
from unilm_tpu_torch.runtime import optim as toptim
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(2)

# 2 layers, hidden 128, 2 heads of D=64 (a head width the CUDA kernels
# take), 32x32 images in 16x16 patches (5 visual tokens)
KW = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2,
          ffn_dim=256, max_positions=64, coordinate_size=22, shape_size=20,
          input_size=32, patch_size=16, num_labels=5)
B, L = 2, 24


# --------------------------------------------------------------------------- #
# buckets and the bias machinery
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bidirectional,nb,maxd", [
    (True, 32, 128), (True, 64, 256), (False, 32, 128)])
def test_relative_position_bucket_matches_jax(bidirectional, nb, maxd):
    rel = np.arange(-600, 601, dtype=np.int32)[None]
    want = jpos.relative_position_bucket(jnp.asarray(rel), bidirectional, nb,
                                         maxd)
    got = tpos.relative_position_bucket(torch.from_numpy(rel).long(),
                                        bidirectional, nb, maxd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _planes(Bp=2, T=29, nbs=(32, 64, 64), seed=0):
    rng = np.random.RandomState(seed)
    planes = [rng.randint(0, nb, (Bp, T, T)).astype(np.int32) for nb in nbs]
    tables = [(rng.randn(nb, 4) * 0.3).astype(np.float32) for nb in nbs]
    return planes, tables


@pytest.mark.parametrize("nbs", [(32, 64, 64), (48,)])
def test_pack_and_materialize_match_jax(nbs):
    planes, tables = _planes(nbs=nbs)
    jp = jbb.pack_bucket_planes(*(jnp.asarray(p) for p in planes))
    tp = tbb.pack_bucket_planes(*(torch.from_numpy(p) for p in planes))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for t in range(len(planes)):
        np.testing.assert_array_equal(tbb.unpack_field(tp, t).numpy(),
                                      planes[t])
    sym = jbb.BucketBias(packed=jp, tables=tuple(map(jnp.asarray, tables)),
                         scale=0.25)
    tt = [torch.from_numpy(t) for t in tables]
    for layout in ("bhts", "hbts"):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jbb.materialize_bias(sym, jdt, layout)
                              .astype(jnp.float32))
            got = tbb.materialize_bias(tp, tt, 0.25, tdt)  # [H, B, T, S]
            if layout == "bhts":
                got = tda.HeadMajorBias(got).bhts()
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                                       err_msg=f"{layout} {tdt}")


@pytest.mark.parametrize("layout,bcast", [("hbts", False), ("hbts", True),
                                          ("bhts", False)])
def test_collector_table_grads_match_jax(layout, bcast):
    """Two 'layers' read the same bias; the collector's one contraction of
    their summed gradient equals JAX's collector VJP and torch's autograd
    through the dense lookup. The port's bias is head-major; "bhts" reads
    it through HeadMajorBias.bhts(), as the CPU attention path does."""
    Bp = 1 if bcast else 2
    planes, tables = _planes(Bp=Bp, seed=5)
    Bq, T, H = 2, planes[0].shape[1], 4
    shape = (H, Bq, T, T) if layout == "hbts" else (Bq, H, T, T)
    rng = np.random.RandomState(9)
    g1, g2 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jp = jbb.pack_bucket_planes(*(jnp.asarray(p) for p in planes))

    def jloss(tabs):
        sym = jbb.BucketBias(packed=jp, tables=tabs, scale=0.25)
        dense = jax.lax.stop_gradient(jnp.broadcast_to(
            jbb.materialize_bias(sym, jnp.float32, layout), shape))
        bias = dense + jbb.bias_grad_collector(tabs, jp, shape, "float32",
                                               0.25, layout)
        return jnp.sum(bias * g1) + jnp.sum(bias * g2)

    want = jax.grad(jloss)(tuple(map(jnp.asarray, tables)))
    tp = tbb.pack_bucket_planes(*(torch.from_numpy(p) for p in planes))
    for use_collector in (True, False):
        tt = [torch.from_numpy(t).requires_grad_() for t in tables]
        if use_collector:
            bias = tbb.bias_grad_collector(tt, tp, 0.25, torch.float32)
        else:
            bias = tbb.materialize_bias(tp, tt, 0.25, torch.float32)
        if layout == "bhts":
            bias = tda.HeadMajorBias(bias).bhts()
        bias = bias.expand(shape)
        loss = (bias * torch.from_numpy(g1)).sum() + (
            bias * torch.from_numpy(g2)).sum()
        got = torch.autograd.grad(loss, tt)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-4)


# --------------------------------------------------------------------------- #
# the model against JAX and HF
# --------------------------------------------------------------------------- #

def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, KW["vocab_size"], (B, L)).astype(np.int32)
    ids[0, 18:] = 1  # padding (pad_token_id 1)
    mask = (ids != 1).astype(np.int32)
    xy = rng.randint(0, 900, (B, L, 2, 2))
    xy.sort(axis=2)
    bbox = xy.transpose(0, 1, 3, 2).reshape(B, L, 4).astype(np.int32)
    imgs = rng.rand(B, 32, 32, 3).astype(np.float32)
    seg = rng.randint(0, 4, (B, L))
    seg[0, 18:] = -1
    vs = seg[:, :, None] == seg[:, None, :]
    labels = rng.randint(0, KW["num_labels"], (B, L)).astype(np.int32)
    labels[0, 18:] = -100
    labels[1, ::5] = -100
    return ids, mask, bbox, imgs, vs, labels


def _jax_params(cfg):
    ids, mask, bbox, imgs, _, _ = _inputs()
    model = jl.LayoutLMv3ForTokenClassification(cfg)
    return jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(bbox),
        jnp.asarray(mask), jnp.asarray(imgs))["params"])


def _torch_args(image, span, inputs=None):
    ids, mask, bbox, imgs, vs, _ = inputs or _inputs()
    return (torch.from_numpy(ids).long(), torch.from_numpy(bbox).long(),
            torch.from_numpy(mask), torch.from_numpy(imgs) if image else None,
            torch.from_numpy(vs) if span else None)


@pytest.mark.parametrize("image,span,fused,jax_mode", [
    (True, True, True, "dense"), (True, True, True, "interpret"),
    (False, False, True, "interpret"), (True, False, False, "dense"),
    (False, True, False, "interpret"), (True, True, False, "interpret"),
])
def test_token_classification_matches_jax(monkeypatch, image, span, fused,
                                          jax_mode):
    if jax_mode == "interpret":  # the doc kernel, as tests/test_bucket_bias.py
        monkeypatch.setenv("UNILM_TPU_FLASH_INTERPRET", "1")
    jcfg = jl.LayoutLMv3Config(**KW, fused_bias=fused,
                               use_flash=jax_mode == "interpret")
    params = _jax_params(jcfg)
    ids, mask, bbox, imgs, vs, _ = _inputs()
    want = jl.LayoutLMv3ForTokenClassification(jcfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(bbox),
        jnp.asarray(mask), jnp.asarray(imgs) if image else None,
        jnp.asarray(vs) if span else None)
    model = tl.LayoutLMv3ForTokenClassification(
        tl.LayoutLMv3Config(**KW, fused_bias=fused)).eval()
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(*_torch_args(image, span))
    assert got.dtype == torch.float32 and got.shape == (B, L, KW["num_labels"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4,
                               rtol=0)


@pytest.mark.parametrize("head,layers", [("seq", 2), ("qa", 2),
                                         ("token", 13)])
def test_other_heads_match_jax(head, layers):
    """Sequence classification (dense-tanh head on the first token), QA
    (start, end) and the token head beyond 12 layers (the dense-tanh
    head, 13 layers of the tiny width)."""
    jcls, tcls = {
        "seq": (jl.LayoutLMv3ForSequenceClassification,
                tl.LayoutLMv3ForSequenceClassification),
        "qa": (jl.LayoutLMv3ForQuestionAnswering,
               tl.LayoutLMv3ForQuestionAnswering),
        "token": (jl.LayoutLMv3ForTokenClassification,
                  tl.LayoutLMv3ForTokenClassification)}[head]
    kw = dict(KW, num_layers=layers)
    jcfg = jl.LayoutLMv3Config(**kw, use_flash=False)
    ids, mask, bbox, imgs, vs, _ = _inputs()
    jargs = tuple(map(jnp.asarray, (ids, bbox, mask, imgs, vs)))
    params = jax.device_get(jcls(jcfg).init(jax.random.PRNGKey(1),
                                            *jargs)["params"])
    want = jcls(jcfg).apply({"params": params}, *jargs)
    model = tcls(tl.LayoutLMv3Config(**kw)).eval()
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(*_torch_args(True, True))
    for a, w in zip(got if head == "qa" else [got],
                    want if head == "qa" else [want]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-4,
                                   rtol=0)


def test_fused_bias_matches_materialized():
    """fused_bias on (head-major collector) and off (dense [B,H,T,S]) give
    the same logits and the same gradients, the bias tables' included."""
    params = _jax_params(jl.LayoutLMv3Config(**KW))
    labels = torch.from_numpy(_inputs()[5]).long()
    out = []
    for fused in (True, False):
        model = tl.LayoutLMv3ForTokenClassification(
            tl.LayoutLMv3Config(**KW, fused_bias=fused))
        load_flax_params(model, params)
        logits = model(*_torch_args(True, True))
        s, n = ttrain.cross_entropy_loss(logits, labels.clamp(min=0),
                                         mask=labels != -100)
        grads = torch.autograd.grad(s / n, list(model.parameters()))
        out.append((logits.detach(), grads))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               atol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    for name, a, b in zip(names, out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def _hf_model(visual):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LayoutLMv3Config(
        vocab_size=KW["vocab_size"], hidden_size=KW["hidden_size"],
        num_hidden_layers=KW["num_layers"],
        num_attention_heads=KW["num_heads"],
        intermediate_size=KW["ffn_dim"],
        max_position_embeddings=KW["max_positions"],
        coordinate_size=KW["coordinate_size"], shape_size=KW["shape_size"],
        input_size=KW["input_size"], patch_size=KW["patch_size"],
        num_labels=KW["num_labels"], visual_embed=visual, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers.LayoutLMv3ForTokenClassification(hf_cfg).eval()


@pytest.mark.parametrize("visual", [False, True])
def test_token_classification_matches_hf(visual):
    """Three ways: HF, the port with HF's converted weights, and the JAX
    model with the JAX converter's weights."""
    from unilm_tpu.convert.layoutlmv3 import convert_layoutlmv3 as jconvert

    hf = _hf_model(visual)
    ids, mask, bbox, imgs, _, _ = _inputs()
    ids = ids.copy()
    ids[:, 0] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids).long(),
                 bbox=torch.from_numpy(bbox).long(),
                 attention_mask=torch.from_numpy(mask).long(),
                 pixel_values=(torch.from_numpy(imgs.transpose(0, 3, 1, 2))
                               if visual else None)).logits.numpy()
    cfg = tl.LayoutLMv3Config(**KW, visual_embed=visual, type_vocab_size=2)
    model = tl.LayoutLMv3ForTokenClassification(cfg).eval()
    model.load_state_dict(convert_layoutlmv3(hf.state_dict(), cfg),
                          strict=True)
    inputs = (ids, mask, bbox, imgs, None, None)
    with torch.no_grad():
        got = model(*_torch_args(visual, False, inputs)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=0)
    jcfg = jl.LayoutLMv3Config(**KW, visual_embed=visual, type_vocab_size=2,
                               use_flash=False)
    want = jl.LayoutLMv3ForTokenClassification(jcfg).apply(
        {"params": jconvert(hf.state_dict(), jcfg)}, jnp.asarray(ids),
        jnp.asarray(bbox), jnp.asarray(mask),
        jnp.asarray(imgs) if visual else None)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-4, rtol=0)


# --------------------------------------------------------------------------- #
# fine-tuning: two steps against make_train_step + optax.adamw
# --------------------------------------------------------------------------- #

LR, WD, CLIP = 1e-5, 0.01, 1.0


def test_finetune_steps_match_jax():
    jcfg = jl.LayoutLMv3Config(**KW, use_flash=False)
    params = _jax_params(jcfg)
    ids, mask, bbox, imgs, vs, labels = _inputs()
    jmodel = jl.LayoutLMv3ForTokenClassification(jcfg)

    def jloss(p, batch, rng):
        lg = jmodel.apply({"params": p}, *batch[:5])
        s, n = jtrain.cross_entropy_loss(lg, jnp.maximum(batch[5], 0),
                                         mask=batch[5] != -100)
        return s / n, {}

    jbatch = tuple(map(jnp.asarray, (ids, bbox, mask, imgs, vs, labels)))
    tx = optax.adamw(LR, weight_decay=WD)
    state = jtrain.TrainState.create(params, tx)
    step = jax.jit(jtrain.make_train_step(jloss, tx, clip_grad_norm=CLIP))
    jm = []
    for i in range(2):
        state, m = step(state, jbatch, jax.random.PRNGKey(i))
        jm.append({k: float(v) for k, v in m.items()})
    want = flax_to_state_dict(jax.device_get(state.params))

    model = tl.LayoutLMv3ForTokenClassification(tl.LayoutLMv3Config(**KW))
    load_flax_params(model, params)
    tlabels = torch.from_numpy(labels).long()
    targs = _torch_args(True, True)

    def tloss(m, batch):
        s, n = ttrain.cross_entropy_loss(m(*targs), tlabels.clamp(min=0),
                                         mask=tlabels != -100)
        return s / n, {}

    ttx = toptim.AdamW(LR, weight_decay=WD)
    tstate = ttrain.TrainState.create(model, ttx)
    tstep = ttrain.make_train_step(tloss, ttx, clip_grad_norm=CLIP)
    for i in range(2):
        tstate, m = tstep(tstate, None)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jm[i][k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


# --------------------------------------------------------------------------- #
# the FUNSD CLI's data side
# --------------------------------------------------------------------------- #

WORDS = ["Date", "Name", ":", "John", "Smith", "Invoice", "total", "12.50",
         "Signature"]


def _tokenizer():
    """A tiny fast WordPiece tokenizer (no files, no network): every word
    of WORDS, some split in two subwords, with <s> ... </s> around."""
    pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for w in ["Date", "Name", ":", "John", "Sm", "##ith", "Inv", "##oice",
              "total", "12", "##.", "##50", "Signature"]:
        vocab[w] = len(vocab)
    tk = Tokenizer(models.WordPiece(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", unk_token="<unk>")


def _funsd_folder(root):
    """A synthetic FUNSD split: two documents with question/answer/header/
    other segments and a PNG page each."""
    Image = pytest.importorskip("PIL.Image")
    os.makedirs(os.path.join(root, "annotations"))
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.RandomState(0)
    for d in range(2):
        form, x = [], 10
        for si, (label, words) in enumerate([
                ("header", WORDS[5:7]), ("question", WORDS[:3]),
                ("answer", WORDS[3:5]), ("other", [" "]),
                ("answer", WORDS[7:9][d:])]):
            ws = []
            for w in words:
                ws.append({"text": w, "box": [x, 20 + 30 * si, x + 40,
                                              40 + 30 * si]})
                x += 45
            form.append({"label": label, "words": ws})
        with open(os.path.join(root, "annotations", f"doc{d}.json"), "w") as f:
            json.dump({"form": form}, f)
        Image.fromarray(rng.randint(0, 256, (300 + 50 * d, 400, 3))
                        .astype(np.uint8)).save(
            os.path.join(root, "images", f"doc{d}.png"))


def test_funsd_reader_and_alignment_match_jax(tmp_path):
    _funsd_folder(str(tmp_path))
    got = tdocs.load_funsd(str(tmp_path))
    assert got == jdocs.load_funsd(str(tmp_path))
    assert got[0]["labels"][:2] == ["B-HEADER", "I-HEADER"]
    tok = _tokenizer()
    for ex in got:
        for a, b in zip(tfunsd.tokenize_and_align(tok, ex, 16),
                        jfunsd.tokenize_and_align(tok, ex, 16)):
            np.testing.assert_array_equal(a, b)
    ids, _, _, labels, segs = tfunsd.tokenize_and_align(tok, got[0], 16)
    assert (labels != -100).sum() == len(got[0]["words"])  # first subwords
    assert segs[0] == -1 and ids[0] == 0


def test_entity_f1_matches_jax():
    rng = np.random.RandomState(1)
    labs = tdocs.FUNSD_LABELS
    true = [[labs[i] for i in rng.randint(0, 7, 30)] for _ in range(5)]
    pred = [[labs[i] for i in rng.randint(0, 7, 30)] for _ in range(5)]
    pred[0] = list(true[0])
    for t, p in ((true, pred), (true, true)):
        assert tscoring.entity_f1(t, p) == jscoring.entity_f1(t, p)
        assert tscoring.extract_entities(t[0]) == jscoring.extract_entities(t[0])


def test_funsd_cli_end_to_end(tmp_path, monkeypatch):
    """main() on the synthetic split with the tiny tokenizer, on the CPU,
    at the tiny width (the CLI's config constructor patched), reports
    entity P/R/F1; evaluate_batches gives the model's logits."""
    _funsd_folder(str(tmp_path / "funsd"))
    _tokenizer().save_pretrained(str(tmp_path / "tok"))
    monkeypatch.setattr(tfunsd, "LayoutLMv3Config", lambda num_labels: (
        tl.LayoutLMv3Config(**{**KW, "input_size": 224, "num_labels":
                               num_labels})))
    m = tfunsd.main(["--data_path", str(tmp_path / "funsd"), "--tokenizer",
                     str(tmp_path / "tok"), "--max_len", "16",
                     "--batch_size", "2", "--device", "cpu"])
    assert set(m) == {"precision", "recall", "f1"}
    assert all(0.0 <= v <= 1.0 for v in m.values())
    args = tfunsd.build_parser().parse_args(
        ["--data_path", "x", "--tokenizer", "y", "--device", "cpu"])
    model = tfunsd.build_model(args, torch.device("cpu"))
    ids, mask, bbox, _, _, labels = _inputs()
    seg = np.zeros((B, L), np.int64)
    imgs = np.random.RandomState(0).rand(B, 224, 224, 3).astype(np.float32)
    logits, lab = tfunsd.evaluate_batches(model, [dict(
        input_ids=ids, attention_mask=mask, bbox=bbox, labels=labels,
        segments=seg, images=imgs)])
    assert logits.shape == (B, L, 7) and np.isfinite(logits).all()
    np.testing.assert_array_equal(lab, labels)
