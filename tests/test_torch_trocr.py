"""Port parity for TrOCR (models/trocr.py, convert/trocr.py,
data/trocr_datasets.py, scoring's cer/wer, cli/trocr_infer.py and
cli/trocr_eval.py) against unilm_tpu on the CPU.

Sizes are tests/test_trocr_parity.py's `build_pair`: a DeiT encoder of 32
wide x 2 layers at 32x32 pixels, a post-LN decoder of 48 wide x 2 layers,
vocab 100. Params come from a JAX init (or an HF VisionEncoderDecoder)
and reach the port through convert/from_jax.py; images and tokens come
from numpy seeds. JAX runs its XLA paths at matmul precision `highest`.

Tolerances (float32): logits, encoder outputs and cache leaves 1e-4
(the same fp32 math in another order); token streams identical, beam
scores within 1e-5 relative; int8 trees bit-equal; CER/WER equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import trocr as jt
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.models import trocr as tt
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(img_size=32, patch_size=16, enc_dim=32, enc_layers=2, enc_heads=4,
          enc_ffn=64, distilled=True, vocab_size=100, dec_dim=48,
          dec_layers=2, dec_heads=4, dec_ffn=96, max_positions=64,
          use_flash=False)
B, MAX_NEW = 2, 8
ATOL = 1e-4
SCORE_RTOL = 1e-5
BOS, PAD, EOS = 2, 1, 3  # an eos the random weights seldom draw


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_params():
    """A JAX init of the looped model with every leaf moved off its init
    value (zero tokens and pos_embed, unit norms) by seeded noise."""
    model = jt.TrOCRModel(jt.TrOCRConfig(**KW))
    rng = np.random.RandomState(0)
    params = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 2), jnp.int32)))(
            jax.random.PRNGKey(0))["params"]
    return jax.tree.map(lambda x: np.asarray(x) + (0.05 * rng.randn(
        *x.shape)).astype(np.float32), _np(params))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(B, 32, 32, 3).astype(np.float32),
            rng.randint(4, 100, (B, 7)))


def _port(params, **kw):
    model = tt.TrOCRModel(tt.TrOCRConfig(**KW, **kw), device="cpu").eval()
    load_flax_params(model, params)
    return model


def _jax(scan: bool, **kw):
    return jt.TrOCRModel(jt.TrOCRConfig(**KW, scan_layers=scan, **kw))


def _tree(params, scan: bool):
    return jt.stack_trocr_params(params, KW["dec_layers"]) if scan else params


@pytest.mark.parametrize("scan", [False, True], ids=["looped", "stacked"])
def test_teacher_forced_logits(jax_params, inputs, scan):
    img, tok = inputs
    params = _tree(jax_params, scan)
    ref = np.asarray(_jax(scan).apply({"params": params}, jnp.asarray(img),
                                      jnp.asarray(tok)))
    with torch.no_grad():
        out = _port(_np(params))(torch.from_numpy(img), torch.from_numpy(tok))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    feats = _port(_np(params))(torch.from_numpy(img), torch.from_numpy(tok),
                               return_features=True)
    assert feats.shape == (B, 7, KW["dec_dim"])


def test_encoder_output(jax_params, inputs):
    img, _ = inputs
    jm = _jax(False)
    ref = np.asarray(jm.apply({"params": jax_params}, jnp.asarray(img),
                              method=jm.encode))
    with torch.no_grad():
        out = _port(jax_params).encode(torch.from_numpy(img))
    assert out.shape == (B, 4 + 2, KW["enc_dim"])
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_cache_leaves_match_scanned_stack(jax_params, inputs):
    """Prefill (3 tokens) and two decode steps at B=2: the pools,
    cross_key / cross_value [B, L, S, H, D], pos and cache_index leaf for
    leaf against the JAX scanned stack; the cross leaves are written by
    the prefill only."""
    img, tok = inputs
    params = _tree(jax_params, True)
    jm = _jax(True)
    enc = jm.apply({"params": params}, jnp.asarray(img), method=jm.encode)
    jpf, jst = jt.make_generate_fns(jm, 2 + MAX_NEW)
    model = _port(_np(params))
    tpf, tst = tt.make_generate_fns(model, 2 + MAX_NEW)
    tenc = model.encode(torch.from_numpy(img))
    jl, jc = jpf(params, jnp.asarray(tok[:, :3]), enc)
    tl, tc = tpf(torch.from_numpy(tok[:, :3]), tenc)
    cross = tc["text_decoder"]["decoder"]["cross_key"]
    for j in range(3):
        if j:
            jl, jc = jst(params, jnp.asarray(tok[:, 2 + j:3 + j]), jc, None)
            tl, tc = tst(torch.from_numpy(tok[:, 2 + j:3 + j]), tc, None)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jd, td = jc["text_decoder"]["decoder"], tc["text_decoder"]["decoder"]
        assert set(td) == set(jd)
        for name in ("kv_pool_key", "kv_pool_value", "cross_key",
                     "cross_value"):
            assert td[name].shape == jd[name].shape, name
            np.testing.assert_allclose(td[name].numpy(), np.asarray(jd[name]),
                                       atol=ATOL, rtol=0, err_msg=name)
        assert td["cache_index"] == int(jd["cache_index"]) == 3 + j
        assert tc["text_decoder"]["pos"] == int(jc["text_decoder"]["pos"])
        assert td["cross_key"] is cross
        # a layer's slice is one contiguous block (the kernel reads it)
        assert cross[:, 1].is_contiguous()


def _streams(jm, params, model, img, beam, gen_kw=None):
    gcfg_kw = dict(beam_size=beam, max_new_tokens=MAX_NEW, pad=PAD, eos=EOS,
                   vocab_size=KW["vocab_size"], **(gen_kw or {}))
    enc = jm.apply({"params": params}, jnp.asarray(img), method=jm.encode)
    jpf, jst = jt.make_generate_fns(jm, 2 + MAX_NEW)
    prompt = np.full((B, 1), BOS)
    jfn = jgen.beam_generate if beam > 1 else jgen.greedy_generate
    jout = jfn(jgen.GenerationConfig(**gcfg_kw), jpf, jst, params,
               jnp.asarray(prompt, jnp.int32), aux=enc)
    tpf, tst = tt.make_generate_fns(model, 2 + MAX_NEW)
    with torch.no_grad():
        tout = tgen.generate(tgen.GenerationConfig(**gcfg_kw), tpf, tst,
                             torch.from_numpy(prompt),
                             aux=model.encode(torch.from_numpy(img)))
    return jout, tout


@pytest.mark.parametrize("beam", [1, 5], ids=["greedy", "beam5"])
@pytest.mark.parametrize("scan", [False, True], ids=["looped", "scanned"])
def test_streams_match_jax(jax_params, inputs, scan, beam):
    """Greedy and beam-5 streams at B=2 identical to JAX's looped and
    scanned models; under beam the port's decode runs the folded
    cross-attention (10 query rows over the 2 sentences' shared keys)."""
    img, _ = inputs
    params = _tree(jax_params, scan)
    (jtok, jsc), (ttok, tsc) = _streams(_jax(scan), params,
                                        _port(_np(params)), img, beam)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                               rtol=SCORE_RTOL, atol=0)


def test_quantize_trocr_decoder(jax_params, inputs):
    """The int8 tree bit-equal to JAX's (stacked), the state-dict twin
    equal to the tree's bridge, the encoder untouched; int8 beam-5
    streams identical to JAX's."""
    img, _ = inputs
    params = _tree(jax_params, True)
    jq = _np(jt.quantize_trocr_decoder(params))
    tq = tt.quantize_trocr_decoder(params)
    assert jax.tree.structure(jq) == jax.tree.structure(tq)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(tq)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert "kernel_i8" in tq["text_decoder"]["output_projection"]
    assert "kernel" in tq["vit"]["encoder"]["layers_0"]["self_attn"]["q_proj"]
    twin = tt.quantize_trocr_decoder_state_dict(flax_to_state_dict(params))
    bridged = flax_to_state_dict(tq)
    assert set(twin) == set(bridged)
    for k in twin:
        assert torch.equal(twin[k], bridged[k]), k
    (jtok, jsc), (ttok, tsc) = _streams(
        _jax(True, quant_weights=True), jq,
        _port(tq, quant_weights=True), img, 5)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                               rtol=SCORE_RTOL, atol=0)


# ---- the HF converter ---------------------------------------------------

def _hf_pair():
    """tests/test_trocr_parity.py's pair: a random HF VisionEncoderDecoder
    (DeiT 32 wide, TrOCR decoder 48 wide, so with enc_to_dec_proj)."""
    transformers = pytest.importorskip("transformers")
    enc_cfg = transformers.DeiTConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, image_size=32, patch_size=16)
    dec_cfg = transformers.TrOCRConfig(
        vocab_size=100, d_model=48, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=96,
        max_position_embeddings=64, use_learned_position_embeddings=True,
        layernorm_embedding=True, scale_embedding=False, dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.VisionEncoderDecoderModel(
        transformers.VisionEncoderDecoderConfig.from_encoder_decoder_configs(
            enc_cfg, dec_cfg)).eval()
    kw = dict(KW, enc_eps=1e-12, enc_to_dec_proj=True)
    return hf, kw


def test_convert_trocr_against_hf_and_jax():
    from unilm_tpu.convert.trocr import convert_trocr as jconvert
    from unilm_tpu_torch.convert.trocr import convert_trocr

    hf, kw = _hf_pair()
    sd = hf.state_dict()
    ours = convert_trocr(sd, tt.TrOCRConfig(**kw))
    want = flax_to_state_dict(jconvert(sd, jt.TrOCRConfig(**kw)))
    assert set(ours) == set(want)
    for k in ours:
        assert torch.equal(ours[k], want[k].float()), k
    model = tt.TrOCRModel(tt.TrOCRConfig(**kw), device="cpu").eval()
    model.load_state_dict(ours, strict=True)
    rng = np.random.RandomState(0)
    pix = rng.randn(2, 3, 32, 32).astype(np.float32)
    dec_in = rng.randint(3, 100, (2, 7))
    dec_in[:, 0] = 2
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(pix),
                 decoder_input_ids=torch.from_numpy(dec_in)).logits
        out = model(torch.from_numpy(pix.transpose(0, 2, 3, 1)),
                    torch.from_numpy(dec_in))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


# ---- data and scoring ---------------------------------------------------

def test_cer_wer_match_jax():
    from unilm_tpu import scoring as js
    from unilm_tpu_torch import scoring as ts

    rng = np.random.RandomState(3)
    chars = list("ab c")
    refs = ["".join(rng.choice(chars, rng.randint(0, 12))) for _ in range(20)]
    hyps = ["".join(rng.choice(chars, rng.randint(0, 12))) for _ in range(20)]
    assert ts.cer(refs, hyps) == js.cer(refs, hyps)
    assert ts.wer(refs, hyps) == js.wer(refs, hyps)
    assert ts.cer(["abc"], ["abc"]) == 0.0 and ts.wer([""], [""]) == 0.0


def test_ocr_batches_match_jax():
    from unilm_tpu.data import trocr_datasets as jd
    from unilm_tpu_torch.data import trocr_datasets as td

    for a, b in zip(td.synthetic_ocr_dataset(5, 32, seed=2),
                    jd.synthetic_ocr_dataset(5, 32, seed=2)):
        assert a.text == b.text and np.array_equal(a.image, b.image)
    data = td.synthetic_ocr_dataset(5, 32, seed=2)
    tok, jtok = td.CharTokenizer(), jd.CharTokenizer()
    got = list(td.ocr_batches(data, tok, 2, max_len=6, shuffle=True, seed=1))
    want = list(jd.ocr_batches(data, jtok, 2, max_len=6, shuffle=True,
                               seed=1))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g["labels"], w["labels"])
        assert g["texts"] == w["texts"]
    assert tok.decode(tok.encode("Ab 9")) == "ab 9"
    # the spm target side: the same labels as JAX's through data/spm.py
    model = os.path.join(os.path.dirname(__file__), "fixtures",
                         "tiny_digits.model")
    stok, jstok = td.spm_tokenizer(model), jd.spm_tokenizer(model)
    assert (stok.bos, stok.eos, stok.pad, stok.vocab_size) == (
        jstok.bos, jstok.eos, jstok.pad, jstok.vocab_size)
    got = list(td.ocr_batches(data, stok, 2, max_len=6))
    want = list(jd.ocr_batches(data, jstok, 2, max_len=6))
    for g, w in zip(got, want):
        assert np.array_equal(g["labels"], w["labels"])


# ---- the CLIs -------------------------------------------------------------

_EVAL = """
import json, sys
for name in ("jax", "jaxlib", "flax", "optax", "unilm_tpu"):
    sys.modules[name] = None
import torch
from unilm_tpu_torch.cli import trocr_eval
torch.set_num_threads(1)
seen = {}
real = trocr_eval.cer
def cer(refs, hyps):
    seen["hyps"] = hyps
    return real(refs, hyps)
trocr_eval.cer = cer
result = trocr_eval.main(sys.argv[1:])
print(json.dumps({"hyps": seen["hyps"], **result}))
"""


def _tiny_checkpoint(path):
    """An HF VisionEncoderDecoder state dict at trocr_eval --tiny's widths
    (DeiT and decoder 32 wide x 1 layer, FFN 64, 64x64 pixels, 16 patches,
    CharTokenizer's 40 ids, 512 positions), seeded, saved as {"model": sd}.
    The head's rows of bos, eos and pad are zero, so that the lines run
    on to their budget; a wide patch projection and sharp cross-attention
    scores make the synthetic lines' hypotheses differ."""
    g = torch.Generator().manual_seed(1)
    E, F, V, N = 32, 64, 40, 16

    def r(*shape, s=0.3):
        return torch.randn(*shape, generator=g) * s

    sd, enc, dec = {}, "encoder.", "decoder.model.decoder."
    sd[enc + "embeddings.cls_token"] = r(1, 1, E)
    sd[enc + "embeddings.distillation_token"] = r(1, 1, E)
    sd[enc + "embeddings.position_embeddings"] = r(1, N + 2, E)
    sd[enc + "embeddings.patch_embeddings.projection.weight"] = r(
        E, 3, 16, 16, s=1.0)
    sd[enc + "embeddings.patch_embeddings.projection.bias"] = r(E)

    def lin(name, o, i, gain=1.0):
        sd[name + ".weight"] = r(o, i, s=gain * i ** -0.5)
        sd[name + ".bias"] = r(o)

    def ln(name):
        sd[name + ".weight"], sd[name + ".bias"] = 1.0 + r(E), r(E)

    p = enc + "encoder.layer.0."
    for n in ("query", "key", "value"):
        lin(p + "attention.attention." + n, E, E)
    lin(p + "attention.output.dense", E, E)
    lin(p + "intermediate.dense", F, E)
    lin(p + "output.dense", E, F)
    ln(p + "layernorm_before")
    ln(p + "layernorm_after")
    ln(enc + "layernorm")
    sd[dec + "embed_tokens.weight"] = r(V, E, s=1.0)
    sd[dec + "embed_positions.weight"] = r(514, E)
    ln(dec + "layernorm_embedding")
    p = dec + "layers.0."
    for block in ("self_attn", "encoder_attn"):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sharp = block == "encoder_attn" and n in ("q_proj", "k_proj")
            lin(p + block + "." + n, E, E, 8.0 if sharp else 1.0)
        ln(p + block + "_layer_norm")
    lin(p + "fc1", F, E)
    lin(p + "fc2", E, F)
    ln(p + "final_layer_norm")
    head = r(V, E, s=1.0)
    head[:3] = 0.0
    sd["decoder.output_projection.weight"] = head
    torch.save({"model": sd}, path)


def test_trocr_eval_cli_matches_jax_without_jax(tmp_path):
    """trocr_eval --synthetic --tiny --device cpu on one checkpoint, in a
    subprocess where jax and unilm_tpu cannot be imported: the same
    hypotheses and summary as the JAX CLI's."""
    from unilm_tpu.cli import trocr_eval as jcli

    ckpt = tmp_path / "tiny.pt"
    _tiny_checkpoint(ckpt)
    argv = ["--synthetic", "--tiny", "--checkpoint", str(ckpt),
            "--max-new-tokens", "6", "--beam", "3"]
    seen = {}
    real = jcli.cer

    def cer(refs, hyps):
        seen["hyps"] = hyps
        return real(refs, hyps)

    jcli.cer = cer
    try:
        want = jcli.main(argv)
    finally:
        jcli.cer = real
    res = subprocess.run([sys.executable, "-c", _EVAL, *argv, "--device",
                          "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["hyps"] == seen["hyps"]
    assert len(set(got["hyps"])) > 1
    assert {k: got[k] for k in want} == want


def test_trocr_infer_pipeline(tmp_path):
    """cli/trocr_infer.py's pipeline on the CPU: infer_images gives the
    best beam of generate() from a preprocessed array, an image path gives
    the same, and the default device raises without a card."""
    from PIL import Image

    from unilm_tpu_torch.cli import trocr_infer

    _tiny_checkpoint(tmp_path / "tiny.pt")
    args = trocr_infer.build_parser().parse_args(
        ["--image", "unused", "--checkpoint", str(tmp_path / "tiny.pt"),
         "--arch", "trocr_small", "--beam", "3", "--max_new_tokens", "5",
         "--device", "cpu"])
    tiny = dict(img_size=64, enc_dim=32, enc_layers=1, enc_heads=2,
                enc_ffn=64, dec_dim=32, dec_layers=1, dec_heads=2,
                dec_ffn=64, vocab_size=40, use_flash=False)
    orig = tt.trocr_small
    tt.trocr_small = lambda **kw: orig(**{**kw, **tiny})
    try:
        pipe = trocr_infer.build_pipeline(args)
        args.int8 = True
        pipe8 = trocr_infer.build_pipeline(args)
    finally:
        tt.trocr_small = orig
    img = (np.random.RandomState(0).rand(40, 90, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "line.png")
    arr = trocr_infer.preprocess(str(tmp_path / "line.png"), 64)
    assert arr.shape == (64, 64, 3) and -1.0 <= arr.min() <= arr.max() <= 1.0
    (score, ids), = pipe.infer_images(arr[None])
    toks, scores = pipe.generate(arr)
    assert toks.shape == (1, 3, 6) and score == float(scores[0, 0])
    assert ids == [t for t in toks[0, 0, 1:].tolist() if t not in (1, 2)]
    assert pipe(str(tmp_path / "line.png")) == (score, ids)
    assert isinstance(pipe8.model.text_decoder.output_projection,
                      tt.QuantDense)
    assert len(pipe8.infer_images(arr[None])[0][1]) <= 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            trocr_infer.build_pipeline(trocr_infer.build_parser().parse_args(
                ["--image", "unused"]))


# ---- dispatch on a stand-in CUDA tensor ---------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_folded_cross_attention_takes_encoder_kernel(monkeypatch):
    """On the card, a beam step's cross-attention (5 beams x 1 token of 2
    sentences over 6 shared keys, no mask) reaches #3's wrapper as one
    [2, 5, H, D] call over the contiguous layer slice; a greedy step as
    [B, 1, H, D]."""
    from unilm_tpu_torch.core.transformer import ScanCrossAttention
    from unilm_tpu_torch.ops import flash_attention as tfa

    seen = []

    def rec(q, k, v, bias=None, scale=None):
        seen.append((tuple(q.shape), tuple(k.shape), k.is_contiguous(),
                     bias))
        return q

    monkeypatch.setattr(tfa, "fused_encoder_attention", rec)
    monkeypatch.setattr(tfa, "flash_attention", None)
    cfg = tt.TrOCRConfig(**{**KW, "use_flash": True}).decoder_cfg()
    mod = ScanCrossAttention(cfg, kv_dim=32, device="cpu").eval()
    L, S, H, D = 2, 6, cfg.num_heads, cfg.head_dim
    cross = tuple(torch.zeros(L, 2, S, H, D).transpose(0, 1)
                  for _ in range(2))
    for rows in (10, 2):
        x = torch.randn(rows, 1, cfg.embed_dim).as_subclass(_FakeCuda)
        with torch.no_grad():
            out = mod(x, None, cross, 1, mode="decode")
        assert out.shape == (rows, 1, cfg.embed_dim)
    assert seen == [((2, 5, H, D), (2, S, H, D), True, None),
                    ((2, 1, H, D), (2, S, H, D), True, None)]
