"""Port parity for the speech models against unilm_tpu on the CPU:
models/wavlm.py with convert/wavlm.py (also against `transformers`'
random-weight WavLMModel, as tests/test_wavlm.py does), models/beats.py
(the classifier, the tokenizer's ids and its EMA buffers),
models/speecht5.py (asr_forward, tts_forward), models/speechlm.py (the
pre-training forward, loss and gradients) and the Kosmos audio tower in
models/kosmos.py.

Sizes: 2 layers at width 32 with 4 heads; conv front ends of two or three
16-channel layers over 400-800 samples; BEATs at 8 px patches over a
36 x 16 spectrogram. Parameters come from `jax.eval_shape` of the flax
init plus a seeded numpy draw (WavLM's from HF's seeded init through the
converters), loaded into both packages; inputs from numpy seeds. Float32
on both sides, JAX at matmul precision 'highest' and under jax.jit.
Tolerances: features and logits 1e-4 relative + 1e-4 absolute (HF, whose
attention differs in order, at JAX's own 5e-4 / 1e-3); the SpeechLM loss
and gradients against jax.grad 1e-4; the BEATs ids equal, the EMA
buffers 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from unilm_tpu.convert import wavlm as jcw
from unilm_tpu.models import beats as jb
from unilm_tpu.models import kosmos as jk
from unilm_tpu.models import speechlm as jsl
from unilm_tpu.models import speecht5 as jst
from unilm_tpu.models import wavlm as jw
from unilm_tpu_torch.convert import wavlm as tcw
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.models import beats as tb
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.models import speechlm as tsl
from unilm_tpu_torch.models import speecht5 as tst
from unilm_tpu_torch.models import wavlm as tw

from test_torch_seq2seq import close, draw_params, t

torch.set_num_threads(1)

CONV = dict(conv_dim=(16, 16), conv_stride=(5, 2), conv_kernel=(10, 3))
WKW = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_dim=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
           num_buckets=8, max_bucket_distance=20, **CONV)


def _audio(seed, B=2, n=400):
    return np.random.RandomState(seed).randn(B, n).astype(np.float32)


# ---- WavLM -----------------------------------------------------------------

def _hf_wavlm():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WavLMConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, num_buckets=8,
        max_bucket_distance=20, do_stable_layer_norm=False,
        hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
        activation_dropout=0.0, layerdrop=0.0, **CONV)
    torch.manual_seed(0)
    return transformers.WavLMModel(hf_cfg).eval()


def test_wavlm_converter_matches_jax_and_hf():
    """The HF state dict through the port's converter equals JAX's tree
    leaf for leaf (the weight-norm fold included); the port's model on it
    matches JAX's and HF's outputs."""
    hf = _hf_wavlm()
    cfg = tw.WavLMConfig(**WKW)
    tree = tcw.convert_wavlm(hf.state_dict(), cfg)
    jtree = jcw.convert_wavlm(hf.state_dict(), jw.WavLMConfig(**WKW))
    flat = lambda tr: dict(jax.tree_util.tree_leaves_with_path(tr))
    ft, fj = flat(tree), flat(jtree)
    assert ft.keys() == fj.keys()
    for k in ft:
        np.testing.assert_array_equal(ft[k], fj[k])
    m = tw.WavLMModel(cfg, device="cpu")
    load_flax_params(m, tree)
    audio = _audio(0)
    with torch.no_grad():
        got = m(t(audio))
        ref = hf(t(audio)).last_hidden_state
    want = jax.jit(lambda p: jw.WavLMModel(jw.WavLMConfig(**WKW)).apply(
        {"params": p}, audio))(jtree)
    close(got, want)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-4,
                               rtol=1e-3)


def test_wavlm_matches_jax_on_drawn_params():
    """Every leaf off its init value (the gate constants and the bucket
    table included), at an even positional kernel."""
    kw = dict(WKW, num_conv_pos_embeddings=8)
    jm = jw.WavLMModel(jw.WavLMConfig(**kw))
    audio = _audio(1, n=520)
    params = draw_params(jm, audio)
    want = jax.jit(lambda p: jm.apply({"params": p}, audio))(params)
    m = tw.WavLMModel(tw.WavLMConfig(**kw), device="cpu")
    load_flax_params(m, params)
    with torch.no_grad():
        got = m(t(audio))
    assert got.shape == want.shape == (2, 51, 32)
    close(got, want)


# ---- BEATs -----------------------------------------------------------------

BKW = dict(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64,
           patch_size=8, mel_bins=16, num_classes=10, codebook_size=32,
           codebook_dim=8, use_flash=False)


def _spec(seed, B=2):
    return np.random.RandomState(seed).randn(B, 36, 16).astype(np.float32)


def test_beats_classifier_matches_jax():
    """36 frames: the VALID patchify drops the last 4 (8 patches)."""
    jm = jb.BEATsForAudioClassification(jb.BEATsConfig(**BKW))
    spec = _spec(0)
    params = draw_params(jm, spec)
    want = jax.jit(lambda p: jm.apply({"params": p}, spec))(params)
    tm = tb.BEATsForAudioClassification(tb.BEATsConfig(**BKW), device="cpu")
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(t(spec))
    assert got.shape == (2, 10)
    close(got, want)


def test_beats_tokenizer_ids_and_ema_match_jax():
    jm = jb.BEATsTokenizer(jb.BEATsConfig(**BKW))
    spec = _spec(1)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), spec))
    params = draw_params(jm, spec)
    rng = np.random.RandomState(3)
    emb = rng.randn(*shapes["ema"]["quantize"]["embedding"].shape)
    ema = {"quantize": {
        "embedding": (emb / np.linalg.norm(emb, axis=-1, keepdims=True)
                      ).astype(np.float32),
        "cluster_size": np.abs(rng.randn(32)).astype(np.float32)}}
    (jq, jloss, jids), jv = jax.jit(lambda p, e: jm.apply(
        {"params": p, "ema": e}, spec, update_ema=True, mutable=["ema"]))(
        params, ema)
    tm = tb.BEATsTokenizer(tb.BEATsConfig(**BKW), device="cpu")
    load_flax_params(tm, params, ema=ema)
    with torch.no_grad():
        ids = tm.get_codebook_indices(t(spec))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        q, loss, ids2 = tm(t(spec), update_ema=True)
    np.testing.assert_array_equal(ids2.numpy(), np.asarray(jids))
    close(q, jq)
    close(loss, jloss)
    for name in ("embedding", "cluster_size"):
        close(getattr(tm.quantize, name), jv["ema"]["quantize"][name], 1e-5)


# ---- SpeechT5 and SpeechLM -------------------------------------------------

SKW = dict(vocab_size=40, hidden_size=32, enc_layers=2, dec_layers=2,
           num_heads=4, ffn_dim=64, mel_bins=8, max_positions=32,
           use_flash=False, **CONV)


def _speecht5():
    jm = jst.SpeechT5Model(jst.SpeechT5Config(**SKW))
    audio = _audio(2)
    prev = np.random.RandomState(4).randint(3, 40, (2, 6)).astype(np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), audio,
                                            prev))
    tts_shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), prev, np.zeros((2, 5, 16), np.float32),
        method=jm.tts_forward))
    rng = np.random.RandomState(5)
    merged = {**tts_shapes["params"], **shapes["params"]}

    def leaf(path, s):
        x = 0.1 * rng.randn(*s.shape)
        if getattr(path[-1], "key", None) == "scale":
            x = x + 1.0
        return x.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, merged)
    tm = tst.SpeechT5Model(tst.SpeechT5Config(**SKW), device="cpu").eval()
    load_flax_params(tm, params)
    return jm, params, tm, audio, prev


def test_speecht5_asr_and_tts_match_jax():
    jm, params, tm, audio, prev = _speecht5()
    want = jax.jit(lambda p: jm.apply({"params": p}, audio, prev))(params)
    mels = np.random.RandomState(6).randn(2, 5, 16).astype(np.float32)
    jtts = jax.jit(lambda p: jm.apply({"params": p}, prev, mels,
                                      method=jm.tts_forward))(params)
    with torch.no_grad():
        got = tm.asr_forward(t(audio), t(prev).long())
        tts = tm.tts_forward(t(prev).long(), t(mels))
        enc = tm.encode_speech(t(audio))
    close(got, want)
    assert [x.shape for x in tts] == [(2, 10, 8), (2, 10, 8), (2, 10)]
    for a, b in zip(tts, jtts):
        close(a, b)
    close(enc, jax.jit(lambda p: jm.apply({"params": p}, audio,
                                          method=jm.encode_speech))(params))


LKW = dict(hidden_size=32, num_layers=2, num_heads=4, ffn_dim=64,
           conv_dim=(16, 16, 16), unit_vocab=20, text_vocab=30,
           max_text_positions=16, use_flash=False)


def test_speechlm_pretrain_step_matches_jax_grad():
    """The masked-unit + masked-LM loss and its gradients through the
    static-shape mask swap, the shared encoder and both heads."""
    rng = np.random.RandomState(7)
    audio = _audio(8, n=800)
    jm = jsl.SpeechLM(jsl.SpeechLMConfig(**LKW))
    text = rng.randint(0, 30, (2, 9)).astype(np.int32)
    T = ((800 - 10) // 5 + 1 - 3) // 2 + 1  # frames after the 3 convs
    T = (T - 3) // 2 + 1
    mask = rng.rand(2, T) < 0.4
    units = rng.randint(0, 20, (2, T)).astype(np.int32)
    ttarget = np.where(rng.rand(2, 9) < 0.3,
                       rng.randint(0, 30, (2, 9)), -100).astype(np.int32)
    params = draw_params(jm, audio, mask, text)

    def jloss(p):
        u, x = jm.apply({"params": p}, audio, mask, text)
        return jsl.speechlm_pretrain_loss(u, units, mask, x, ttarget, 0.5)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = tsl.SpeechLM(tsl.SpeechLMConfig(**LKW), device="cpu")
    load_flax_params(tm, params)
    u, x = tm(t(audio), t(mask), t(text).long())
    assert u.shape == (2, T, 20)
    tl, parts = tsl.speechlm_pretrain_loss(u, t(units).long(), t(mask), x,
                                           t(ttarget).long(), 0.5)
    tl.backward()
    close(tl, jl)
    close(parts["unit_loss"], jparts["unit_loss"])
    grads = dict(tm.named_parameters())
    close(grads["mask_emb"].grad, jg["mask_emb"])
    close(grads["feature_extractor.conv_0.weight"].grad,
          np.asarray(jg["feature_extractor"]["conv_0"]["kernel"]).transpose(
              2, 1, 0))
    close(grads["encoder.layers.1.self_attn.v_proj.weight"].grad,
          np.asarray(jg["encoder"]["layers_1"]["self_attn"]["v_proj"][
              "kernel"]).T)
    close(grads["text_head.weight"].grad,
          np.asarray(jg["text_head"]["kernel"]).T)


# ---- the Kosmos audio tower ------------------------------------------------

KKW = dict(vocab_size=200, embed_dim=64, num_layers=2, num_heads=4,
           ffn_dim=128, max_positions=64, audio_tower="wavlm",
           audio_latent_query_num=5, use_flash=False)


def test_kosmos_audio_tower_matches_jax():
    """encode_audio, the train forward with raw audio spliced at the
    mask, and a prefill from the encoded features against JAX."""
    rng = np.random.RandomState(9)
    audio = _audio(10)
    tok = rng.randint(3, 200, (2, 10)).astype(np.int32)
    amask = np.zeros((2, 10), bool)
    amask[:, 2:7] = True
    jm = jk.UniGPT(jk.UniGPTConfig(**KKW, wavlm=jw.WavLMConfig(**WKW)))
    params = draw_params(jm, tok, aud_inputs=audio, aud_gpt_input_mask=amask)
    tm = tk.UniGPT(tk.UniGPTConfig(**KKW, wavlm=tw.WavLMConfig(**WKW))).eval()
    load_flax_params(tm, params)
    jfeat = jax.jit(lambda p: jm.apply({"params": p}, audio,
                                       method=jm.encode_audio))(params)
    want = jax.jit(lambda p: jm.apply({"params": p}, tok, aud_inputs=audio,
                                      aud_gpt_input_mask=amask))(params)
    jpre, _ = jax.jit(lambda p, f: jm.apply(
        {"params": p}, tok, 16, aud_features=f, aud_gpt_input_mask=amask,
        method=jm.prefill, mutable=["cache"]))(params, jfeat)
    with torch.no_grad():
        feat = tm.encode_audio(t(audio))
        got = tm(t(tok).long(), aud_inputs=t(audio),
                 aud_gpt_input_mask=t(amask))
        pre, cache = tm.prefill(t(tok).long(), 16, aud_features=feat,
                                aud_gpt_input_mask=t(amask))
    assert feat.shape == (2, 5, 64)
    close(feat, jfeat)
    close(got, want)
    close(pre, jpre)
    assert cache["step_counter"]["pos"] == 10
