"""Port parity for the core's T5 relative buckets (core/positional.py
`RelativePositionBias`, the Encoder's and the Decoder's use of it),
models/retrieval.py (E5 / SimLM), models/unilm_s2s.py, models/
translation.py (XLM-T) and models/deltalm.py against unilm_tpu on the
CPU.

Sizes: 2 layers (DeltaLM: a 4-layer encoder under a 2-layer decoder),
width 32, 4 heads, vocab 40-64. Parameters come from `jax.eval_shape` of
the flax init plus a seeded numpy draw (so every leaf matters: norms near
1, everything else N(0, 0.1^2); no init compile), loaded into both
packages; the port gets them through convert/from_jax.py. Inputs come
from numpy seeds. Both sides run in float32 on their plain paths, JAX at
matmul precision 'highest' (tests/conftest.py) and under jax.jit.
Tolerances: logits, embeddings and features 1e-4 relative + 1e-4
absolute; greedy and beam token streams identical, beam scores 1e-4; the
InfoNCE and label-smoothed losses and their gradients against jax.grad
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.core import config as jconfig
from unilm_tpu.core import positional as jpos
from unilm_tpu.core import transformer as jtr
from unilm_tpu.models import deltalm as jdl
from unilm_tpu.models import retrieval as jret
from unilm_tpu.models import translation as jxt
from unilm_tpu.models import unilm_s2s as jul
from unilm_tpu.runtime import criterions as jcrit
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.core import config as tconfig
from unilm_tpu_torch.core import positional as tpos
from unilm_tpu_torch.core import transformer as ttr
from unilm_tpu_torch.models import deltalm as tdl
from unilm_tpu_torch.models import retrieval as tret
from unilm_tpu_torch.models import translation as txt
from unilm_tpu_torch.models import unilm_s2s as tul
from unilm_tpu_torch.runtime import criterions as tcrit
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

TOL = 1e-4


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def draw_params(module, *args, seed=0, method=None, **kw):
    """A flax tree of the module's shapes (jax.eval_shape, no compile)
    filled from a numpy seed: `scale` leaves 1 + N(0, 0.1^2), others
    N(0, 0.1^2); every collection other than params as eval_shape's
    zeros."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method, **kw))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        x = 0.1 * rng.randn(*s.shape)
        if getattr(path[-1], "key", None) == "scale":
            x = x + 1.0
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def ids(rng, *shape, lo=3, hi=40):
    return rng.randint(lo, hi, shape).astype(np.int32)


def t(x):
    return torch.from_numpy(np.array(x))


# ---- T5 relative buckets in the core ---------------------------------------

@pytest.mark.parametrize("bidirectional,step", [(True, 0), (False, 0),
                                                (False, 5)])
def test_relative_position_bias_matches_jax(bidirectional, step):
    jm = jpos.RelativePositionBias(num_buckets=16, max_distance=40,
                                   num_heads=3, bidirectional=bidirectional)
    params = draw_params(jm, 7, 60)
    want = jm.apply({"params": params}, 7, 60, step=step)
    tm = tpos.RelativePositionBias(16, 40, 3, bidirectional)
    load_flax_params(tm, params)
    got = tm(7, 60, step)
    assert got.shape == (1, 3, 7, 60)
    close(got, want, 0)


TKW = dict(embed_dim=32, ffn_dim=64, num_layers=2, num_heads=4,
           rel_pos_buckets=16, max_rel_pos=40, use_flash=False)


def test_encoder_t5_buckets_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 32).astype(np.float32)
    for pre in (True, False):
        je = jtr.Encoder(jconfig.TransformerConfig(
            **TKW, normalize_before=pre))
        params = draw_params(je, jnp.asarray(x))
        want = jax.jit(lambda p, x: je.apply({"params": p}, x))(params, x)
        te = ttr.Encoder(tconfig.TransformerConfig(**TKW,
                                                   normalize_before=pre))
        load_flax_params(te, params)
        with torch.no_grad():
            close(te(t(x)), want)


def test_decoder_t5_buckets_train_prefill_decode_match_jax():
    """Train mode adds the unidirectional rows to the caller's bias;
    prefill takes rows 0..P-1 against cache_size keys and decode the row
    of `step`, which the cache counts across calls."""
    rng = np.random.RandomState(1)
    T, P, C = 8, 5, 12
    x = rng.randn(2, T, 32).astype(np.float32)
    extra = (0.3 * rng.randn(1, 4, T, T)).astype(np.float32)
    cfg = dict(TKW, normalize_before=True)
    jd = jtr.Decoder(jconfig.TransformerConfig(**cfg))
    params = draw_params(jd, jnp.asarray(x))
    td = ttr.Decoder(tconfig.TransformerConfig(**cfg))
    load_flax_params(td, params)
    want = jax.jit(lambda p, x, b: jd.apply({"params": p}, x, attn_bias=b))(
        params, x, extra)
    with torch.no_grad():
        close(td(t(x), attn_bias=t(extra)), want)

    @jax.jit
    def jprefill(p, x):
        return jd.apply({"params": p}, x, mode="prefill", cache_size=C,
                        mutable=["cache"])

    @jax.jit
    def jdecode(p, c, x):
        return jd.apply({"params": p, "cache": c}, x, mode="decode",
                        cache_size=C, mutable=["cache"])

    jy, jv = jprefill(params, x[:, :P])
    with torch.no_grad():
        ty, cache = td(t(x[:, :P]), mode="prefill", cache_size=C)
    close(ty, jy)
    assert cache["step"] == P
    for i in range(P, T):
        jy, jv = jdecode(params, jv["cache"], x[:, i:i + 1])
        with torch.no_grad():
            ty, cache = td(t(x[:, i:i + 1]), mode="decode", cache_size=C,
                           cache=cache)
        close(ty, jy)
    assert cache["step"] == T == int(jv["cache"]["step"])


# ---- E5 / SimLM ------------------------------------------------------------

RKW = dict(vocab_size=40, hidden_size=32, num_layers=2, num_heads=4,
           ffn_dim=64, max_positions=16, use_flash=False)


def _retrieval_inputs(seed, B=3, L=7):
    rng = np.random.RandomState(seed)
    tok = ids(rng, B, L)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    mask[-1, 2:] = 0
    return tok, mask


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_embedding_model_matches_jax(pooling):
    tok, mask = _retrieval_inputs(2)
    jm = jret.EmbeddingModel(jret.TextEncoderConfig(**RKW, pooling=pooling))
    params = draw_params(jm, tok, mask)
    want = jax.jit(lambda p, a, m: jm.apply({"params": p}, a, m))(
        params, tok, mask)
    tm = tret.EmbeddingModel(tret.TextEncoderConfig(**RKW, pooling=pooling),
                             device="cpu").eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(t(tok).long(), t(mask))
    close(got, want)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_info_nce_step_matches_jax_grad():
    """One InfoNCE step's loss, accuracy and parameter gradients: queries
    and passages through the same bi-encoder, one hard negative each."""
    q, qm = _retrieval_inputs(3, B=2)
    p, pm = _retrieval_inputs(4, B=4)
    cfg = dict(RKW)
    jm = jret.EmbeddingModel(jret.TextEncoderConfig(**cfg))
    params = draw_params(jm, q, qm)

    def jloss(pr):
        qe = jm.apply({"params": pr}, q, qm)
        pe = jm.apply({"params": pr}, p, pm)
        return jret.info_nce_loss(qe, pe, 0.05, negatives_per_query=1)

    (jl, jacc), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = tret.EmbeddingModel(tret.TextEncoderConfig(**cfg),
                             device="cpu").eval()
    load_flax_params(tm, params)
    tl, tacc = tret.info_nce_loss(tm(t(q).long(), t(qm)),
                                  tm(t(p).long(), t(pm)), 0.05,
                                  negatives_per_query=1)
    tl.backward()
    close(tl.detach(), jl)
    assert float(tacc) == float(jacc)
    grads = dict(tm.named_parameters())
    jgf = jg["encoder"]
    close(grads["encoder.word_embeddings.weight"].grad,
          jgf["word_embeddings"]["embedding"])
    close(grads["encoder.encoder.layers.1.ffn.fc1.weight"].grad,
          np.asarray(jgf["encoder"]["layers_1"]["ffn"]["fc1"]["kernel"]).T)
    close(grads["encoder.encoder.layers.0.self_attn.q_proj.weight"].grad,
          np.asarray(
              jgf["encoder"]["layers_0"]["self_attn"]["q_proj"]["kernel"]).T)


def test_cross_encoder_reranker_matches_jax():
    tok, mask = _retrieval_inputs(5)
    types = (np.arange(7)[None] >= 3).astype(np.int32).repeat(3, 0)
    jm = jret.CrossEncoderReranker(jret.TextEncoderConfig(**RKW))
    params = draw_params(jm, tok, mask, types)
    want = jax.jit(lambda p: jm.apply({"params": p}, tok, mask, types))(
        params)
    tm = tret.CrossEncoderReranker(tret.TextEncoderConfig(**RKW),
                                   device="cpu").eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(t(tok).long(), t(mask), t(types).long())
    assert got.shape == (3,)
    close(got, want)


# ---- UniLM seq2seq ---------------------------------------------------------

UKW = dict(vocab_size=48, hidden_size=32, num_layers=2, num_heads=4,
           ffn_dim=64, max_positions=24, use_flash=False)


def _unilm():
    jm = jul.UniLMForSeq2Seq(jul.UniLMConfig(**UKW))
    tok = np.zeros((2, 9), np.int32)
    params = draw_params(jm, tok, tok, 5)
    tm = tul.UniLMForSeq2Seq(tul.UniLMConfig(**UKW), device="cpu").eval()
    load_flax_params(tm, params)
    return jm, params, tm


def test_seq2seq_attn_bias_matches_jax():
    close(tul.seq2seq_attn_bias(5, 4), jul.seq2seq_attn_bias(5, 4), 0)


def test_unilm_train_forward_matches_jax():
    jm, params, tm = _unilm()
    rng = np.random.RandomState(6)
    tok = ids(rng, 2, 9, hi=48)
    types = np.where(np.arange(9) < 5, 4, 5)[None].repeat(2, 0).astype(
        np.int32)
    want = jax.jit(lambda p: jm.apply({"params": p}, tok, types, 5))(params)
    with torch.no_grad():
        got = tm(t(tok).long(), t(types).long(), 5)
    assert got.dtype == torch.float32
    close(got, want)


def test_unilm_prefill_decode_match_jax():
    """A non-causal prefill over 5 source tokens, then 4 causal steps."""
    jm, params, tm = _unilm()
    rng = np.random.RandomState(7)
    src, tgt = ids(rng, 2, 5, hi=48), ids(rng, 2, 4, hi=48)
    C = 12
    jl, jv = jax.jit(lambda p: jm.apply(
        {"params": p}, src, np.full_like(src, 4), C, method=jm.prefill,
        mutable=["cache"]))(params)
    tl, cache = tm.prefill(t(src).long(), torch.full((2, 5), 4), C)
    close(tl, jl)
    jdec = jax.jit(lambda p, c, x, pos: jm.apply(
        {"params": p, "cache": c}, x, jnp.full_like(x, 5), pos, C,
        method=jm.decode_step, mutable=["cache"]))
    for i in range(4):
        x = tgt[:, i:i + 1]
        jl, jv = jdec(params, jv["cache"], x, np.array([5 + i]))
        tl, cache = tm.decode_step(t(x).long(), torch.full((2, 1), 5),
                                   torch.tensor([5 + i]), cache, C)
        close(tl, jl)
    assert cache["decoder"]["cache_index"] == 9


# ---- XLM-T and DeltaLM -----------------------------------------------------

V = 40
XKW = dict(vocab_size=V, embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64,
           max_positions=32, dropout=0.0)
DKW = dict(vocab_size=V, embed_dim=32, enc_layers=4, dec_layers=2,
           num_heads=4, ffn_dim=64, max_positions=32, dropout=0.0)


def _src_tgt(seed, B=2, S=7, T=5):
    rng = np.random.RandomState(seed)
    src = ids(rng, B, S, hi=V)
    src[1, 5:] = 1  # padding
    return src, ids(rng, B, T, hi=V)


def _nmt(kind):
    src, tgt = _src_tgt(0)
    if kind == "xlmt":
        jm = jxt.MultilingualTranslationModel(jxt.TranslationConfig(**XKW))
        tm = txt.MultilingualTranslationModel(txt.TranslationConfig(**XKW),
                                              device="cpu")
    else:
        jm = jdl.DeltaLM(jdl.DeltaLMConfig(**DKW))
        tm = tdl.DeltaLM(tdl.DeltaLMConfig(**DKW), device="cpu")
    params = draw_params(jm, src, tgt)
    load_flax_params(tm, params)
    return jm, params, tm.eval()


@pytest.mark.parametrize("kind", ["xlmt", "deltalm"])
def test_nmt_train_forward_matches_jax(kind):
    jm, params, tm = _nmt(kind)
    src, tgt = _src_tgt(8)
    want = jax.jit(lambda p: jm.apply({"params": p}, src, tgt))(params)
    with torch.no_grad():
        got = tm(t(src).long(), t(tgt).long())
    close(got, want)


@pytest.mark.parametrize("kind", ["xlmt", "deltalm"])
def test_nmt_label_smoothed_step_matches_jax_grad(kind):
    """The label-smoothed loss (eps 0.1, pad ignored) and its gradients."""
    jm, params, tm = _nmt(kind)
    src, tgt = _src_tgt(9, T=6)
    prev, gold = tgt[:, :-1], tgt[:, 1:].copy()
    gold[0, -1] = 1

    def jloss(p):
        s, n = jcrit.label_smoothed_nll_loss(
            jm.apply({"params": p}, src, prev), gold, 0.1, ignore_index=1)
        return s / n

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    s, n = tcrit.label_smoothed_nll_loss(tm(t(src).long(), t(prev).long()),
                                         t(gold).long(), 0.1, ignore_index=1)
    (s / n).backward()
    close((s / n).detach(), jl)
    grads = dict(tm.named_parameters())
    close(grads["embed.embed.weight"].grad, jg["embed"]["embed"]["embedding"])
    close(grads["decoder.layers.1.encoder_attn.k_proj.weight"].grad,
          np.asarray(jg["decoder"]["layers_1"]["encoder_attn"]["k_proj"][
              "kernel"]).T)
    close(grads["encoder.layers.0.ffn.fc2.weight"].grad,
          np.asarray(jg["encoder"]["layers_0"]["ffn"]["fc2"]["kernel"]).T)


def _fns(kind, jm, tm, C):
    jmod = jxt if kind == "xlmt" else jdl
    jfns = tuple(map(jax.jit, jmod.make_generate_fns(jm, C)))
    return jfns, txt.make_generate_fns(tm, C)


@pytest.mark.parametrize("kind", ["xlmt", "deltalm"])
def test_nmt_prefill_decode_match_jax(kind):
    jm, params, tm = _nmt(kind)
    src, tgt = _src_tgt(10)
    C = 8
    (jpre, jstep), (tpre, tstep) = _fns(kind, jm, tm, C)
    jaux = jax.jit(lambda p: jm.apply({"params": p}, src,
                                      method=jm.encode))(params)
    with torch.no_grad():
        taux = tm.encode(t(src).long())
    close(taux[0], jaux[0])
    jl, jc = jpre(params, jnp.asarray(tgt[:, :2]), jaux)
    tl, tc = tpre(t(tgt[:, :2]).long(), taux)
    close(tl, jl)
    for i in range(2, 5):
        jl, jc = jstep(params, jnp.asarray(tgt[:, i:i + 1]), jc, jaux)
        tl, tc = tstep(t(tgt[:, i:i + 1]).long(), tc, taux)
        close(tl, jl)


@pytest.mark.parametrize("kind", ["xlmt", "deltalm"])
def test_nmt_beam_streams_match_jax(kind):
    """Beam 3 over 6 new tokens from the target-language token: the same
    tokens, scores within 1e-4 (eos never drawn: -1)."""
    jm, params, tm = _nmt(kind)
    src, _ = _src_tgt(11)
    prompt = np.full((2, 1), 7, np.int32)
    NEW = 6
    (jpre, jstep), (tpre, tstep) = _fns(kind, jm, tm, 1 + NEW)
    kw = dict(beam_size=3, max_new_tokens=NEW, eos=-1, pad=1, vocab_size=V)
    jaux = jm.apply({"params": params}, src, method=jm.encode)
    jtoks, jscores = jgen.beam_generate(jgen.GenerationConfig(**kw), jpre,
                                        jstep, params, jnp.asarray(prompt),
                                        jaux)
    with torch.no_grad():
        taux = tm.encode(t(src).long())
        ttoks, tscores = tgen.beam_generate(tgen.GenerationConfig(**kw),
                                            tpre, tstep, t(prompt).long(),
                                            taux)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    close(tscores, jscores)


def test_interleave_decoder_init_matches_jax():
    """The DeltaLM init from a 4-layer encoder tree: key by key and leaf
    by leaf the JAX function's tree, and it loads into the port."""
    jm, params, tm = _nmt("deltalm")
    src, _ = _src_tgt(12)
    enc = draw_params(jtr.Encoder(jdl.DeltaLMConfig(**DKW).tcfg(4)),
                      jnp.zeros((1, 3, 32)), seed=5)
    params = jax.device_get(params)
    want = jdl.interleave_decoder_init(params, enc)
    got = tdl.interleave_decoder_init(params, enc)
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                         jax.tree_util.tree_leaves_with_path(tree)}
    fw, fg = flat(want), flat(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    np.testing.assert_array_equal(
        got["decoder"]["layers_1"]["encoder_attn"]["q_proj"]["kernel"],
        enc["layers_3"]["self_attn"]["q_proj"]["kernel"])
    load_flax_params(tm, got)


# ---- the dispatcher's choice of kernel -------------------------------------

# Every attention call shape of the new smoke phases (chip_smoke.py
# `registry_text`, `registry_speech`) that goes through ops/attention.py:
# (B, T, S, H, D, key padding mask, bias shape, causal) -> (the kernel
# the port launches on a bf16 CUDA tensor, the kernel JAX's dispatcher
# picks). The port's rule (ops/attention.py): a non-causal call at
# S <= 2048 takes #9 with a mask, else #3; a causal one the flash forward,
# whose selector takes #5 where `onepass_applies`, else #1. JAX's
# one-pass VMEM budget sends the mid-size unmasked calls to #9 (the same
# function; the port does not carry that TPU budget) and short causal
# calls to XLA. One-token decode steps do not come here (the decode
# kernel #13, core/transformer.py), nor do the kernel-free models.
NEW_CALLS = {
    "e5 eval": ((64, 512, 512, 12, 64, True, None, False), "#9", "#9"),
    "e5 infonce queries": ((32, 64, 64, 12, 64, True, None, False),
                           "#9", "#9"),
    "e5 infonce passages": ((32, 256, 256, 12, 64, True, None, False),
                            "#9", "#9"),
    "unilm train": ((8, 512, 512, 12, 64, False, (1, 1, 512, 512), False),
                    "#3", "#9"),
    "unilm prefill": ((8, 448, 448, 12, 64, False, None, False), "#3", "#9"),
    "beats encoder": ((8, 496, 496, 12, 64, False, (1, 12, 496, 496),
                       False), "#3", "#9"),
    "speecht5 speech encoder": ((8, 499, 499, 12, 64, False, None, False),
                                "#3", "#9"),
    "speecht5 asr cross": ((8, 64, 499, 12, 64, False, None, False),
                           "#3", "#9"),
    "speecht5 asr decoder": ((8, 64, 64, 12, 64, False, None, True),
                             "#5", "xla"),
    "speecht5 text encoder": ((8, 64, 64, 12, 64, False, None, False),
                              "#3", "#3"),
    "speecht5 tts decoder": ((8, 100, 100, 12, 64, False, None, True),
                             "#5", "xla"),
    "speecht5 tts cross": ((8, 100, 64, 12, 64, False, None, False),
                           "#3", "#3"),
    "speechlm speech": ((8, 799, 799, 12, 64, False, None, False),
                        "#3", "#9"),
    "speechlm text": ((8, 128, 128, 12, 64, False, None, False), "#3", "#3"),
    "kosmos audio connector": ((1, 64, 563, 32, 64, False, None, False),
                               "#3", "#9"),
    "kosmos audio prefill": ((1, 128, 128, 32, 64, False, None, True),
                             "#5", "xla"),
}


def _jax_pick(monkeypatch, B, T, S, H, D, masked, bias, causal):
    """unilm_tpu's dispatcher on bf16 inputs, traced abstractly with the
    kernels' entry points replaced by recorders."""
    from unilm_tpu.ops import attention as jatt
    from unilm_tpu.ops import doc_attention as jda
    from unilm_tpu.ops import flash_attention as jfa

    seen = []
    monkeypatch.setenv("UNILM_TPU_FLASH_INTERPRET", "1")
    monkeypatch.delenv("UNILM_TPU_DISABLE_FLASH", raising=False)
    for mod, name, tag in ((jfa, "fused_encoder_attention", "#3"),
                           (jda, "doc_attention", "#9"),
                           (jfa, "flash_attention", "flash")):
        monkeypatch.setattr(mod, name,
                            lambda q, *a, tag=tag, **k: seen.append(tag) or q)
    sds = jax.ShapeDtypeStruct
    q, kv = sds((B, T, H, D), jnp.bfloat16), sds((B, S, H, D), jnp.bfloat16)
    m = sds((B, S), jnp.bool_) if masked else None
    b = None if bias is None else sds(bias, jnp.bfloat16)
    jax.eval_shape(lambda q, k, v, m, b: jatt.attention(
        q, k, v, bias=b, key_padding_mask=m, causal=causal), q, kv, kv, m, b)
    return seen or ["xla"]


class _FakeCuda(torch.Tensor):
    """A tensor that reports itself as a CUDA one, so the dispatcher takes
    its card branches without a card."""

    @property
    def is_cuda(self):
        return True


def _port_pick(monkeypatch, B, T, S, H, D, masked, bias, causal):
    from unilm_tpu_torch.ops import attention as tatt
    from unilm_tpu_torch.ops import doc_attention as tda
    from unilm_tpu_torch.ops import flash_attention as tfa

    seen = []
    for mod, name, tag in ((tfa, "fused_encoder_attention", "#3"),
                           (tda, "doc_attention", "#9"),
                           (tfa, "flash_attention", "flash")):
        monkeypatch.setattr(mod, name,
                            lambda q, *a, tag=tag, **k: seen.append(tag) or q)
    fake = lambda *s, dt=torch.bfloat16: torch.empty(
        *s, dtype=dt, device="meta").as_subclass(_FakeCuda)
    b = None if bias is None else fake(*bias)
    tatt.attention(fake(B, T, H, D), fake(B, S, H, D), fake(B, S, H, D),
                   key_padding_mask=fake(B, S, dt=torch.bool) if masked
                   else None, bias=b, causal=causal)
    if seen == ["flash"]:  # the flash selector's pick (#5 before #1)
        seen = ["#5" if tfa.onepass_applies(B, H, T, S, D, b, 0) else "#1"]
    return seen


@pytest.mark.parametrize("call", sorted(NEW_CALLS))
def test_dispatch_of_new_call_shapes(monkeypatch, call):
    shape, port, jax_pick = NEW_CALLS[call]
    assert _port_pick(monkeypatch, *shape) == [port]
    assert _jax_pick(monkeypatch, *shape) == [
        "flash" if jax_pick in ("#5", "#1") else jax_pick]
