"""Port parity for the Kosmos-2.5 int8 inference path (bench.py line 4's
configuration at small widths) on the CPU: the int8 KV pool with its
scale sidecar, int8 decoder projections, the int8 LM head
(`quantize_lm_head`), and the decoder-only quantization predicate, in
unilm_tpu_torch against unilm_tpu.

Params come from a JAX init and reach the port through the bridge;
prompts and segment ids come from numpy. Tolerances (float32): logits
1e-4, the slice test's class (the same fp32 math in another order); int8
pool entries at most one step apart (a row's K/V differ by ~1e-6 between
the frameworks, so round(x / scale) can only flip at a tie); sidecar
scales 1e-5 relative; the int8 head's logits 1e-5 (one fp32 product).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu.ops import quant as jq
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.core.transformer import _scan_pool_geometry
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.ops import quant as tq
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

KW = dict(vocab_size=251, embed_dim=192, num_layers=2, num_heads=2,
          ffn_dim=384, max_positions=1200, scale_length=16, segment_emb=True,
          use_flash=False, image_tower=None)
B, P = 2, 20
LOGIT_ATOL = 1e-4
SCALE_RTOL = 1e-5
HEAD_ATOL = 1e-5
_PROJ = {"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2", "fc3"}


def _jax_cli_predicate(pth):
    """The JAX CLI's and serving engine's predicate
    (unilm_tpu/cli/kosmos_infer.py:145-148)."""
    return pth[-2] in _PROJ and any(s.startswith("layers") for s in pth)


@functools.lru_cache(maxsize=None)
def _params(tied: bool = True):
    """(stacked fp32 params, prompt, segs) from a JAX init."""
    rng = np.random.RandomState(0)
    prompt = rng.randint(4, KW["vocab_size"], size=(B, P)).astype(np.int32)
    segs = rng.randint(0, 2, size=(B, P)).astype(np.int32)
    cfg = jk.UniGPTConfig(share_input_output_embed=tied, **KW)
    p_loop = jk.UniGPT(cfg).init(jax.random.PRNGKey(1), jnp.asarray(prompt),
                                 segment_tokens=jnp.asarray(segs))["params"]
    params = jax.device_get(jk.stack_unigpt_params(dict(p_loop),
                                                   KW["num_layers"]))
    return params, prompt, segs


def _quantized(params):
    """JAX's int8 tree (projections + head) and the port's, which must be
    bit-equal."""
    want = jax.device_get(jk.quantize_lm_head(jq.quantize_dense_tree(
        params, predicate=_jax_cli_predicate)))
    got = tk.quantize_lm_head(tq.quantize_dense_tree(
        params, predicate=tq.is_decoder_projection))
    return want, got


def _models(cache_int8: bool, weights_int8: bool, tied: bool = True):
    params, prompt, segs = _params(tied)
    flags = dict(scan_layers=True, share_input_output_embed=tied,
                 kv_cache_dtype="int8" if cache_int8 else "model",
                 quant_weights=weights_int8, quant_lm_head=weights_int8)
    jm = jk.UniGPT(jk.UniGPTConfig(**flags, **KW))
    tm = tk.UniGPT(tk.UniGPTConfig(**flags, **KW)).eval()
    jp = params
    if weights_int8:
        jp, tp = _quantized(params)
        load_flax_params(tm, tp)
    else:
        load_flax_params(tm, params)
    return jm, jp, tm, prompt, segs


def _run(jm, jp, tm, prompt, segs, cache, steps=3):
    """Prefill + `steps` teacher-forced decode steps through both; returns
    the two logits lists and the two caches."""
    jpf, jst = jk.make_unigpt_generate_fns(jm, cache)
    tpf, tst = tk.make_unigpt_generate_fns(tm, cache)
    aux_j = (None, None, jnp.asarray(segs))
    aux_t = (None, None, torch.from_numpy(segs).long())
    lj, cj = jpf(jp, jnp.asarray(prompt), aux_j)
    lt, ct = tpf(torch.from_numpy(prompt).long(), aux_t)
    out_j, out_t = [np.asarray(lj)], [lt.float().numpy()]
    tok = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
    for _ in range(steps):
        lj, cj = jst(jp, jnp.asarray(tok), cj, None)
        lt, ct = tst(torch.from_numpy(tok).long(), ct, None)
        out_j.append(np.asarray(lj))
        out_t.append(lt.float().numpy())
        tok = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
    return out_j, out_t, cj, ct


@pytest.mark.parametrize("cache", [24, 1040])
def test_int8_kv_pool_matches_jax(cache):
    """kv_cache_dtype='int8' over a prefill and three decode steps, at the
    short (page 16, chunk 2) and the long (page 64, chunk 8) geometry:
    logits, int8 pools entry for entry and the sidecar scales."""
    jm, jp, tm, prompt, segs = _models(cache_int8=True, weights_int8=False)
    out_j, out_t, cj, ct = _run(jm, jp, tm, prompt, segs, cache)
    for s, (a, b) in enumerate(zip(out_j, out_t)):
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"forward {s}")
    assert set(ct["decoder"]) == set(cj["decoder"]) == {
        "kv_pool_key", "kv_pool_value", "kv_pool_scale", "cache_index"}
    assert ct["decoder"]["cache_index"] == int(cj["decoder"]["cache_index"])
    page, chunk, pp = _scan_pool_geometry(cache)
    L, HD = KW["num_layers"], KW["embed_dim"]
    for leaf in ("kv_pool_key", "kv_pool_value"):
        got, want = ct["decoder"][leaf], np.asarray(cj["decoder"][leaf])
        assert got.dtype == torch.int8 and want.dtype == np.int8
        assert tuple(got.shape) == want.shape == (B, L * pp, page, HD)
        diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, leaf
    got = ct["decoder"]["kv_pool_scale"]
    want = np.asarray(cj["decoder"]["kv_pool_scale"])
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (B, L * pp // chunk, 8,
                                              chunk * page)
    np.testing.assert_allclose(got.numpy(), want, rtol=SCALE_RTOL, atol=0)
    assert float(got.max()) > 0
    # rows 2..7 of every sidecar block stay empty, as in JAX
    assert float(got[:, :, 2:].abs().max()) == 0


def test_int8_model_matches_jax():
    """bench.py line 4's configuration at small widths: int8 projections,
    the int8 head and the int8 KV pool, prefill + three decode steps."""
    jm, jp, tm, prompt, segs = _models(cache_int8=True, weights_int8=True)
    assert isinstance(tm.lm_head_q, tq.QuantDense)
    assert isinstance(tm.decoder.layers[1].ffn.fc2, tq.QuantDense)
    out_j, out_t, _, _ = _run(jm, jp, tm, prompt, segs, 1040)
    for s, (a, b) in enumerate(zip(out_j, out_t)):
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"forward {s}")


def test_int8_greedy_stream_identical():
    """B=2 greedy over the int8 model: identical token streams."""
    jm, jp, tm, prompt, segs = _models(cache_int8=True, weights_int8=True)
    gcfg = dict(beam_size=1, max_new_tokens=8, min_new_tokens=8,
                vocab_size=KW["vocab_size"])
    want, want_len = jgen.greedy_generate(
        jgen.GenerationConfig(**gcfg), *jk.make_unigpt_generate_fns(jm, 40),
        jp, jnp.asarray(prompt), aux=(None, None, jnp.asarray(segs)))
    got, got_len = tgen.generate(
        tgen.GenerationConfig(**gcfg), *tk.make_unigpt_generate_fns(tm, 40),
        torch.from_numpy(prompt).long(),
        aux=(None, None, torch.from_numpy(segs).long()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("tied", [True, False])
def test_quantize_lm_head_matches_jax(tied):
    """quantize_lm_head is bit-equal to JAX's on a tied and an untied
    head; the state-dict twin gives the bridged tree's tensors; the head's
    logits equal JAX's `_xla_int8_matmul`."""
    params, _, _ = _params(tied)
    assert ("output_projection" in params) == (not tied)
    want = jax.device_get(jk.quantize_lm_head(params))
    got = tk.quantize_lm_head(params)
    for leaf in ("kernel_i8", "scale"):
        a, b = np.asarray(want["lm_head_q"][leaf]), got["lm_head_q"][leaf]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a, err_msg=leaf)
    assert got["lm_head_q"]["kernel_i8"].shape == (KW["embed_dim"],
                                                   KW["vocab_size"])
    via_sd = tk.quantize_lm_head_state_dict(flax_to_state_dict(params))
    bridged = flax_to_state_dict(got)
    for name in ("lm_head_q.weight_i8", "lm_head_q.scale"):
        assert torch.equal(via_sd[name], bridged[name]), name
    assert set(via_sd) == set(bridged)

    cfg = tk.UniGPTConfig(scan_layers=True, quant_lm_head=True,
                          share_input_output_embed=tied, **KW)
    tm = tk.UniGPT(cfg)
    tm.load_state_dict(via_sd, strict=True)
    x = np.random.RandomState(3).randn(B, 3, KW["embed_dim"]).astype(
        np.float32)
    ref = jq._xla_int8_matmul(jnp.asarray(x),
                              jnp.asarray(want["lm_head_q"]["kernel_i8"]),
                              jnp.asarray(want["lm_head_q"]["scale"]))
    out = tm.output_layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=HEAD_ATOL,
                               rtol=0)


# ---- the decoder-only predicate, on a model with a Pix2Struct tower -------

TOWER_KW = dict(embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
                vocab_size=300, max_positions=256, latent_query_num=8,
                use_flash=False)


@functools.lru_cache(maxsize=None)
def _tower_params():
    pcfg = dict(hidden_size=32, num_layers=1, num_heads=2, d_ff=64, d_kv=16,
                patch_dim=48, max_rows=64, use_flash=False)
    jcfg = jk.kosmos2_5(pix2struct=jk.Pix2StructVisionConfig(**pcfg),
                        **TOWER_KW)
    T = TOWER_KW["latent_query_num"] + 4
    tokens = jnp.full((1, T), 4, jnp.int32)
    mask = jnp.zeros((1, T), bool).at[:, 2:-2].set(True)
    rng = np.random.RandomState(0)
    patches = np.zeros((1, 12, 2 + 48), np.float32)
    patches[0, :9, 0] = np.repeat(np.arange(3), 3) + 1
    patches[0, :9, 1] = np.tile(np.arange(3), 3) + 1
    patches[0, :9, 2:] = rng.randn(9, 48)
    params = jk.UniGPT(jcfg).init(jax.random.PRNGKey(0), tokens,
                                  jnp.asarray(patches), mask,
                                  jnp.zeros((1, T), jnp.int32))["params"]
    return jax.device_get(params), patches, pcfg


def _paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, path + (k,))
        else:
            yield path + (k,)


def test_decoder_only_predicate_and_the_jax_fault():
    """The JAX CLI's --int8 predicate also selects the Pix2Struct tower's
    layer projections (the fault that makes its --int8 fail on an image:
    the tower's nn.Dense finds no `kernel`); the port's selects the text
    decoder's 12 projections only, the connector's none."""
    params, _, _ = _tower_params()
    kernels = [p for p in _paths(params) if p[-1] == "kernel"]
    jax_sel = [p for p in kernels if _jax_cli_predicate(p)]
    port_sel = [p for p in kernels if tq.is_decoder_projection(p)]
    assert any(p[0] == "img_model" for p in jax_sel)  # the JAX fault
    assert all(p[0] == "decoder" and p[1].startswith("layers_")
               for p in port_sel)
    assert len(port_sel) == 2 * 6
    assert set(port_sel) == {p for p in jax_sel if p[0] == "decoder"}
    assert not any(p[0] in ("img_model", "img_connector") for p in port_sel)
    # the state-dict predicate agrees
    sd = flax_to_state_dict(params)
    names = sorted(k for k in sd if tq._is_layer_projection(k))
    assert len(names) == 12 and all(n.startswith("decoder.layers.")
                                    for n in names)
    with pytest.raises(Exception, match="kernel"):
        bad = jk.UniGPT(jk.kosmos2_5(
            pix2struct=jk.Pix2StructVisionConfig(**_tower_params()[2]),
            quant_weights=True, **TOWER_KW))
        bad.apply({"params": jq.quantize_dense_tree(
            params, predicate=_jax_cli_predicate)},
            jnp.asarray(_tower_params()[1]), method=bad.encode_image)


def test_int8_model_with_tower_encodes_images():
    """A tiny Kosmos-2.5 with its tower, quantized as kosmos_infer --int8
    does (decoder projections, the head, int8 KV), runs encode_image on
    the CPU: the tower is untouched, so its features equal the
    unquantized model's and JAX's; prefill and a decode step then run."""
    params, patches, pcfg = _tower_params()
    sd = flax_to_state_dict(params)
    base = tk.UniGPT(tk.kosmos2_5(
        pix2struct=tk.Pix2StructVisionConfig(**pcfg), **TOWER_KW)).eval()
    base.load_state_dict(sd, strict=True)
    qsd = tk.quantize_lm_head_state_dict(tq.quantize_state_dict(sd))
    qm = tk.UniGPT(tk.kosmos2_5(
        pix2struct=tk.Pix2StructVisionConfig(**pcfg), scan_layers=True,
        quant_weights=True, quant_lm_head=True, kv_cache_dtype="int8",
        **TOWER_KW)).eval()
    qm.load_state_dict(qsd, strict=True)
    x = torch.from_numpy(patches)
    with torch.no_grad():
        feats = qm.encode_image(x)
        assert torch.equal(feats, base.encode_image(x))
    jm = jk.UniGPT(jk.kosmos2_5(pix2struct=jk.Pix2StructVisionConfig(**pcfg),
                                **TOWER_KW))
    want = jm.apply({"params": params}, jnp.asarray(patches),
                    method=jm.encode_image)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    T = TOWER_KW["latent_query_num"] + 4
    tokens = torch.full((1, T), 4, dtype=torch.long)
    mask = torch.zeros((1, T), dtype=torch.bool)
    mask[:, 2:-2] = True
    logits, cache = qm.prefill(tokens, 32, feats, mask, last_logit_only=True)
    logits, cache = qm.decode_step(logits.argmax(-1), cache, 32)
    assert bool(torch.isfinite(logits).all())
    assert cache["decoder"]["kv_pool_key"].dtype == torch.int8


def test_bridge_maps_every_int8_leaf():
    """The int8 trees of the two packages are bit-equal, and every leaf of
    one (the stacked kernel_i8 / scale pairs and `lm_head_q`) lands on
    exactly one tensor of the int8 UniGPT: lm_head_q/kernel_i8 [E, V] ->
    lm_head_q.weight_i8 [V, E], lm_head_q/scale -> lm_head_q.scale."""
    params, _, _ = _params(True)
    want, got = _quantized(params)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        assert np.asarray(a).dtype == b.dtype, path
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))
    sd = flax_to_state_dict(got)
    L = KW["num_layers"]
    n_layer = len(jax.tree_util.tree_leaves(got["decoder"]["layers"]))
    assert len(sd) == len(jax.tree_util.tree_leaves(got)) + (L - 1) * n_layer
    tm = tk.UniGPT(tk.UniGPTConfig(scan_layers=True, quant_weights=True,
                                   quant_lm_head=True, kv_cache_dtype="int8",
                                   **KW))
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(sd["lm_head_q.weight_i8"].numpy(),
                                  got["lm_head_q"]["kernel_i8"].T)
    np.testing.assert_array_equal(sd["lm_head_q.scale"].numpy(),
                                  got["lm_head_q"]["scale"])
    assert sd["decoder.layers.1.self_attn.q_proj.weight_i8"].dtype == torch.int8
    assert "embed_tokens.weight" in sd  # the lookup stays full precision
