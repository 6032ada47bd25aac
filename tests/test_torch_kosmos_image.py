"""Port parity for the Kosmos-2.5 image side: unilm_tpu_torch's
Pix2StructVisionEncoder (with padded patches), LatentQueryResampler,
UniGPT.encode_image, the image prefill and the train forward with raw
patches, against unilm_tpu on the CPU.

A tiny config (tower: 2 layers, hidden 48, 3 heads of 16; decoder: 2
layers, E=64, 4 heads; 6 latent queries) is initialised by the JAX model
and carried across by convert/from_jax.py; patches, prompts and masks come
from numpy. Tolerances: float32 1e-4 abs (the same fp32 math in another
order; readings ~1e-6); the bfloat16 run 0.04 abs on the tower's float32
output (~5 bf16 ulps at unit scale after 2 bf16 layers) and 0.0625 on the
logits (4 bf16 ulps at |logit| < 8), as tests/test_torch_unigpt_slice.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.models import kosmos as jk
from unilm_tpu_torch.convert.from_jax import flax_to_state_dict, load_flax_params
from unilm_tpu_torch.models import kosmos as tk

torch.set_num_threads(1)

PKW = dict(hidden_size=48, num_layers=2, num_heads=3, d_ff=80, d_kv=16,
           patch_dim=12, max_rows=16, use_flash=False)
KW = dict(vocab_size=97, embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
          max_positions=64, segment_emb=True, latent_query_num=6,
          image_tower="pix2struct", use_flash=False)
B, N, T, CACHE = 2, 10, 12, 40
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _setup(dtype: str):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    patches = rng.randn(B, N, 2 + PKW["patch_dim"]).astype(np.float32)
    patches[:, :, :2] = rng.randint(1, 5, size=(B, N, 2))
    patches[1, 7:] = 0  # three padded patches in example 1
    tokens = rng.randint(4, KW["vocab_size"], size=(B, T)).astype(np.int32)
    img_mask = np.zeros((B, T), bool)
    img_mask[:, 2:2 + KW["latent_query_num"]] = True
    segs = img_mask.astype(np.int32)
    jcfg = jk.UniGPTConfig(pix2struct=jk.Pix2StructVisionConfig(dtype=jdt,
                                                                **PKW),
                           dtype=jdt, param_dtype=jdt, **KW)
    tcfg = tk.UniGPTConfig(pix2struct=tk.Pix2StructVisionConfig(dtype=tdt,
                                                                **PKW),
                           dtype=tdt, param_dtype=tdt, **KW)
    jm = jk.UniGPT(jcfg)
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(1), jnp.asarray(tokens), jnp.asarray(patches, jdt),
        jnp.asarray(img_mask), jnp.asarray(segs))["params"])
    tm = tk.UniGPT(tcfg).eval()
    load_flax_params(tm, params)
    inputs = dict(patches=patches, tokens=tokens, img_mask=img_mask,
                  segs=segs)
    return jm, params, tm, inputs


def _f32(a):
    return np.asarray(a, np.float32)


def test_bridge_maps_every_tower_leaf():
    _, params, tm, _ = _setup("float32")
    sd = flax_to_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    for name in ("img_model.patch_projection.weight",
                 "img_model.row_embedder.weight",
                 "img_model.encoder.layers.1.ffn.fc3.weight",
                 "img_model.layernorm.weight", "img_connector.latent_query",
                 "img_connector.x_attn.k_proj.bias"):
        assert name in sd, name
    assert "img_connector.x_attn.inner_attn_ln.weight" not in sd


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.04)])
def test_tower_matches_jax(dtype, tol):
    jm, params, tm, x = _setup(dtype)
    jdt, tdt = DTYPES[dtype]
    jf, jmask = jm.apply({"params": params}, jnp.asarray(x["patches"], jdt),
                         method=lambda m, p: m.img_model(p))
    with torch.no_grad():
        tf, tmask = tm.img_model(torch.from_numpy(x["patches"]).to(tdt))
    # the tower's output is float32 in either dtype (flax promotion)
    assert tf.dtype == torch.float32 and jf.dtype == jnp.float32
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert not tmask[1, 7:].any() and (tf[1, 7:] == 0).all()
    np.testing.assert_allclose(tf.numpy(), _f32(jf), atol=tol)


def test_resampler_matches_jax():
    jm, params, tm, _ = _setup("float32")
    feats = np.random.RandomState(5).randn(B, N, PKW["hidden_size"]).astype(
        np.float32)
    want = jm.apply({"params": params}, jnp.asarray(feats),
                    method=lambda m, f: m.img_connector(f))
    with torch.no_grad():
        got = tm.img_connector(torch.from_numpy(feats))
    assert tuple(got.shape) == (B, KW["latent_query_num"], KW["embed_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.0625)])
def test_encode_image_and_prefill_match_jax(dtype, tol):
    """encode_image (tower -> L2 norm -> resampler), then the prefill with
    the features spliced in, as benchmarks/kosmos_ttft.py runs them."""
    jm, params, tm, x = _setup(dtype)
    jdt, tdt = DTYPES[dtype]
    jfeats = jm.apply({"params": params}, jnp.asarray(x["patches"], jdt),
                      method=jm.encode_image)
    jprefill, _ = jk.make_unigpt_generate_fns(jm, CACHE)
    jlog, _ = jprefill(params, jnp.asarray(x["tokens"]),
                       (jfeats, jnp.asarray(x["img_mask"]),
                        jnp.asarray(x["segs"])))
    tprefill, _ = tk.make_unigpt_generate_fns(tm, CACHE)
    with torch.no_grad():
        tfeats = tm.encode_image(torch.from_numpy(x["patches"]).to(tdt))
        tlog, _ = tprefill(torch.from_numpy(x["tokens"]).long(),
                           (tfeats, torch.from_numpy(x["img_mask"]),
                            torch.from_numpy(x["segs"]).long()))
    assert tfeats.dtype == tdt  # the resampler's attention runs in dtype
    np.testing.assert_allclose(tfeats.float().numpy(), _f32(jfeats),
                               atol=tol)
    np.testing.assert_allclose(tlog.float().numpy(), _f32(jlog), atol=tol)


def test_forward_with_raw_patches_matches_jax():
    jm, params, tm, x = _setup("float32")
    want = jm.apply({"params": params}, jnp.asarray(x["tokens"]),
                    jnp.asarray(x["patches"]), jnp.asarray(x["img_mask"]),
                    jnp.asarray(x["segs"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x["tokens"]).long(),
                 torch.from_numpy(x["patches"]),
                 torch.from_numpy(x["img_mask"]),
                 torch.from_numpy(x["segs"]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_kosmos2_5_tower_inherits_the_compute_dtype():
    cfg = tk.kosmos2_5(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    assert cfg.image_tower == "pix2struct"
    assert cfg.pix2struct.dtype == torch.bfloat16
    assert tk.kosmos2_5().pix2struct.dtype == torch.float32
    j = jk.kosmos2_5(dtype=jnp.bfloat16)
    assert (j.pix2struct.hidden_size, j.pix2struct.num_layers) == (
        cfg.pix2struct.hidden_size, cfg.pix2struct.num_layers)


def test_unported_towers_raise():
    """The CLIP tower (Kosmos-2) is ported: it builds beside this file's
    decoder and its encode_image matches JAX's. The WavLM audio tower is
    ported too (its parity: tests/test_torch_speech.py): it builds, and
    an audio tower the JAX model does not know raises ValueError, as
    JAX's does."""
    ck = dict(img_size=28, patch_size=14, embed_dim=32, num_layers=2,
              num_heads=2, ffn_dim=64, use_flash=False)
    kw = {k: v for k, v in KW.items() if k != "image_tower"}
    jm = jk.UniGPT(jk.UniGPTConfig(image_tower="clip",
                                   clip=jk.ClipVisionConfig(**ck), **kw))
    rng = np.random.RandomState(6)
    img = rng.rand(B, 28, 28, 3).astype(np.float32)
    tokens = rng.randint(4, KW["vocab_size"], size=(B, T)).astype(np.int32)
    mask = np.zeros((B, T), bool)
    mask[:, 2:2 + KW["latent_query_num"]] = True
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(3), jnp.asarray(tokens), jnp.asarray(img),
        jnp.asarray(mask), jnp.asarray(mask.astype(np.int32)))["params"])
    tm = tk.UniGPT(tk.UniGPTConfig(image_tower="clip",
                                   clip=tk.ClipVisionConfig(**ck), **kw))
    load_flax_params(tm.eval(), params)
    want = jm.apply({"params": params}, jnp.asarray(img),
                    method=jm.encode_image)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    audio = tk.UniGPT(tk.UniGPTConfig(audio_tower="wavlm", image_tower=None,
                                      **kw), device="meta")
    assert type(audio.aud_model).__name__ == "WavLMModel"
    assert audio.aud_connector.latent_query.shape == (64, KW["embed_dim"])
    with pytest.raises(ValueError, match="unknown audio tower"):
        tk.UniGPT(tk.UniGPTConfig(audio_tower="hubert", image_tower=None,
                                  **kw))


def test_pix2struct_patches_match_the_jax_package():
    """The port's copy of the patch extractor gives the JAX package's
    array for the same image (both numpy + PIL)."""
    from unilm_tpu.data import transforms as jt
    from unilm_tpu_torch.data import transforms as tt

    img = np.random.RandomState(4).rand(70, 45, 3).astype(np.float32)
    got = tt.pix2struct_patches(img, max_patches=64, patch_size=4)
    np.testing.assert_array_equal(
        got, jt.pix2struct_patches(img, max_patches=64, patch_size=4))
    assert got.shape == (64, 2 + 48)
    n = int((np.abs(got).sum(-1) > 0).sum())
    assert 0 < n <= 64 and (got[n:] == 0).all()
