"""Port parity for Kosmos-2's model side on the CPU: unilm_tpu_torch's
ClipVisionEncoder, UniGPT.encode_image and the multimodal forward with
the CLIP tower, greedy generation with image features, the open_clip
converter and the kosmos2() preset, against unilm_tpu.

A small config (tower: 2 layers at 28 px, patch 14, E 32, 2 heads;
decoder: 2 layers, E 64, 4 heads; 6 latent queries; segment embeddings)
is initialised by the JAX model and carried across by
convert/from_jax.py; images, prompts and masks come from numpy with a
seed. Tolerances: float32 with JAX at `highest` precision, 1e-4 abs on
features and logits (the same fp32 math in another order; readings
~1e-6); the greedy ids identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.convert import kosmos as jconv
from unilm_tpu.models import kosmos as jk
from unilm_tpu.runtime import generate as jgen
from unilm_tpu_torch.convert import kosmos as tconv
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.models import kosmos as tk
from unilm_tpu_torch.runtime import generate as tgen

torch.set_num_threads(1)

CK = dict(img_size=28, patch_size=14, embed_dim=32, num_layers=2,
          num_heads=2, ffn_dim=64, use_flash=False)
KW = dict(vocab_size=300, embed_dim=64, num_layers=2, num_heads=4,
          ffn_dim=128, max_positions=64, segment_emb=True,
          latent_query_num=6, image_tower="clip", use_flash=False)
B, T, NEW = 2, 12, 6
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup():
    rng = np.random.RandomState(0)
    images = rng.rand(B, CK["img_size"], CK["img_size"], 3).astype(np.float32)
    tokens = rng.randint(3, KW["vocab_size"], size=(B, T)).astype(np.int32)
    tokens[1, -2:] = 1  # two pad keys in example 1
    img_mask = np.zeros((B, T), bool)
    img_mask[:, 2:2 + KW["latent_query_num"]] = True
    segs = np.zeros((B, T), np.int32)
    segs[:, 1:3 + KW["latent_query_num"]] = 1
    jm = jk.UniGPT(jk.UniGPTConfig(clip=jk.ClipVisionConfig(**CK), **KW))
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(1), jnp.asarray(tokens), jnp.asarray(images),
        jnp.asarray(img_mask), jnp.asarray(segs))["params"])
    tm = tk.UniGPT(tk.UniGPTConfig(clip=tk.ClipVisionConfig(**CK),
                                   **KW)).eval()
    load_flax_params(tm, params)
    x = dict(images=images, tokens=tokens, img_mask=img_mask, segs=segs)
    return jm, params, tm, x


def _t(a, long=False):
    t = torch.from_numpy(np.array(a))
    return t.long() if long else t


def test_clip_tower_matches_jax():
    jm, params, tm, x = _setup()
    tower = jk.ClipVisionEncoder(jk.ClipVisionConfig(**CK))
    want = tower.apply({"params": params["img_model"]},
                       jnp.asarray(x["images"]))
    with torch.no_grad():
        got = tm.img_model(_t(x["images"]))
    assert got.dtype == torch.float32
    assert got.shape == (B, (CK["img_size"] // CK["patch_size"]) ** 2 + 1,
                         CK["embed_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_encode_image_matches_jax():
    jm, params, tm, x = _setup()
    want = jm.apply({"params": params}, jnp.asarray(x["images"]),
                    method=jm.encode_image)
    with torch.no_grad():
        got = tm.encode_image(_t(x["images"]))
    assert got.shape == (B, KW["latent_query_num"], KW["embed_dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_multimodal_forward_matches_jax():
    jm, params, tm, x = _setup()
    want = jm.apply({"params": params}, jnp.asarray(x["tokens"]),
                    jnp.asarray(x["images"]), jnp.asarray(x["img_mask"]),
                    jnp.asarray(x["segs"]))
    with torch.no_grad():
        got = tm(_t(x["tokens"], True), _t(x["images"]), _t(x["img_mask"]),
                 _t(x["segs"], True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_greedy_generation_with_image_features_matches_jax():
    """generate() with (img_features, img_mask, segs) aux: the same greedy
    ids, and every step's logits (prefill and decode, teacher-forced on
    those ids) within ATOL."""
    jm, params, tm, x = _setup()
    cache = T + NEW
    jfeat = jm.apply({"params": params}, jnp.asarray(x["images"]),
                     method=jm.encode_image)
    jaux = (jfeat, jnp.asarray(x["img_mask"]), jnp.asarray(x["segs"]))
    jpf, jst = jk.make_unigpt_generate_fns(jm, cache)
    jout, _ = jgen.generate(
        jgen.GenerationConfig(beam_size=1, max_new_tokens=NEW, eos=-1,
                              vocab_size=KW["vocab_size"]),
        jpf, jst, params, jnp.asarray(x["tokens"]), aux=jaux)
    with torch.no_grad():
        tfeat = tm.encode_image(_t(x["images"]))
    taux = (tfeat, _t(x["img_mask"]), _t(x["segs"], True))
    tpf, tst = tk.make_unigpt_generate_fns(tm, cache)
    tout, _ = tgen.generate(
        tgen.GenerationConfig(beam_size=1, max_new_tokens=NEW, eos=-1,
                              vocab_size=KW["vocab_size"]),
        tpf, tst, _t(x["tokens"], True), aux=taux)
    ids = np.asarray(jout)
    np.testing.assert_array_equal(tout.numpy(), ids)

    jl, jc = jpf(params, jnp.asarray(x["tokens"]), jaux)
    with torch.no_grad():
        tl, tc = tpf(_t(x["tokens"], True), taux)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for i in range(T, T + NEW - 1):
        jl, jc = jst(params, jnp.asarray(ids[:, i:i + 1]), jc, jaux)
        with torch.no_grad():
            tl, tc = tst(_t(ids[:, i:i + 1], True), tc, taux)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def _open_clip_sd(E=32, L=2, p=14, n=5, seed=2):
    """A synthetic open_clip visual state dict (packed in_proj)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.1
    sd = {"visual.conv1.weight": r(E, 3, p, p),
          "visual.class_embedding": r(E),
          "visual.positional_embedding": r(n, E),
          "visual.ln_pre.weight": 1 + r(E), "visual.ln_pre.bias": r(E),
          "visual.ln_post.weight": 1 + r(E), "visual.ln_post.bias": r(E)}
    for i in range(L):
        b = f"visual.transformer.resblocks.{i}"
        sd.update({
            f"{b}.ln_1.weight": 1 + r(E), f"{b}.ln_1.bias": r(E),
            f"{b}.ln_2.weight": 1 + r(E), f"{b}.ln_2.bias": r(E),
            f"{b}.attn.in_proj_weight": r(3 * E, E),
            f"{b}.attn.in_proj_bias": r(3 * E),
            f"{b}.attn.out_proj.weight": r(E, E),
            f"{b}.attn.out_proj.bias": r(E),
            f"{b}.mlp.c_fc.weight": r(2 * E, E),
            f"{b}.mlp.c_fc.bias": r(2 * E),
            f"{b}.mlp.c_proj.weight": r(E, 2 * E),
            f"{b}.mlp.c_proj.bias": r(E)})
    return sd


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_convert_clip_visual_matches_jax():
    """The port's open_clip converter gives JAX's tree leaf for leaf, and
    the converted tower computes JAX's features (conv1 HWIO -> OIHW in
    convert/from_jax.py)."""
    sd = _open_clip_sd()
    want = jconv.convert_clip_visual(sd, 2)
    got = tconv.convert_clip_visual(sd, 2)
    wl, gl = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in wl] == [p for p, _ in gl]
    for (path, a), (_, b) in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    tsd = flax_to_state_dict(got)
    assert torch.equal(tsd["conv1.weight"], sd["visual.conv1.weight"])
    tower = tk.ClipVisionEncoder(tk.ClipVisionConfig(**CK)).eval()
    load_flax_params(tower, got)
    img = np.random.RandomState(3).rand(1, 28, 28, 3).astype(np.float32)
    jt = jk.ClipVisionEncoder(jk.ClipVisionConfig(**CK))
    wf = jt.apply({"params": want}, jnp.asarray(img))
    with torch.no_grad():
        gf = tower(torch.from_numpy(img))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=ATOL)


def test_kosmos2_preset_matches_jax():
    """kosmos2()'s fields equal JAX's (dtypes aside), the tower inherits
    the compute dtype, and the preset is the ~1.67 B-parameter model."""
    for kw in ({}, {"dtype": (jnp.bfloat16, torch.bfloat16)}):
        j = jk.kosmos2(**{k: v[0] for k, v in kw.items()})
        t = tk.kosmos2(**{k: v[1] for k, v in kw.items()})
        for f in ("vocab_size", "embed_dim", "num_layers", "num_heads",
                  "ffn_dim", "max_positions", "subln", "xpos_rel_pos",
                  "segment_emb", "image_tower", "latent_query_num",
                  "learned_pos", "scale_embedding", "activation"):
            assert getattr(j, f) == getattr(t, f), f
        for f in ("img_size", "patch_size", "embed_dim", "num_layers",
                  "num_heads", "ffn_dim", "layernorm_eps"):
            assert getattr(j.clip, f) == getattr(t.clip, f), f
        assert t.clip.dtype == t.dtype
    with torch.device("meta"):
        m = tk.UniGPT(tk.kosmos2())
    n = sum(p.numel() for p in m.parameters())
    assert 1.6e9 < n < 1.7e9, n


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_bf16_tower_keeps_a_float32_residual_stream(dtype):
    """ln_pre / ln_post output float32 under a bf16 tower, as flax's
    dtype=None LayerNorms do; the features stay close to JAX's bf16
    tower (0.04 abs: ~5 bf16 ulps at unit scale after 2 bf16 layers)."""
    rng = np.random.RandomState(5)
    img = rng.rand(2, 28, 28, 3).astype(np.float32)
    jt = jk.ClipVisionEncoder(jk.ClipVisionConfig(dtype=jnp.bfloat16, **CK))
    params = jax.device_get(jt.init(jax.random.PRNGKey(2),
                                    jnp.asarray(img))["params"])
    tt = tk.ClipVisionEncoder(tk.ClipVisionConfig(dtype=torch.bfloat16,
                                                  **CK)).eval()
    load_flax_params(tt, params)
    want = jt.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        got = tt(torch.from_numpy(img))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.04)
