"""Port parity for BEiT-2 and the DALL-E tokenizer (models/beit2.py,
models/dalle_vae.py, convert/dalle.py, convert/from_jax.py's `ema`
collection and HWIO convolutions) against unilm_tpu on the CPU.

Sizes: 2 layers, width 32, 4 heads, 16 px images in 8 px patches, a
codebook of 16-32 codes of 8 dims; the DALL-E encoder at 8 hidden
channels, one block a group. Params come from a JAX init with every leaf
moved off its init value by seeded noise and reach the port through
convert/from_jax.py (the `ema` buffers too); inputs come from numpy
seeds. JAX runs its XLA paths (use_flash=False) at matmul precision
`highest`, the port its plain path in float32. Tolerance: 1e-5 relative
+ 1e-5 absolute; ids equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unilm_tpu.convert import dalle as jconv_dalle
from unilm_tpu.models import beit2 as jb2
from unilm_tpu.models import dalle_vae as jdv
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch.convert import dalle as tconv_dalle
from unilm_tpu_torch.convert.from_jax import (flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.models import beit2 as tb2
from unilm_tpu_torch.models import dalle_vae as tdv
from unilm_tpu_torch.runtime import train as ttrain

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
B = 2


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _noisy(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + (scale * rng.randn(
        *x.shape)).astype(np.float32), jax.device_get(params))


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed=0, size=16):
    return np.random.RandomState(seed).randn(B, size, size, 3).astype(
        np.float32)


# ---- the quantizer ---------------------------------------------------------

QKW = dict(num_tokens=16, codebook_dim=8, decay=0.9)


def _quantizers():
    jq = jb2.NormEMAVectorQuantizer(**QKW)
    z = np.random.RandomState(1).randn(B, 5, 8).astype(np.float32)
    variables = jax.device_get(jq.init(jax.random.PRNGKey(1), jnp.asarray(z)))
    tq = tb2.NormEMAVectorQuantizer(**QKW)
    load_flax_params(tq, {}, ema=variables["ema"])
    return jq, variables, tq, z


def test_quantizer_matches_jax():
    """ids, the quantized vectors (codebook rows) and the commitment
    loss."""
    jq, variables, tq, z = _quantizers()
    wq, wloss, widx = jq.apply(variables, jnp.asarray(z))
    with torch.no_grad():
        q, loss, idx = tq(_t(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    assert idx.shape == (B, 5)
    _close(q, wq)
    _close(loss, wloss)


def test_quantizer_straight_through_gradient_matches_jax_grad():
    jq, variables, tq, z = _quantizers()
    w = np.random.RandomState(2).randn(B, 5, 8).astype(np.float32)

    def f(z_):
        quant, loss, _ = jq.apply(variables, z_)
        return jnp.sum(quant * w) + loss

    want = jax.grad(f)(jnp.asarray(z))
    zt = _t(z).requires_grad_()
    quant, loss, _ = tq(zt)
    (quant * _t(w)).sum().add(loss).backward()
    _close(zt.grad, want)
    assert float(zt.grad.abs().max()) > 0


def test_two_ema_updates_match_jax():
    """Two update_ema passes (the second on other vectors): the codebook
    and the smoothed cluster sizes after each equal JAX's `ema`
    collection; a plain call leaves the buffers alone."""
    jq, variables, tq, z = _quantizers()
    z2 = np.random.RandomState(3).randn(B, 5, 8).astype(np.float32)
    ema = variables
    for zz in (z, z2):
        (_, _, widx), upd = jq.apply(ema, jnp.asarray(zz), update_ema=True,
                                     mutable=["ema"])
        ema = jax.device_get(upd)
        with torch.no_grad():
            _, _, idx = tq(_t(zz), update_ema=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
        _close(tq.embedding, ema["ema"]["embedding"])
        _close(tq.cluster_size, ema["ema"]["cluster_size"])
    before = tq.embedding.clone()
    with torch.no_grad():
        tq(_t(z))
    assert torch.equal(before, tq.embedding)


# ---- VQ-KD -----------------------------------------------------------------

VQKD_KW = dict(img_size=16, patch_size=8, encoder_dim=32, encoder_layers=2,
               encoder_heads=4, decoder_dim=32, decoder_layers=2,
               decoder_heads=4, codebook_size=32, codebook_dim=8,
               teacher_dim=16, use_flash=False)


@functools.lru_cache(maxsize=None)
def _vqkd():
    jm = jb2.VQKD(jb2.VQKDConfig(**VQKD_KW))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2),
                                       jnp.asarray(_images())))
    params = _noisy(variables["params"], 4)
    tm = tb2.VQKD(tb2.VQKDConfig(**VQKD_KW)).eval()
    load_flax_params(tm, params, ema=variables["ema"])
    return jm, {"params": params, "ema": variables["ema"]}, tm


def test_vqkd_matches_jax():
    """VQKD's (rec, vq_loss, idx), get_codebook_indices, and an
    update_ema forward's buffers."""
    jm, variables, tm = _vqkd()
    img = _images(5)
    rec, loss, idx = jm.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tm(_t(img))
        ids = tm.get_codebook_indices(_t(img))
    assert got[0].shape == (B, 4, 16) and got[2].shape == (B, 4)
    _close(got[0], rec)
    _close(got[1], loss)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(idx))
    (_, _, _), upd = jm.apply(variables, jnp.asarray(img), update_ema=True,
                              mutable=["ema"])
    tm2 = tb2.VQKD(tb2.VQKDConfig(**VQKD_KW)).eval()
    tm2.load_state_dict(tm.state_dict())
    with torch.no_grad():
        tm2(_t(img), update_ema=True)
    ema = jax.device_get(upd)["ema"]["quantize"]
    _close(tm2.quantize.embedding, ema["embedding"])
    _close(tm2.quantize.cluster_size, ema["cluster_size"])


# ---- the conv tokenizers ---------------------------------------------------

def test_discrete_vae_matches_jax():
    jm = jb2.DiscreteVAE(vocab_size=64, hidden=8, image_size=16, downscale=2)
    img = _images(6)
    params = _noisy(jm.init(jax.random.PRNGKey(3),
                            jnp.asarray(img))["params"], 5)
    want = jm.apply({"params": params}, jnp.asarray(img))
    wids = jm.apply({"params": params}, jnp.asarray(img),
                    method=jm.get_codebook_indices)
    tm = tb2.DiscreteVAE(vocab_size=64, hidden=8, image_size=16, downscale=2)
    load_flax_params(tm, params)
    with torch.no_grad():
        got, ids = tm(_t(img)), tm.get_codebook_indices(_t(img))
    assert got.shape == (B, 4, 4, 64)
    _close(got, want)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))


DALLE_KW = dict(group_count=4, n_hid=8, n_blk_per_group=1, vocab_size=32)


def test_dalle_encoder_matches_jax():
    """DalleEncoder's logits [B, H/8, W/8, V] and ids from a JAX init
    (HWIO kernels carried into OIHW), and map_pixels."""
    jm = jdv.DalleEncoder(jdv.DalleEncoderConfig(**DALLE_KW))
    img = np.random.RandomState(7).rand(B, 16, 16, 3).astype(np.float32)
    params = _noisy(jm.init(jax.random.PRNGKey(4),
                            jnp.asarray(img))["params"], 6)
    want = jm.apply({"params": params}, jnp.asarray(img))
    wids = jm.apply({"params": params}, jnp.asarray(img),
                    method=jm.get_codebook_indices)
    tm = tdv.DalleEncoder(tdv.DalleEncoderConfig(**DALLE_KW))
    load_flax_params(tm, params)
    with torch.no_grad():
        got, ids = tm(_t(img)), tm.get_codebook_indices(_t(img))
    assert got.shape == (B, 2, 2, 32)
    _close(got, want)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    _close(tdv.map_pixels(_t(img)), jdv.map_pixels(jnp.asarray(img)))


def _encoder_pkl(cfg, rng):
    """A dall_e Encoder state dict of `cfg`'s shape: blocks.input,
    blocks.group_N.block_M.{id_path, res_path.conv_K}, blocks.output.conv,
    each `.w` [O, I, k, k] and `.b` [O] (torch tensors)."""
    sd = {}

    def conv(name, i, o, k):
        sd[f"{name}.w"] = torch.from_numpy(
            (rng.randn(o, i, k, k) / np.sqrt(i * k * k)).astype(np.float32))
        sd[f"{name}.b"] = torch.from_numpy(
            (0.1 * rng.randn(o)).astype(np.float32))

    conv("blocks.input", 3, cfg.n_hid, 7)
    n_in = cfg.n_hid
    for gi, m in enumerate([1, 2, 4, 8][:cfg.group_count], start=1):
        for bi in range(1, cfg.n_blk_per_group + 1):
            p, n_out = f"blocks.group_{gi}.block_{bi}", m * cfg.n_hid
            if n_in != n_out:
                conv(f"{p}.id_path", n_in, n_out, 1)
            conv(f"{p}.res_path.conv_1", n_in, n_out // 4, 3)
            conv(f"{p}.res_path.conv_2", n_out // 4, n_out // 4, 3)
            conv(f"{p}.res_path.conv_3", n_out // 4, n_out // 4, 3)
            conv(f"{p}.res_path.conv_4", n_out // 4, n_out, 1)
            n_in = n_out
    conv("blocks.output.conv", n_in, cfg.vocab_size, 1)
    return sd


def test_convert_dalle_encoder_matches_jax():
    """An encoder.pkl-shaped state dict through each package's converter:
    the same logits."""
    jcfg = jdv.DalleEncoderConfig(**DALLE_KW)
    tcfg = tdv.DalleEncoderConfig(**DALLE_KW)
    sd = _encoder_pkl(tcfg, np.random.RandomState(8))
    img = np.random.RandomState(9).rand(B, 16, 16, 3).astype(np.float32)
    want = jdv.DalleEncoder(jcfg).apply(
        {"params": jconv_dalle.convert_dalle_encoder(sd, jcfg)},
        jnp.asarray(img))
    tm = tdv.DalleEncoder(tcfg)
    tm.load_state_dict(tconv_dalle.convert_dalle_encoder(sd, tcfg),
                       strict=True)
    with torch.no_grad():
        _close(tm(_t(img)), want)


# ---- BEiT-2 CLS pretraining ------------------------------------------------

CLS_KW = dict(img_size=16, patch_size=8, embed_dim=32, num_layers=2,
              num_heads=4, vocab_size=64, early_layer=0, use_flash=False)


@functools.lru_cache(maxsize=None)
def _cls_model():
    jm = jb2.BEiT2ForMaskedImageModelingCLS(jb2.Beit2PretrainConfig(**CLS_KW))
    mask = np.zeros((B, 4), bool)
    mask[0, 1:3] = mask[1, 0] = mask[1, 3] = True
    params = _noisy(jm.init(jax.random.PRNGKey(5), jnp.asarray(_images()),
                            jnp.asarray(mask))["params"], 7)
    tm = tb2.BEiT2ForMaskedImageModelingCLS(
        tb2.Beit2PretrainConfig(**CLS_KW)).eval()
    load_flax_params(tm, params)
    return jm, params, tm, mask


def test_beit2_cls_logits_match_jax():
    jm, params, tm, mask = _cls_model()
    img = _images(10)
    wl, wc = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        gl, gc = tm(_t(img), _t(mask))
    assert gl.shape == gc.shape == (B, 4, 64)
    _close(gl, wl)
    _close(gc, wc)


def test_beit2_cls_step_loss_and_grads_match_jax_grad():
    """The masked CE of both heads (each runtime.train.cross_entropy_loss
    over the masked patches, summed): the loss and every parameter's
    gradient against jax.grad, the gradient tree carried by
    flax_to_state_dict's own naming (kernels transposed)."""
    jm, params, tm, mask = _cls_model()
    img = _images(11)
    y = np.random.RandomState(12).randint(0, 64, (B, 4))

    jy, jmask = jnp.asarray(y), jnp.asarray(mask)

    def jloss(p):
        lg, lc = jm.apply({"params": p}, jnp.asarray(img), jmask)
        s1, n = jtrain.cross_entropy_loss(lg, jy, jmask)
        s2, _ = jtrain.cross_entropy_loss(lc, jy, jmask)
        return (s1 + s2) / n

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    tm.zero_grad()
    lg, lc = tm(_t(img), _t(mask))
    s1, n = ttrain.cross_entropy_loss(lg, _t(y), _t(mask))
    s2, _ = ttrain.cross_entropy_loss(lc, _t(y), _t(mask))
    loss = (s1 + s2) / n
    loss.backward()
    _close(loss, want_loss)
    want = flax_to_state_dict(jax.device_get(want_grads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        _close(got[name].grad, g.numpy(), rtol=1e-5, atol=1e-6)


def test_beit2_cls_logits_never_see_the_final_cls():
    """The reference's fault, reproduced (ROADMAP Queue 3): `logits_cls`
    reads the early layer's patch states alone. Changing the last
    layer and the final norm (which move every final state, the CLS among
    them) changes `logits` in both packages and leaves `logits_cls`
    bit-equal; so does a change of the final CLS state alone in the
    port."""
    jm, params, tm, mask = _cls_model()
    img = _images(13)
    moved = jax.tree.map(np.copy, params)
    last = moved["backbone"]["encoder"]
    for sub in (last["layers_1"]["ffn"]["fc2"], last["layer_norm"]):
        sub["bias"] = sub["bias"] + 0.5
    outs = [jm.apply({"params": p}, jnp.asarray(img), jnp.asarray(mask))
            for p in (params, moved)]
    assert float(np.abs(outs[0][0] - outs[1][0]).max()) > 1e-3
    np.testing.assert_array_equal(np.asarray(outs[0][1]),
                                  np.asarray(outs[1][1]))
    tm2 = tb2.BEiT2ForMaskedImageModelingCLS(
        tb2.Beit2PretrainConfig(**CLS_KW)).eval()
    load_flax_params(tm2, moved)
    with torch.no_grad():
        base, shifted = tm(_t(img), _t(mask)), tm2(_t(img), _t(mask))
    assert float((base[0] - shifted[0]).abs().max()) > 1e-3
    assert torch.equal(base[1], shifted[1])
    _close(shifted[1], outs[1][1])

    def cls_only(module, args, out):
        x, hiddens = out
        return x + torch.nn.functional.pad(torch.ones_like(x[:, :1]),
                                           (0, 0, 0, x.shape[1] - 1)), hiddens

    handle = tm.backbone.register_forward_hook(cls_only)
    try:
        with torch.no_grad():
            cls_moved = tm(_t(img), _t(mask))
    finally:
        handle.remove()
    assert torch.equal(cls_moved[1], base[1])
    assert torch.equal(cls_moved[0], base[0])  # the patches' logits too


@pytest.mark.parametrize("name", ["vqkd", "cls", "dvae", "dalle"])
def test_models_build_on_the_device_asked(name):
    """Every parameter and buffer on the `device` the constructor was
    given (the meta device: no memory), none left on the CPU."""
    make = {"vqkd": lambda d: tb2.VQKD(tb2.VQKDConfig(**VQKD_KW), device=d),
            "cls": lambda d: tb2.BEiT2ForMaskedImageModelingCLS(
                tb2.Beit2PretrainConfig(**CLS_KW), device=d),
            "dvae": lambda d: tb2.DiscreteVAE(64, 8, 16, 2, device=d),
            "dalle": lambda d: tdv.DalleEncoder(
                tdv.DalleEncoderConfig(**DALLE_KW), device=d)}[name]
    m = make("meta")
    assert {t.device.type for t in [*m.parameters(), *m.buffers()]} == {
        "meta"}
