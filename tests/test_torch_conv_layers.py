"""core/layers.py's strided "SAME" `ConvNHWC` and the kernel != stride
`ConvTransposeNHWC` against flax `nn.Conv` / `nn.ConvTranspose`, and
convert/from_jax.py's layout of 4-D kernels taken from the destination
module's type: the σ-VAE's `dec_{i}` load flipped, while the detection /
segmentation trees convert as they did by module name.

Float32 on both sides, inputs from numpy seeds; outputs 1e-5 abs + rel,
converted tensors equal.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rcnn import draw, port_cfg
from unilm_tpu.models import latentlm as jl
from unilm_tpu_torch.convert.from_jax import (conv_transpose_paths,
                                              flax_to_state_dict,
                                              load_flax_params)
from unilm_tpu_torch.core.layers import (ConvNHWC, ConvTransposeNHWC,
                                         conv_transpose_padding,
                                         same_padding)
from unilm_tpu_torch.models import latentlm as tl

from test_torch_seq2seq import close, t

torch.set_num_threads(1)


def _load(port, params):
    sd = flax_to_state_dict({"m": params},
                            conv_transpose={"m"} if isinstance(
                                port, ConvTransposeNHWC) else set())
    port.load_state_dict({k[2:]: v for k, v in sd.items()})


@pytest.mark.parametrize("n", [7, 8, 15, 16])
@pytest.mark.parametrize("k,s", [(3, 2), (4, 2), (4, 1), (3, 1), (1, 1)])
def test_conv_same_matches_flax(n, k, s):
    x = np.random.RandomState(n * 10 + k).randn(2, n, n + 1, 3).astype(
        np.float32)
    mod = nn.Conv(5, (k, k), strides=(s, s), padding="SAME")
    p = draw(mod, jnp.asarray(x), seed=k + s)
    port = ConvNHWC(3, 5, k, stride=s)
    _load(port, p)
    with torch.no_grad():
        got = port(t(x))
    want = mod.apply({"params": p}, jnp.asarray(x))
    assert got.shape == want.shape
    close(got, want, 1e-5)


@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("k,s", [(4, 2), (3, 2), (2, 2), (4, 4), (3, 1),
                                 (2, 3)])
def test_conv_transpose_same_matches_flax(n, k, s):
    x = np.random.RandomState(n + k).randn(2, n, n + 2, 4).astype(np.float32)
    mod = nn.ConvTranspose(6, (k, k), strides=(s, s), padding="SAME")
    p = draw(mod, jnp.asarray(x), seed=k * s)
    port = ConvTransposeNHWC(4, 6, k, stride=s)
    _load(port, p)
    with torch.no_grad():
        got = port(t(x))
    want = mod.apply({"params": p}, jnp.asarray(x))
    assert got.shape == want.shape == (2, n * s, (n + 2) * s, 6)
    close(got, want, 1e-5)


def test_padding_rules():
    # a 3x3 stride-2 conv over an even side pads (0, 1), not (1, 1)
    assert same_padding(16, 3, 2) == (0, 1)
    assert same_padding(15, 3, 2) == (1, 1)
    assert same_padding(16, 4, 2) == (1, 1)
    # a 4x4 stride-2 transpose: flax pads the dilated input (2, 2), which
    # is torch's padding 1; kernel == stride pads (k - 1, k - 1): padding 0
    assert conv_transpose_padding(4, 2) == (2, 2)
    assert ConvTransposeNHWC(1, 1, 4, stride=2).padding == (1, 1)
    assert ConvTransposeNHWC(1, 1, 2).padding == (0, 0)


def test_sigma_vae_deconvs_load_flipped_by_type():
    cfg = dict(latent_dim=4, channels=(8, 16), sigma=0.1)
    jv = jl.SigmaVAE(jl.SigmaVAEConfig(**cfg))
    imgs = np.random.RandomState(0).randn(1, 16, 16, 3).astype(np.float32)
    params = draw(jv, jnp.asarray(imgs), jax.random.PRNGKey(0))
    tv = tl.SigmaVAE(tl.SigmaVAEConfig(**cfg), device="cpu")
    assert conv_transpose_paths(tv) == {"dec_0", "dec_1"}
    load_flax_params(tv, params)
    for i in range(2):
        k = params[f"dec_{i}"]["kernel"]
        flipped = np.transpose(k, (2, 3, 0, 1))[..., ::-1, ::-1]
        np.testing.assert_array_equal(
            getattr(tv, f"dec_{i}").weight.detach().numpy(), flipped)
    # without the model the name `dec_i` is no ConvTranspose's
    byname = flax_to_state_dict(params)
    assert byname["dec_1.weight"].shape == (8, 16, 4, 4)
    assert not np.array_equal(byname["dec_1.weight"].numpy(),
                              tv.dec_1.weight.detach().numpy())
    z = np.random.RandomState(1).randn(1, 4, 4, 4).astype(np.float32)
    with torch.no_grad():
        close(tv.decode(t(z)), jv.apply({"params": params}, jnp.asarray(z),
                                        method=jv.decode), 1e-5)


def _trees():
    """(port model, flax tree) of the tiny rcnn, FCOS and UperNet."""
    from test_detection import tiny_cfg as fcos_cfg
    from test_rcnn import tiny_cfg as rcnn_cfg
    from unilm_tpu.models import detection_head as jdh
    from unilm_tpu.models import rcnn as jr
    from unilm_tpu.models import segmentation as jseg
    from unilm_tpu.models.beit import BeitConfig
    from unilm_tpu_torch.models import detection_head as tdh
    from unilm_tpu_torch.models import rcnn as tr
    from unilm_tpu_torch.models import segmentation as tseg

    x = jnp.zeros((1, 64, 64, 3))
    seg = jseg.UperNetConfig(
        beit=BeitConfig(img_size=64, embed_dim=32, num_layers=4,
                        num_heads=2, ffn_dim=64, use_mean_pooling=False),
        num_classes=5, out_indices=(0, 1, 2, 3), channels=32,
        aux_channels=16)
    out = []
    for jcls, tcls, cfg in ((jr.CascadeRCNN, tr.CascadeRCNN, rcnn_cfg()),
                            (jdh.FCOSDetector, tdh.FCOSDetector, fcos_cfg()),
                            (jseg.BeitForSemanticSegmentation,
                             tseg.BeitForSemanticSegmentation, seg)):
        out.append((tcls(port_cfg(cfg), device="meta"),
                    draw(jcls(cfg), x)))
    return out


def test_detection_trees_convert_as_before():
    """The type rule and the name rule agree on every tree that has
    ConvTranspose modules (the adapters, the mask head's deconv)."""
    for model, params in _trees():
        paths = conv_transpose_paths(model)
        assert paths
        a = flax_to_state_dict(params)
        b = flax_to_state_dict(params, conv_transpose=paths)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
