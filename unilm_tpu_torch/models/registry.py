"""Model and architecture registry (port of unilm_tpu/models/registry.py).

One place that maps architecture names to (config factory, model class),
so that user code builds any model by name:

    cfg, model = registry.build("beit3_base", num_classes=10)

`names()` is the JAX registry's list, and `build` constructs every one of
its architectures: the BEiT / DiT presets, `beit3_*`, `layoutlm_base`,
`layoutlmv2_base`, `layoutlmv3_*`, `markuplm_base`, `trocr_*`,
`kosmos2*`, `yoco_base`, `retnet_*`, `xlmt_*`, `diff_transformer_base`,
`unilm_seq2seq_base`, `wavlm_base` and `e5_base`. Like the port's other
entry points, `build` puts the model on the card unless the caller asks
for another device (runtime/device.py); `device="meta"` builds the
module tree without memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from unilm_tpu_torch.runtime.device import resolve_device

_ARCHS: Dict[str, Tuple[Callable, Any]] = {}


def register(name: str, config_fn: Callable, model_cls) -> None:
    if name in _ARCHS:
        raise ValueError(f"duplicate arch {name!r}")
    _ARCHS[name] = (config_fn, model_cls)


def names():
    return sorted(_ARCHS)


def build(name: str, device="cuda", **config_overrides):
    """Returns (config, model) for architecture `name`, the model's
    parameters on `device` (not initialised: each model's
    `init_weights(generator)` or a checkpoint fills them)."""
    if name not in _ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {names()}")
    config_fn, model_cls = _ARCHS[name]
    cfg = config_fn(**config_overrides)
    return cfg, model_cls(cfg, device=resolve_device(device))


def _populate():
    from unilm_tpu_torch.models import beit as B
    from unilm_tpu_torch.models import beit3 as B3
    from unilm_tpu_torch.models import kosmos as K
    from unilm_tpu_torch.models import layoutlm as L1
    from unilm_tpu_torch.models import layoutlmv2 as L2
    from unilm_tpu_torch.models import layoutlmv3 as L3
    from unilm_tpu_torch.models import markuplm as M
    from unilm_tpu_torch.models import trocr as T
    from unilm_tpu_torch.models import yoco as Y
    from unilm_tpu_torch.models import retnet as RN
    from unilm_tpu_torch.models import translation as XT
    from unilm_tpu_torch.models.diff_transformer import (
        DiffTransformerConfig, DiffTransformerLM)
    from unilm_tpu_torch.models.retrieval import (EmbeddingModel,
                                                  TextEncoderConfig)
    from unilm_tpu_torch.models.unilm_s2s import UniLMConfig, UniLMForSeq2Seq
    from unilm_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

    for n in ("beit_base_patch16_224", "beit_base_patch16_384",
              "beit_large_patch16_224", "beit_large_patch16_384",
              "beit_large_patch16_512", "dit_base_patch16_224",
              "dit_large_patch16_224"):
        register(n, getattr(B, n), B.BeitForImageClassification)

    register("beit3_base", B3.beit3_base, B3.BEiT3ForImageClassification)
    register("beit3_large", B3.beit3_large, B3.BEiT3ForImageClassification)

    register("layoutlm_base", L1.LayoutLMConfig,
             L1.LayoutLMForTokenClassification)
    register("layoutlmv2_base", L2.LayoutLMv2Config,
             L2.LayoutLMv2ForTokenClassification)
    register("layoutlmv3_base", L3.layoutlmv3_base,
             L3.LayoutLMv3ForTokenClassification)
    register("layoutlmv3_large", L3.layoutlmv3_large,
             L3.LayoutLMv3ForTokenClassification)
    register("markuplm_base", M.MarkupLMConfig,
             M.MarkupLMForTokenClassification)

    register("trocr_small", T.trocr_small, T.TrOCRModel)
    register("trocr_base", T.trocr_base, T.TrOCRModel)
    register("trocr_large", T.trocr_large, T.TrOCRModel)

    register("kosmos2", K.kosmos2, K.UniGPT)
    register("kosmos2_5", K.kosmos2_5, K.UniGPT)

    register("yoco_base", Y.YOCOConfig, Y.YOCO)
    register("retnet_base", RN.retnet_base, RN.RetNetDecoder)
    register("retnet_medium", RN.retnet_medium, RN.RetNetDecoder)
    register("xlmt_base", XT.xlmt_base, XT.MultilingualTranslationModel)
    register("xlmt_big", XT.xlmt_big, XT.MultilingualTranslationModel)
    register("diff_transformer_base", DiffTransformerConfig,
             DiffTransformerLM)
    register("unilm_seq2seq_base", UniLMConfig, UniLMForSeq2Seq)
    register("wavlm_base", WavLMConfig, WavLMModel)
    register("e5_base", TextEncoderConfig, EmbeddingModel)


_populate()
