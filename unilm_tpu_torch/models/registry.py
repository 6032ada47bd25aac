"""Model and architecture registry (port of unilm_tpu/models/registry.py).

One place that maps architecture names to (config factory, model class),
so that user code builds any model by name:

    cfg, model = registry.build("beit3_base", num_classes=10)

`names()` is the JAX registry's list. `build` constructs every
architecture the port has: the BEiT / DiT presets, `beit3_*`,
`layoutlm_base`, `layoutlmv2_base`, `layoutlmv3_*`, `markuplm_base`,
`trocr_*`, `kosmos2*` and `yoco_base`. A name whose model
is not ported yet raises NotImplementedError naming its ROADMAP Queue 1
item. Like the port's other entry points, `build` puts the model on the
card unless the caller asks for another device (runtime/device.py);
`device="meta"` builds the module tree without memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from unilm_tpu_torch.runtime.device import resolve_device

_ARCHS: Dict[str, Tuple[Callable, Any]] = {}
_PENDING: Dict[str, str] = {}  # name -> the ROADMAP item that ports it


def register(name: str, config_fn: Callable, model_cls) -> None:
    if name in _ARCHS or name in _PENDING:
        raise ValueError(f"duplicate arch {name!r}")
    _ARCHS[name] = (config_fn, model_cls)


def _pending(item: str, *archs: str) -> None:
    for name in archs:
        if name in _ARCHS or name in _PENDING:
            raise ValueError(f"duplicate arch {name!r}")
        _PENDING[name] = item


def names():
    return sorted([*_ARCHS, *_PENDING])


def build(name: str, device="cuda", **config_overrides):
    """Returns (config, model) for architecture `name`, the model's
    parameters on `device` (not initialised: each model's
    `init_weights(generator)` or a checkpoint fills them)."""
    if name in _PENDING:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet: ROADMAP Queue 1 "
            f"{_PENDING[name]}")
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

    _pending("item 10 (the rest, slice 10)", "retnet_base", "retnet_medium",
             "xlmt_base", "xlmt_big", "diff_transformer_base",
             "unilm_seq2seq_base", "wavlm_base", "e5_base")


_populate()
