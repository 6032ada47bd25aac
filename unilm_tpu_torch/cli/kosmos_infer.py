"""Kosmos-2.5 image -> OCR / markdown generation (port of
unilm_tpu/cli/kosmos_infer.py: `build_prompt` :30, `postprocess_ocr` :39,
`main` :51, `build_pipeline` :89).

    python -m unilm_tpu_torch.cli.kosmos_infer --image doc.png --task md \\
        --checkpoint ckpt.pt --max_new_tokens 1024 [--int8] [--beam 5]

The prompt is <s><image> (num_image_tokens placeholders) </image><ocr>|<md>;
the image becomes Pix2Struct patches, the tower and resampler's features
are spliced into the prefill, then greedy or beam decode
(runtime.generate), and the ids are detokenized with tiktoken's
cl100k_base and post-processed. `--checkpoint` takes a fairseq Kosmos-2.5
.pt (convert/kosmos.py); without one the weights are random (seed 0).
The model runs on the card (`--device cuda`, the default, which raises on
a host without one) unless `--device cpu` asks for the CPU.

`--int8` quantizes the decoder's layer projections and the LM head
(per-channel int8) and keeps the KV pool in int8, as the JAX CLI's
`--int8` does; the tower and the connector stay in full precision
(`ops.quant.is_decoder_projection`: the JAX CLI's predicate also selects
the tower's projections and its `--int8` then fails on an image).
`--no_scan` keeps the KV pool in the model dtype, as the JAX CLI's looped
stack does; the port has one decoder form, which computes what the
scanned stack computes.

`build_pipeline(args)` loads the model once and returns a
`KosmosPipeline`: `infer_patches(patches)` gives the generated ids from
flattened patches (no PIL, no tiktoken), and calling it with an image
path reads the image and gives the text. Without tiktoken, or without
cl100k_base in tiktoken's cache (this CLI never downloads it), the text
is the ids, space-separated, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import re

import numpy as np
import torch

from unilm_tpu_torch.convert.from_jax import flax_to_state_dict
from unilm_tpu_torch.convert.kosmos import convert_unigpt
from unilm_tpu_torch.data.vl_loaders import cl100k_if_cached as _cl100k
from unilm_tpu_torch.models.kosmos import (
    Pix2StructVisionConfig, UniGPT, kosmos2_5, make_unigpt_generate_fns,
    quantize_lm_head_state_dict)
from unilm_tpu_torch.ops.quant import quantize_state_dict
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.generate import GenerationConfig, generate

# special ids of kosmos-2.5's inference.py (a dictionary built from
# tiktoken cl100k_base with the specials first, in fairseq's order)
BOS, PAD, EOS, UNK = 0, 1, 2, 3
TIKTOKEN_OFFSET = 4  # dictionary id = tiktoken id + offset


def build_prompt(task: str, num_image_tokens: int, image_id: int,
                 image_end_id: int, task_id: int):
    """<s> <image> [placeholders] </image> <task>: (ids, image mask,
    segment ids), numpy."""
    ids = [BOS, image_id] + [PAD] * num_image_tokens + [image_end_id, task_id]
    mask = [False, False] + [True] * num_image_tokens + [False, False]
    segs = [0, 1] + [1] * num_image_tokens + [1, 0]
    return np.asarray(ids), np.asarray(mask), np.asarray(segs)


def postprocess_ocr(text: str):
    """Parse '<bbox><x_..><y_..><x_..><y_..></bbox> text' records."""
    out = []
    for m in re.finditer(
            r"<bbox><x_(\d+)><y_(\d+)><x_(\d+)><y_(\d+)></bbox>([^<]*)", text):
        x0, y0, x1, y1 = map(int, m.groups()[:4])
        out.append({"bbox": [x0, y0, x1, y1], "text": m.group(5).strip()})
    return out


def detokenize(ids) -> str:
    enc = _cl100k()
    if enc is None:
        return " ".join(map(str, ids))
    return enc.decode([t - TIKTOKEN_OFFSET for t in ids
                       if t >= TIKTOKEN_OFFSET])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Kosmos-2.5 inference (PyTorch/CUDA)")
    p.add_argument("--image", required=True)
    p.add_argument("--task", choices=["ocr", "md"], default="md")
    p.add_argument("--checkpoint", default="", help="fairseq kosmos-2.5 .pt")
    p.add_argument("--max_new_tokens", type=int, default=1024)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--int8", action="store_true",
                   help="int8 decoder projections + LM head + KV pool")
    p.add_argument("--max_patches", type=int, default=4096)
    p.add_argument("--num_image_tokens", type=int, default=2048)
    p.add_argument("--image_id", type=int, default=100283)
    p.add_argument("--image_end_id", type=int, default=100284)
    p.add_argument("--ocr_id", type=int, default=100288)
    p.add_argument("--md_id", type=int, default=100289)
    p.add_argument("--no_scan", action="store_true",
                   help="keep the KV pool in the model dtype under --int8 "
                        "(the JAX CLI's looped stack)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="reduced dims (converter tests / smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    infer = build_pipeline(args)
    text = infer(args.image)
    if args.task == "ocr":
        for rec in postprocess_ocr(text):
            print(rec)
    else:
        print(text)


class KosmosPipeline:
    """A loaded model and its prompt (see `build_pipeline`)."""

    def __init__(self, model: UniGPT, gcfg: GenerationConfig, prompt,
                 cache_size: int, max_patches: int, dtype, device):
        self.model, self.gcfg = model, gcfg
        ids, mask, segs = (torch.as_tensor(a, device=device)[None]
                           for a in prompt)
        self.tokens, self.img_mask, self.segs = ids.long(), mask, segs.long()
        self.cache_size, self.max_patches = cache_size, max_patches
        self.dtype, self.device = dtype, device
        self.prefill, self.step = make_unigpt_generate_fns(model, cache_size)

    @torch.no_grad()
    def generate(self, patches):
        """generate()'s output for flattened patches [N, 2 + patch_dim]
        (or [1, N, ...]): (tokens [1, total], lengths) under greedy,
        (tokens [1, K, total], scores [1, K]) under beam."""
        patches = torch.as_tensor(patches).to(self.device, self.dtype)
        if patches.ndim == 2:
            patches = patches[None]
        feats = self.model.encode_image(patches)
        return generate(self.gcfg, self.prefill, self.step, self.tokens,
                        aux=(feats, self.img_mask, self.segs))

    def infer_patches(self, patches) -> list:
        """The generated ids (the best beam), pad and eos left out."""
        out, _ = self.generate(patches)
        seq = out[0, 0] if out.ndim == 3 else out[0]
        return [t for t in seq[self.tokens.shape[1]:].tolist()
                if t not in (PAD, EOS)]

    def __call__(self, image_path: str) -> str:
        from PIL import Image

        from unilm_tpu_torch.data.transforms import (pix2struct_patches,
                                                     to_numpy)

        img = to_numpy(Image.open(image_path))
        return detokenize(self.infer_patches(
            pix2struct_patches(img, max_patches=self.max_patches)))


def build_pipeline(args) -> KosmosPipeline:
    """Load the model and checkpoint once (the JAX `build_pipeline`)."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    dtype = (torch.float32 if args.fp32 else
             torch.bfloat16 if args.bf16 else torch.float32)
    cfg = kosmos2_5(dtype=dtype, latent_query_num=args.num_image_tokens)
    if args.tiny:
        cfg = dataclasses.replace(
            cfg, embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
            vocab_size=2048, max_positions=4096 + 64, use_flash=False,
            pix2struct=Pix2StructVisionConfig(
                hidden_size=32, num_layers=1, num_heads=2, d_ff=64, d_kv=16,
                patch_dim=768, max_rows=4096, use_flash=False, dtype=dtype))
    task_id = args.ocr_id if args.task == "ocr" else args.md_id
    prompt = build_prompt(args.task, args.num_image_tokens, args.image_id,
                          args.image_end_id, task_id)

    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        sd = flax_to_state_dict(convert_unigpt(sd, cfg))
    else:
        print("WARNING: no checkpoint given; running with random weights")
        sd = UniGPT(cfg, device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(0)).state_dict()
    if not args.no_scan:
        cfg = dataclasses.replace(cfg, scan_layers=True)
    if args.int8:
        sd = quantize_lm_head_state_dict(quantize_state_dict(sd))
        cfg = dataclasses.replace(
            cfg, quant_weights=True, quant_lm_head=True,
            kv_cache_dtype="int8" if cfg.scan_layers else cfg.kv_cache_dtype)
    model = UniGPT(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    del sd
    model.eval()
    gcfg = GenerationConfig(beam_size=args.beam,
                            max_new_tokens=args.max_new_tokens, pad=PAD,
                            eos=EOS, vocab_size=cfg.vocab_size)
    return KosmosPipeline(model, gcfg, prompt,
                          len(prompt[0]) + args.max_new_tokens,
                          args.max_patches, dtype, dev)


if __name__ == "__main__":
    main()
