"""TrOCR image-to-text inference with beam search (port of
unilm_tpu/cli/trocr_infer.py: `preprocess` :34, `main` :41).

    python -m unilm_tpu_torch.cli.trocr_infer --image line.png \\
        --checkpoint trocr-base-handwritten.pt --tokenizer ./tokenizer \\
        --beam 5 --max_new_tokens 128 [--int8] [--bf16]

One image or a folder of images: each is resized to the encoder's square,
normalized, encoded, and decoded from `--bos` (runtime.generate; beam
search for --beam > 1). A line per image: its file name, the best beam's
score and its text, detokenized by an HF tokenizer directory
(`--tokenizer`, `transformers` imported only then) or printed as ids.
`--checkpoint` takes an HF VisionEncoderDecoder state dict
(convert/trocr.py); without one the weights are random (seed 0). The
model runs on the card (`--device cuda`, the default, which raises on a
host without one) unless `--device cpu` asks for the CPU.

`--int8` quantizes the text decoder's projections and its head
(`models.trocr.quantize_trocr_decoder_state_dict`; #14 on the card).
`--no_scan` is accepted and changes nothing: it picks the JAX
package's looped stack there, while the port has one stack, which
computes what both JAX stacks compute. `--bf16` runs the model in
bfloat16 (benchmarks/trocr_decode.py's dtype); the JAX CLI runs float32.

`build_pipeline(args)` loads the model once and returns a
`TrOCRPipeline`: `infer_images(images)` gives the generated ids of
preprocessed images [B, H, W, 3] (no PIL, no `transformers`),
`generate(images)` generate()'s raw output, and calling it with an image
path gives (score, ids).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from unilm_tpu_torch.convert.trocr import convert_trocr
from unilm_tpu_torch.models import trocr as trocr_models
from unilm_tpu_torch.models.trocr import (TrOCRModel, make_generate_fns,
                                          quantize_trocr_decoder_state_dict)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.generate import GenerationConfig, generate


def preprocess(path: str, img_size: int) -> np.ndarray:
    """An image file -> [img_size, img_size, 3] float32, bicubic resize,
    normalized to [-1, 1] (the Inception mean and std)."""
    from PIL import Image

    from unilm_tpu_torch.data.transforms import (
        IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD, normalize, resize,
        to_numpy)

    img = resize(Image.open(path).convert("RGB"), (img_size, img_size),
                 "bicubic")
    return normalize(to_numpy(img), IMAGENET_INCEPTION_MEAN,
                     IMAGENET_INCEPTION_STD)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("TrOCR inference (PyTorch/CUDA)")
    p.add_argument("--image", required=True, help="image file or directory")
    p.add_argument("--checkpoint", default="",
                   help="HF VisionEncoderDecoder .pt/.bin")
    p.add_argument("--arch", default="trocr_base")
    p.add_argument("--tokenizer", default="", help="HF tokenizer dir")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--len_penalty", type=float, default=1.0)
    p.add_argument("--bos", type=int, default=2)
    p.add_argument("--eos", type=int, default=2)
    p.add_argument("--pad", type=int, default=1)
    p.add_argument("--no_scan", action="store_true",
                   help="the JAX CLI's looped stack; the port has one stack")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only decoder projections + head")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (default float32, as JAX's CLI)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


class TrOCRPipeline:
    """A loaded model and its search (see `build_pipeline`)."""

    def __init__(self, model: TrOCRModel, gcfg: GenerationConfig, bos: int,
                 cache_size: int, dtype, device):
        self.model, self.gcfg, self.bos = model, gcfg, bos
        self.cache_size, self.dtype, self.device = cache_size, dtype, device
        self.prefill, self.step = make_generate_fns(model, cache_size)

    @torch.no_grad()
    def generate(self, images):
        """generate()'s output for preprocessed images [B, H, W, 3] (or
        one [H, W, 3]): (tokens [B, total], lengths) under greedy,
        (tokens [B, K, total], scores [B, K]) under beam."""
        images = torch.as_tensor(images).to(self.device, self.dtype)
        if images.ndim == 3:
            images = images[None]
        enc = self.model.encode(images)
        prompt = torch.full((images.shape[0], 1), self.bos,
                            dtype=torch.long, device=self.device)
        return generate(self.gcfg, self.prefill, self.step, prompt, aux=enc)

    def infer_images(self, images) -> list:
        """(score, ids) per image: the best beam (score 0.0 under greedy),
        the bos left out, pad and eos dropped."""
        out, scores = self.generate(images)
        best = out[:, 0] if out.ndim == 3 else out
        drop = (self.gcfg.pad, self.gcfg.eos)
        return [(float(scores[b, 0]) if out.ndim == 3 else 0.0,
                 [t for t in best[b, 1:].tolist() if t not in drop])
                for b in range(best.shape[0])]

    def __call__(self, path: str):
        img_size = self.model.cfg.img_size
        return self.infer_images(preprocess(path, img_size)[None])[0]


def build_pipeline(args) -> TrOCRPipeline:
    """Load the model and checkpoint once (the JAX `main`'s setup)."""
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = getattr(trocr_models, args.arch)(dtype=dtype)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        sd = convert_trocr(sd, cfg)
    else:
        print("WARNING: no checkpoint given; running with random weights")
        sd = TrOCRModel(cfg, device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(0)).state_dict()
    if args.int8:
        sd = quantize_trocr_decoder_state_dict(sd)
        cfg = dataclasses.replace(cfg, quant_weights=True)
    model = TrOCRModel(cfg, device=dev)
    model.load_state_dict(sd, strict=True)
    del sd
    model.eval()
    gcfg = GenerationConfig(beam_size=args.beam,
                            max_new_tokens=args.max_new_tokens,
                            len_penalty=args.len_penalty, pad=args.pad,
                            eos=args.eos, vocab_size=cfg.vocab_size)
    return TrOCRPipeline(model, gcfg, args.bos, 1 + args.max_new_tokens,
                         dtype, dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    pipe = build_pipeline(args)
    paths = ([args.image] if os.path.isfile(args.image) else
             [os.path.join(args.image, f) for f in sorted(os.listdir(
                 args.image))])
    tok = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer)
    for path in paths:
        score, ids = pipe(path)
        text = tok.decode(ids, skip_special_tokens=True) if tok else str(ids)
        print(f"{os.path.basename(path)}\t{score:.3f}\t{text}")


if __name__ == "__main__":
    main()
