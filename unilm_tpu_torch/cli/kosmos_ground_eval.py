"""Kosmos-2 grounding evaluation: Flickr30k Entities R@k and RefCOCO
accuracy (port of unilm_tpu/cli/kosmos_ground_eval.py).

    python -m unilm_tpu_torch.cli.kosmos_ground_eval --task refcoco \\
        --data refs.jsonl --device cpu
    python -m unilm_tpu_torch.cli.kosmos_ground_eval --task flickr \\
        --data flickr.jsonl --kosmos2

Generates grounded markup from an image prompt, parses
`<phrase>..</phrase><object><patch_index_..>..</object>` back into
phrase/box pairs and scores them against the ground truth; prints one
JSON line of the metrics.

Fixture formats (jsonl):
  flickr:  {"image": str|null, "caption": str,
            "phrases": [{"phrase": str, "boxes": [[x0,y0,x1,y1] norm..]}]}
  refcoco: {"image": str|null, "expression": str, "box": [x0,y0,x1,y1] norm}
A missing image file reads as a pseudo-image seeded from the record.

Modes:
  --oracle   score markup made from the ground truth through the parse +
             metric path (a harness self-check: R@1 = accuracy = 1.0)
  (default)  greedy generation by a UniGPT with the CLIP tower and random
             weights from --seed: the JAX CLI's small geometry (--dim,
             --layers, --heads, --clip_dim) in float32, or with
             --kosmos2 the kosmos2() preset at full width in bf16 (224
             px, 64 latent queries);
             prompt = <s> [<pad> fill] <image> Q slots </image>
             <grounding> (+ <phrase>expr</phrase> for refcoco).
The vocabulary is data/vl_loaders.VLTokenizer's (cl100k_base if cached,
else bytes). Under --kosmos2 the model has 65037 ids (cl100k_base's do
not fit and raise) and the byte tokenizer 1293, so the ids it generates
past the tokenizer's render as meaningless markup (off-grid
`<patch_index_..>`s): the output means nothing until the Kosmos-2
sentencepiece tokenizer (data/spm.py, ROADMAP Queue 1 item 8) and real
weights are at hand. The model runs on the card (`--device cuda`, the
default, which raises on a host without one) unless `--device cpu` asks
for the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Sequence

import numpy as np
import torch

from unilm_tpu_torch.data.grounding import box_tokens
from unilm_tpu_torch.data.vl_loaders import VLTokenizer, load_image
from unilm_tpu_torch.models.kosmos import (ClipVisionConfig, UniGPT,
                                           UniGPTConfig, kosmos2,
                                           make_unigpt_generate_fns)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.generate import GenerationConfig, generate
from unilm_tpu_torch.scoring_grounding import (grounded_text_to_predictions,
                                               phrase_grounding_recall,
                                               refexp_accuracy)


def oracle_markup_flickr(rec, quantized_size):
    parts = []
    for p in rec["phrases"]:
        inner = "</delimiter_of_multi_objects/>".join(
            box_tokens(tuple(b), quantized_size)[len("<object>"):
                                                 -len("</object>")]
            for b in p["boxes"])
        parts.append(f"<phrase>{p['phrase']}</phrase><object>{inner}</object>")
    return " ".join(parts)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model flags the three Kosmos-2 CLIs share."""
    p.add_argument("--image_root", default="")
    p.add_argument("--image_tokens", type=int, default=16)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--max_len", type=int, default=256)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--clip_dim", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kosmos2", action="store_true",
                   help="the kosmos2() preset at full width in bf16 "
                        "(ViT-L/14 at 224, 64 latent queries, 24 x 2048 "
                        "decoder; sets --image_size and --image_tokens) "
                        "instead of the small float32 geometry")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")


def model_config(args, tok: VLTokenizer) -> UniGPTConfig:
    """The CLIs' UniGPT config (segment embeddings on): the small geometry
    in float32, or with --kosmos2 the preset in bf16, which sets
    args.image_size / args.image_tokens to the preset's."""
    if args.kosmos2:
        cfg = kosmos2(dtype=torch.bfloat16, segment_emb=True)
        if tok.vocab_size > cfg.vocab_size:
            raise ValueError(f"the tokenizer's {tok.vocab_size} ids do not "
                             f"fit kosmos2()'s vocab of {cfg.vocab_size}")
        args.image_size = cfg.clip.img_size
        args.image_tokens = cfg.latent_query_num
        return cfg
    clip = ClipVisionConfig(
        img_size=args.image_size, embed_dim=args.clip_dim, num_layers=1,
        num_heads=max(2, args.clip_dim // 32), ffn_dim=args.clip_dim * 2)
    return UniGPTConfig(
        vocab_size=tok.vocab_size, embed_dim=args.dim, num_layers=args.layers,
        num_heads=args.heads, ffn_dim=args.dim * 4,
        max_positions=args.max_len + 8, image_tower="clip",
        latent_query_num=args.image_tokens, clip=clip, segment_emb=True)


def build_model(args, tok: VLTokenizer) -> UniGPT:
    """The UniGPT of `model_config` on --device, random weights from
    --seed."""
    dev = resolve_device(args.device)
    model = UniGPT(model_config(args, tok), device=dev).eval()
    return model.init_weights(torch.Generator(device=dev).manual_seed(
        args.seed))


def build_prompts(args, tok: VLTokenizer, records, prefixes):
    """The generation prompts, numpy: tokens [B, P] int64, img_mask [B, P]
    bool, segs [B, P] int64, images [B, S, S, 3] float32. A prefix
    shorter than the longest is left-filled with <pad> before <image>
    (the reference's layout; the prefill masks no key)."""
    bos, pad = tok.token("<s>"), tok.token("<pad>")
    boi, eoi = tok.token("<image>"), tok.token("</image>")
    ground = tok.token("<grounding>")
    Q = args.image_tokens
    prompts, masks, segs_all, imgs = [], [], [], []
    max_prefix = max((len(p) for p in prefixes), default=0)
    for rec, prefix in zip(records, prefixes):
        fill = [pad] * (max_prefix - len(prefix))
        ids = [bos] + fill + [boi] + [pad] * Q + [eoi, ground] + list(prefix)
        mask = ([False] * (1 + len(fill)) + [False] + [True] * Q
                + [False, False] + [False] * len(prefix))
        seg = [0] * (1 + len(fill)) + [1] * (Q + 2) + [0] * len(prefix)
        prompts.append(ids)
        masks.append(mask)
        segs_all.append(seg + [0] * (len(ids) - len(seg)))
        imgs.append(load_image(rec.get("image"), args.image_root,
                               args.image_size, key=json.dumps(rec)[:64]))
    P = len(prompts[0])
    return (np.asarray(prompts, np.int64), np.asarray(masks, bool),
            np.asarray([s[:P] for s in segs_all], np.int64), np.stack(imgs))


def generate_ids(model: UniGPT, tok: VLTokenizer, prompts,
                 max_new_tokens: int, min_new_tokens: int = 1
                 ) -> torch.Tensor:
    """Greedy generation from `build_prompts`' arrays: encode the images,
    prefill, decode (</s> banned before `min_new_tokens`). Returns tokens
    [B, P + max_new_tokens] (pad after </s>)."""
    dev = next(model.parameters()).device
    tokens, img_mask, segs, images = (torch.from_numpy(a).to(dev)
                                      for a in prompts)
    with torch.no_grad():
        img_feats = model.encode_image(images)
    cache_size = tokens.shape[1] + max_new_tokens
    prefill, step = make_unigpt_generate_fns(model, cache_size=cache_size)
    gcfg = GenerationConfig(beam_size=1, max_new_tokens=max_new_tokens,
                            min_new_tokens=min_new_tokens,
                            pad=tok.token("<pad>"), eos=tok.token("</s>"),
                            vocab_size=model.cfg.vocab_size)
    out, _ = generate(gcfg, prefill, step, tokens,
                      aux=(img_feats, img_mask, segs))
    return out


def decode_generated(tok: VLTokenizer, out: torch.Tensor, P: int
                     ) -> List[str]:
    """The markup of each row's generated ids (pad and </s> dropped)."""
    drop = (tok.token("<pad>"), tok.token("</s>"))
    return [tok.decode([int(t) for t in row[P:] if int(t) not in drop])
            for row in out.cpu().numpy()]


def model_generate(args, tok: VLTokenizer, records, prefixes: Sequence,
                   model: UniGPT = None) -> List[str]:
    """Greedy-generate grounded markup for each record (the model of
    `build_model` unless one is given)."""
    model = model if model is not None else build_model(args, tok)
    prompts = build_prompts(args, tok, records, prefixes)
    out = generate_ids(model, tok, prompts, args.max_new_tokens)
    return decode_generated(tok, out, prompts[0].shape[1])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Kosmos-2 grounding eval")
    p.add_argument("--task", choices=["flickr", "refcoco"], required=True)
    p.add_argument("--data", required=True, help="fixtures jsonl")
    p.add_argument("--oracle", action="store_true")
    p.add_argument("--quantized_size", type=int, default=32)
    p.add_argument("--max_new_tokens", type=int, default=48)
    p.add_argument("--limit", type=int, default=0)
    add_model_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.data, encoding="utf-8") as f:
        records = [json.loads(l) for l in f if l.strip()]
    if args.limit:
        records = records[:args.limit]
    tok = VLTokenizer(quantized_size=args.quantized_size)

    if args.task == "flickr":
        gts = [[(p["phrase"], p["boxes"]) for p in rec["phrases"]]
               for rec in records]
        if args.oracle:
            texts = [oracle_markup_flickr(r, args.quantized_size)
                     for r in records]
        else:
            texts = model_generate(args, tok, records, [[]] * len(records))
        preds = [grounded_text_to_predictions(t, args.quantized_size)
                 for t in texts]
        result = phrase_grounding_recall(preds, gts)
    else:
        gt_boxes = [rec["box"] for rec in records]
        if args.oracle:
            texts = [f"<phrase>{r['expression']}</phrase>"
                     + box_tokens(tuple(r["box"]), args.quantized_size)
                     for r in records]
        else:
            prefixes = [tok.encode_grounded(
                f"<phrase>{r['expression']}</phrase>") for r in records]
            gen = model_generate(args, tok, records, prefixes)
            texts = [f"<phrase>{r['expression']}</phrase>" + g
                     for r, g in zip(records, gen)]
        pred_boxes = []
        for t in texts:
            ents = grounded_text_to_predictions(t, args.quantized_size)
            pred_boxes.append(ents[0][1][0] if ents and ents[0][1] else None)
        result = refexp_accuracy(pred_boxes, gt_boxes)

    print(json.dumps({k: round(float(v), 4) for k, v in result.items()}))
    return result


if __name__ == "__main__":
    main()
