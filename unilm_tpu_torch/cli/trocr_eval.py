"""TrOCR dataset evaluation: CER and WER over SROIE, IAM-style gt files or
synthetic lines (port of unilm_tpu/cli/trocr_eval.py `main` :38).

    python -m unilm_tpu_torch.cli.trocr_eval --synthetic --tiny --device cpu
    python -m unilm_tpu_torch.cli.trocr_eval --sroie /data/sroie_task2
    python -m unilm_tpu_torch.cli.trocr_eval --gt /data/iam/gt_test.txt
    python -m unilm_tpu_torch.cli.trocr_eval --gt gt.txt --spm unilm3.model

Loads a dataset (data/trocr_datasets.py), decodes every line image
greedily or with beam search, and prints {"cer", "wer", "n"} as one JSON
line. The target side is `CharTokenizer`, or with `--spm <model>` a
sentencepiece model through the native reader (data/spm.py), the
reference's `unilm3-cased` text path. `--checkpoint` takes an
HF VisionEncoderDecoder state dict (convert/trocr.py); without one the
weights are random from `--seed`. The model runs on the card (`--device
cuda`, the default, which raises on a host without one) unless `--device
cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from unilm_tpu_torch.convert.trocr import convert_trocr
from unilm_tpu_torch.data.trocr_datasets import (CharTokenizer, load_gt_file,
                                                 load_sroie, ocr_batches,
                                                 spm_tokenizer,
                                                 synthetic_ocr_dataset)
from unilm_tpu_torch.models.trocr import (TrOCRConfig, TrOCRModel,
                                          make_generate_fns)
from unilm_tpu_torch.runtime.device import resolve_device
from unilm_tpu_torch.runtime.generate import GenerationConfig, generate
from unilm_tpu_torch.scoring import cer, wer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sroie", help="SROIE task-2 root dir")
    p.add_argument("--gt", help="IAM/STR-style '<image>\\t<text>' gt file")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=8)
    p.add_argument("--img-size", type=int, default=384)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=24)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--spm", default="",
                   help="sentencepiece .model for the target side (native "
                        "reader, data/spm.py)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.synthetic:
        args.img_size = min(args.img_size, 64)
        data = synthetic_ocr_dataset(args.synthetic_n, args.img_size,
                                     args.seed)
    elif args.sroie:
        data = load_sroie(args.sroie, args.img_size)
    elif args.gt:
        data = load_gt_file(args.gt, img_size=args.img_size)
    else:
        p.error("one of --sroie/--gt/--synthetic required")
    if args.limit:
        data = data[:args.limit]

    tok = spm_tokenizer(args.spm) if args.spm else CharTokenizer()
    kw = dict(img_size=args.img_size, vocab_size=tok.vocab_size)
    if args.tiny:
        kw.update(enc_dim=32, enc_layers=1, enc_heads=2, enc_ffn=64,
                  dec_dim=32, dec_layers=1, dec_heads=2, dec_ffn=64,
                  patch_size=16, use_flash=False)
    cfg = TrOCRConfig(**kw)
    model = TrOCRModel(cfg, device=dev)
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        model.load_state_dict(convert_trocr(sd.get("model", sd), cfg),
                              strict=True)
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    model.eval()

    prefill, step = make_generate_fns(model, cache_size=2 + args.max_new_tokens)
    gcfg = GenerationConfig(beam_size=args.beam,
                            max_new_tokens=args.max_new_tokens, pad=tok.pad,
                            eos=tok.eos, vocab_size=tok.vocab_size)
    B = args.batch_size
    refs, hyps = [], []
    for batch in ocr_batches(data, tok, B, max_len=args.max_new_tokens):
        with torch.no_grad():
            enc = model.encode(torch.as_tensor(batch["images"], device=dev))
            prompt = torch.full((B, 1), tok.bos, dtype=torch.long,
                                device=dev)
            out, _ = generate(gcfg, prefill, step, prompt, aux=enc)
        rows = (out[:, 0] if out.ndim == 3 else out).tolist()
        for bi in range(B):
            ids = rows[bi][1:]
            if tok.eos in ids:
                ids = ids[:ids.index(tok.eos)]
            hyps.append(tok.decode(ids))
            # CharTokenizer is a lowercase charset; spm models keep case
            refs.append(batch["texts"][bi] if args.spm
                        else batch["texts"][bi].lower())

    result = {"cer": round(cer(refs, hyps), 4), "wer": round(wer(refs, hyps), 4),
              "n": len(refs)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
