"""Golden-number reproduction harness (port of
unilm_tpu/cli/reproduce_baseline.py: `GOLDEN` :43, `_run_cli` :67, the
`eval_*` loops :86-172, `_smoke_fixtures` :175, `main` :238).

Given a converted checkpoint and a dataset, runs the published evaluation
through the port's CLIs and asserts the reference's golden number within
its tolerance:

  config          metric      golden     reference log
  beit_large_eval Acc@1       87.396     beit/get_started_for_image_classification.md:83-116
  beit_base_eval  Acc@1       85.2       beit/README.md:72
  funsd           F1          0.9059     layoutlmv3/README.md:57
  trocr_iam       CER         3.42       trocr/README.md:17
  kosmos_ocr      word F1     71.6       kosmos-2.5/README.md:26 (Handwritten)

Usage:
  python -m unilm_tpu_torch.cli.reproduce_baseline --config beit_large_eval \\
      --data <imagenet/val> --checkpoint beit_large_ft22kto1k.pt
  python -m unilm_tpu_torch.cli.reproduce_baseline --config funsd \\
      --data <funsd_root> --checkpoint layoutlmv3_funsd.pt --tokenizer <hf_dir>
  python -m unilm_tpu_torch.cli.reproduce_baseline --config trocr_iam \\
      --data <iam_gt.txt> --checkpoint trocr_base_iam.pt
  python -m unilm_tpu_torch.cli.reproduce_baseline --config kosmos_ocr \\
      --data <handwritten.jsonl> --checkpoint kosmos2_5.pt
  python -m unilm_tpu_torch.cli.reproduce_baseline --config trocr_iam \\
      --smoke --device cpu

The loops are cli/run_class_finetuning.py, cli/run_funsd.py,
cli/trocr_eval.py and cli/kosmos_infer.py's `build_pipeline` /
`postprocess_ocr` scored with `scoring.cer`. Exit code 0 iff |measured -
golden| <= tol; one JSON verdict line. `--smoke` writes synthetic fixtures
and runs the config's loop on them with random weights, skipping the
golden assertion: it proves the harness, not the numbers. Every loop runs
on the card (`--device cuda`, the default, which raises on a host without
one) unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import re
import sys
import tempfile
from collections import Counter

GOLDEN = {
    "beit_large_eval": {
        "metric": "acc1", "value": 87.396, "tol": 0.15,
        "source": "beit/get_started_for_image_classification.md:83",
    },
    "beit_base_eval": {
        "metric": "acc1", "value": 85.2, "tol": 0.15,
        "source": "beit/README.md:72",
    },
    "funsd": {
        "metric": "f1", "value": 0.9059, "tol": 0.01,
        "source": "layoutlmv3/README.md:57",
    },
    "trocr_iam": {
        "metric": "cer", "value": 3.42, "tol": 0.2,
        "source": "trocr/README.md:17",
    },
    "kosmos_ocr": {
        "metric": "word_f1", "value": 71.6, "tol": 1.5,
        "source": "kosmos-2.5/README.md:26",
    },
}


def _run_cli(module: str, cli_args: list) -> str:
    """Run a CLI module's main(argv) in-process, capturing its stdout
    (echoed after the call) for the line the caller parses."""
    mod = importlib.import_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main([str(a) for a in cli_args])
    out = buf.getvalue()
    sys.stdout.write(out)
    return out


def eval_beit(args, model_name: str) -> dict:
    out = _run_cli("unilm_tpu_torch.cli.run_class_finetuning", [
        "--model", model_name, "--eval", "--data_path", args.data,
        "--batch_size", args.batch_size, "--device", args.device,
        *(["--checkpoint", args.checkpoint] if args.checkpoint else []),
        *(["--max_samples", args.limit] if args.limit else []),
        *(["--nb_classes", args.nb_classes] if args.nb_classes else []),
    ])
    m = re.search(r"\* Acc@1 ([\d.]+) Acc@5 ([\d.]+)", out)
    if not m:
        raise RuntimeError("eval produced no Acc line")
    return {"acc1": float(m.group(1)), "acc5": float(m.group(2))}


def eval_funsd(args, smoke: bool = False) -> dict:
    out = _run_cli("unilm_tpu_torch.cli.run_funsd", [
        "--data_path", args.data, "--tokenizer", args.tokenizer,
        "--batch_size", args.batch_size, "--device", args.device,
        *(["--max_len", "64", "--no_image"] if smoke else []),
        *(["--checkpoint", args.checkpoint] if args.checkpoint else []),
    ])
    m = re.search(r"precision ([\d.]+) recall ([\d.]+) f1 ([\d.]+)", out)
    if not m:
        raise RuntimeError("eval produced no f1 line")
    return {"precision": float(m.group(1)), "recall": float(m.group(2)),
            "f1": float(m.group(3))}


def eval_trocr(args, smoke: bool = False) -> dict:
    from unilm_tpu_torch.cli import trocr_eval

    cli = (["--synthetic", "--synthetic-n", "4", "--tiny",
            "--max-new-tokens", "8", "--batch-size", "2"] if smoke else
           ["--gt", args.data, "--beam", "5",
            *(["--checkpoint", args.checkpoint] if args.checkpoint else []),
            *(["--limit", str(args.limit)] if args.limit else [])])
    res = trocr_eval.main(cli + ["--device", args.device])
    return {"cer": 100.0 * res["cer"], "n": res["n"]}


def eval_kosmos_ocr(args, smoke: bool = False) -> dict:
    """Kosmos-2.5 text recognition: per-image OCR generation scored as
    word-level F1 (multiset match, the Kosmos-2.5 convention) and the
    character NED."""
    from unilm_tpu_torch.cli.kosmos_infer import (build_pipeline,
                                                  postprocess_ocr)
    from unilm_tpu_torch.scoring import cer as cer_fn

    infer_args = argparse.Namespace(
        task="ocr", checkpoint=args.checkpoint,
        max_new_tokens=args.max_new_tokens, beam=1,
        max_patches=16 if smoke else 4096,
        num_image_tokens=8 if smoke else 2048,
        image_id=5 if smoke else 100283, image_end_id=6 if smoke else 100284,
        ocr_id=7 if smoke else 100288, md_id=8 if smoke else 100289,
        bf16=not smoke, fp32=smoke, tiny=smoke, int8=False, no_scan=False,
        device=args.device)
    infer = build_pipeline(infer_args)

    with open(args.data) as f:
        items = [json.loads(line) for line in f if line.strip()]
    if args.limit:
        items = items[:args.limit]
    tp = fp = fn = 0
    refs, hyps = [], []
    for it in items:
        text = infer(it["image"])
        pred_words = []
        for rec in postprocess_ocr(text):
            pred_words += rec["text"].split()
        if not pred_words:  # plain-text fallback (no bbox grammar)
            pred_words = text.split()
        pc, gc = Counter(pred_words), Counter(it["text"].split())
        inter = sum((pc & gc).values())
        tp += inter
        fp += sum(pc.values()) - inter
        fn += sum(gc.values()) - inter
        refs.append(it["text"])
        hyps.append(" ".join(pred_words))
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    ned = 100.0 * (1.0 - min(cer_fn(refs, hyps), 1.0))
    return {"word_f1": 100.0 * f1, "ned": ned, "n": len(items)}


def _smoke_fixtures(config: str, tmp: str, args) -> None:
    """Synthetic dataset fixtures so every config's eval loop runs offline
    (random weights; the golden assertion is skipped)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)

    def _img(path, size=(64, 48)):
        Image.fromarray(
            (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8)).save(path)

    if config in ("beit_base_eval", "beit_large_eval"):
        for ci in range(2):
            d = os.path.join(tmp, f"class_{ci}")
            os.makedirs(d, exist_ok=True)
            for i in range(3):
                _img(os.path.join(d, f"{i}.png"))
        args.data = tmp
        args.nb_classes = 2
        args.batch_size = 2
    elif config == "funsd":
        os.makedirs(os.path.join(tmp, "annotations"), exist_ok=True)
        os.makedirs(os.path.join(tmp, "images"), exist_ok=True)
        for i in range(2):
            form = [{"label": "question", "words": [
                {"text": "name", "box": [5, 5, 25, 12]}]},
                {"label": "answer", "words": [
                    {"text": "ada", "box": [30, 5, 50, 12]},
                    {"text": "lovelace", "box": [52, 5, 62, 12]}]}]
            with open(os.path.join(tmp, "annotations", f"d{i}.json"),
                      "w") as f:
                json.dump({"form": form}, f)
            _img(os.path.join(tmp, "images", f"d{i}.png"))
        tok_dir = os.path.join(tmp, "tok")
        os.makedirs(tok_dir, exist_ok=True)
        vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
        for i, ch in enumerate("abcdefghijklmnopqrstuvwxyzĠ"):
            vocab[ch] = 5 + i
        with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
        with open(os.path.join(tok_dir, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "RobertaTokenizer",
                       "model_max_length": 512}, f)
        args.data = tmp
        args.tokenizer = tok_dir
        args.batch_size = 2
    elif config == "kosmos_ocr":
        recs = []
        for i in range(2):
            ip = os.path.join(tmp, f"doc{i}.png")
            _img(ip)
            recs.append({"image": ip, "text": "hello world"})
        data = os.path.join(tmp, "gt.jsonl")
        with open(data, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs))
        args.data = data
        args.max_new_tokens = 4


def main(argv=None):
    p = argparse.ArgumentParser("golden-number reproduction (PyTorch/CUDA)")
    p.add_argument("--config", required=True, choices=sorted(GOLDEN))
    p.add_argument("--data", help="dataset path (see module docstring)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--tokenizer", default="", help="local HF dir (funsd)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit", type=int, default=0,
                   help="cap eval examples (debugging only; golden numbers "
                        "require the full set)")
    p.add_argument("--max_new_tokens", type=int, default=1024)
    p.add_argument("--tol", type=float, default=None,
                   help="override the documented tolerance")
    p.add_argument("--smoke", action="store_true",
                   help="synthetic fixtures, random weights, no golden "
                        "assertion: proves the harness offline")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    args.nb_classes = 0

    with contextlib.ExitStack() as stack:
        if args.smoke:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="reproduce_smoke_"))
            _smoke_fixtures(args.config, tmp, args)
        if args.config == "beit_large_eval":
            res = eval_beit(args, "beit_large_patch16_224")
        elif args.config == "beit_base_eval":
            res = eval_beit(args, "beit_base_patch16_224")
        elif args.config == "funsd":
            res = eval_funsd(args, smoke=args.smoke)
        elif args.config == "trocr_iam":
            res = eval_trocr(args, smoke=args.smoke)
        else:
            res = eval_kosmos_ocr(args, smoke=args.smoke)

    g = GOLDEN[args.config]
    measured = res[g["metric"]]
    tol = args.tol if args.tol is not None else g["tol"]
    ok = abs(measured - g["value"]) <= tol
    verdict = {
        "config": args.config, "metric": g["metric"], "measured": measured,
        "golden": g["value"], "tol": tol, "source": g["source"],
        "ok": bool(ok), "smoke": bool(args.smoke), **res,
    }
    print(json.dumps(verdict))
    if args.smoke:
        return verdict  # the harness ran; random weights cannot hit golden
    if not ok:
        sys.exit(1)
    return verdict


if __name__ == "__main__":
    main()
