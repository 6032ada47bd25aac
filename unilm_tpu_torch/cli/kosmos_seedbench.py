"""SEED-Bench multiple-choice evaluation for Kosmos-2 (port of
unilm_tpu/cli/kosmos_seedbench.py).

    python -m unilm_tpu_torch.cli.kosmos_seedbench --data seed.jsonl \\
        --device cpu

Each question becomes one candidate per choice ("Question: {q} Answer:
{choice}"), each candidate is scored by the mean log-prob of its answer
tokens (scoring_seedbench.py), and the argmax choice is held against the
answer; prints accuracy overall and per question type as one JSON line.

Fixture format (jsonl), one question per line:
  {"image": str|null, "question": str, "choices": [str, str, str, str],
   "answer": "A", "question_type": str|int}

Modes:
  --oracle   score candidates made from the answers (a harness
             self-check: accuracy = 1.0)
  (default)  score with a UniGPT with the CLIP tower and random weights
             from --seed (the model flags of cli/kosmos_ground_eval.py,
             --kosmos2 among them), every candidate of a --batch_size
             chunk in one forward.
The model runs on the card (`--device cuda`, the default, which raises
on a host without one) unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from unilm_tpu_torch.cli.kosmos_ground_eval import add_model_args, build_model
from unilm_tpu_torch.data.vl_loaders import VLTokenizer, load_image
from unilm_tpu_torch.models.kosmos import UniGPT
from unilm_tpu_torch.scoring_seedbench import (CHOICE_LETTERS,
                                               answer_span_logprob,
                                               cook_candidates,
                                               seedbench_accuracy)


def pack_candidates(args, tok: VLTokenizer, records):
    """All N*C candidates as one right-padded batch, numpy: tokens [N*C, T]
    int64, answer_mask [N*C, T] float32, img_mask [N*C, T] bool, segs
    [N*C, T] int64, images [N*C, S, S, 3] float32.

    A row is <s> <image> [Q slots] </image> prompt answer </s>; the answer
    mask covers the answer tokens and the closing </s>."""
    bos, pad, eos = tok.token("<s>"), tok.token("<pad>"), tok.token("</s>")
    boi, eoi = tok.token("<image>"), tok.token("</image>")
    Q = args.image_tokens
    rows, amasks, imasks, segs, imgs = [], [], [], [], []
    for rec in records:
        img = load_image(rec.get("image"), args.image_root, args.image_size,
                         key=json.dumps(rec)[:64])
        for prompt, answer in cook_candidates(rec["question"],
                                              rec["choices"]):
            p_ids = tok.encode_text(prompt)
            a_ids = tok.encode_text(answer) + [eos]
            rows.append([bos, boi] + [pad] * Q + [eoi] + p_ids + a_ids)
            imasks.append([False, False] + [True] * Q
                          + [False] * (1 + len(p_ids) + len(a_ids)))
            amasks.append([0.0] * (3 + Q + len(p_ids)) + [1.0] * len(a_ids))
            segs.append([0, 1] + [1] * Q + [1]
                        + [0] * (len(p_ids) + len(a_ids)))
            imgs.append(img)
    T = min(max(len(r) for r in rows), args.max_len)

    def pad_to(xs, v, dtype):
        return np.asarray([list(x)[:T] + [v] * (T - len(x)) for x in xs],
                          dtype)

    return (pad_to(rows, pad, np.int64), pad_to(amasks, 0.0, np.float32),
            pad_to(imasks, False, bool), pad_to(segs, 0, np.int64),
            np.stack(imgs))


def score_batch(model: UniGPT, tokens, images, imask, segs, amask
                ) -> torch.Tensor:
    """[n] mean answer log-probs of one forward over n candidates."""
    with torch.no_grad():
        logits = model(tokens, images, imask, segs)
    return answer_span_logprob(logits, tokens, amask)


def model_scores(args, tok: VLTokenizer, records, model: UniGPT = None
                 ) -> np.ndarray:
    """[N, C] mean answer log-probs, batch_size // C questions a forward
    (the model of `build_model` unless one is given)."""
    model = model if model is not None else build_model(args, tok)
    dev = next(model.parameters()).device
    packed = [torch.from_numpy(a).to(dev)
              for a in pack_candidates(args, tok, records)]
    tokens, amask, imask, segs, images = packed
    C = len(records[0]["choices"])
    B = max(args.batch_size // C * C, C)
    out = []
    for i in range(0, tokens.shape[0], B):
        sl = slice(i, i + B)
        out.append(score_batch(model, tokens[sl], images[sl], imask[sl],
                               segs[sl], amask[sl]).cpu().numpy())
    return np.concatenate(out).reshape(len(records), C)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SEED-Bench eval")
    p.add_argument("--data", required=True, help="fixtures jsonl")
    p.add_argument("--oracle", action="store_true")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--out", default="", help="write full result json here")
    add_model_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.data, encoding="utf-8") as f:
        records = [json.loads(l) for l in f if l.strip()]
    if args.limit:
        records = records[:args.limit]
    answers = [CHOICE_LETTERS.index(r["answer"]) for r in records]
    qtypes = [r.get("question_type", "all") for r in records]

    if args.oracle:
        scores = np.full((len(records), len(records[0]["choices"])), -1.0)
        scores[np.arange(len(records)), answers] = 0.0
    else:
        scores = model_scores(args, VLTokenizer(), records)

    result = seedbench_accuracy(scores, answers, qtypes)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=2)
    print(json.dumps({"accuracy": round(result["accuracy"], 4),
                      "total": result["total"],
                      "per_type": {k: round(v["accuracy"], 4)
                                   for k, v in result.get("per_type",
                                                          {}).items()}}))
    return result


if __name__ == "__main__":
    main()
