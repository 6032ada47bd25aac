"""Kosmos-2 grounded-caption demo (port of unilm_tpu/cli/kosmos_demo.py).

    python -m unilm_tpu_torch.cli.kosmos_demo --image cat.png \\
        --prompt "<grounding>An image of" --annotate out.png --device cpu

Takes an image and a prompt, generates grounded markup
(cli/kosmos_ground_eval.py's `model_generate`), parses it into (phrase,
bbox) entities and prints them (`--json`: one JSON object), and with
`--annotate` writes a copy of the image with the boxes drawn (PIL).
`--repl` reads `image_path<TAB>prompt` lines from stdin; `--serve`
starts a gradio UI where gradio is installed (imported only then). The
model is built once, random weights from --seed, on the card
(`--device cuda`, the default, which raises on a host without one)
unless `--device cpu` asks for the CPU; the model flags are
cli/kosmos_ground_eval.py's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from unilm_tpu_torch.cli.kosmos_ground_eval import (add_model_args,
                                                    build_model,
                                                    model_generate)
from unilm_tpu_torch.data.grounding import parse_grounded_text
from unilm_tpu_torch.data.vl_loaders import VLTokenizer, load_image


def caption(args, tok, image_path: str, prompt: str, model=None):
    """Generate and parse one grounded caption: (clean, entities, raw).
    build_prompts adds the <grounding> token, so the user text loses its
    own."""
    text = prompt.replace("<grounding>", "").strip()
    prefix = tok.encode_text(text) if text else []
    raw = model_generate(args, tok, [{"image": image_path}], [prefix],
                         model=model)[0]
    clean, entities = parse_grounded_text(raw, args.quantized_size)
    return clean, entities, raw


def annotate(image_path: str, image_root: str, entities, out_path: str,
             image_size: int = 224) -> None:
    """Draw the entities' boxes and phrases on the image (PIL)."""
    from PIL import Image, ImageDraw

    arr = load_image(image_path, image_root, image_size, key=out_path)
    img = Image.fromarray((arr * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    W, H = img.size
    colors = ["red", "lime", "blue", "yellow", "magenta", "cyan", "orange"]
    for i, (phrase, boxes) in enumerate(entities):
        c = colors[i % len(colors)]
        for x0, y0, x1, y1 in boxes:
            draw.rectangle([x0 * W, y0 * H, x1 * W, y1 * H], outline=c,
                           width=2)
            draw.text((x0 * W + 2, max(0.0, y0 * H - 10)), phrase[:24],
                      fill=c)
    img.save(out_path)


def _print_result(clean, entities, raw, as_json=False):
    if as_json:
        print(json.dumps({"caption": clean, "raw": raw, "entities": [
            {"phrase": p, "boxes": [list(b) for b in bs]}
            for p, bs in entities]}))
        return
    print(f"caption: {clean}")
    for phrase, boxes in entities:
        for b in boxes:
            print(f"  [{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},{b[3]:.3f}] {phrase}")


def serve(args, tok, model):
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed in this environment; use the one-shot "
              "CLI or --repl instead (pip install gradio to serve the UI).",
              file=sys.stderr)
        return 2

    def fn(image_path, prompt):
        clean, entities, _ = caption(args, tok, image_path, prompt, model)
        return clean, json.dumps(
            [{"phrase": p, "boxes": bs} for p, bs in entities], indent=2)

    gr.Interface(
        fn=fn,
        inputs=[gr.Image(type="filepath"),
                gr.Textbox(value="<grounding>An image of")],
        outputs=[gr.Textbox(label="caption"), gr.Textbox(label="entities")],
        title="Kosmos-2 grounded captioning",
    ).launch(server_name="0.0.0.0", server_port=args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Kosmos-2 grounded-caption demo")
    p.add_argument("--image", help="image path (a pseudo-image seeded from "
                                   "the path when the file is missing)")
    p.add_argument("--prompt", default="<grounding>An image of")
    p.add_argument("--annotate", default="",
                   help="write the annotated image here")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--repl", action="store_true",
                   help="read `image_path<TAB>prompt` lines from stdin")
    p.add_argument("--serve", action="store_true",
                   help="gradio UI (if installed)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--quantized_size", type=int, default=32)
    p.add_argument("--max_new_tokens", type=int, default=48)
    p.add_argument("--tokenizer", default="auto",
                   choices=["auto", "tiktoken", "bytes"])
    add_model_args(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    tok = VLTokenizer(args.quantized_size, backend=args.tokenizer)
    model = build_model(args, tok)

    if args.serve:
        return serve(args, tok, model)

    if args.repl:
        for line in sys.stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            img, _, prompt = line.partition("\t")
            _print_result(*caption(args, tok, img, prompt or args.prompt,
                                   model), args.json)
        return 0

    clean, entities, raw = caption(args, tok, args.image, args.prompt, model)
    _print_result(clean, entities, raw, args.json)
    if args.annotate:
        annotate(args.image, args.image_root, entities, args.annotate,
                 args.image_size)
        print(f"annotated image -> {args.annotate}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
