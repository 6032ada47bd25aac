"""Port parity for Kosmos-2's entry points on the CPU: scoring_grounding,
scoring_seedbench, cli/kosmos_ground_eval.py, cli/kosmos_seedbench.py,
cli/kosmos_demo.py and cli/train_gpt.py --vl_data, against unilm_tpu.

tiktoken is hidden from both packages (the JAX tokenizer's "auto" would
fetch cl100k_base), so both tokenize bytes. The model modes of the JAX
CLIs initialise their own random weights; the port's functions take a
model, so the JAX CLI's weights are rebuilt here (its init, its seed)
and loaded into the port's. Tolerances: metrics, oracle JSON, greedy
markup and data batches exactly; SEED-Bench answer log-probs 1e-5 abs
(float32 with JAX at `highest`); the two --vl_data steps' loss and grad
norm 1e-5 relative (test_torch_train.py's); a resumed CLI run bitwise.
"""

import argparse
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unilm_tpu import scoring_grounding as jsg
from unilm_tpu import scoring_seedbench as jss
from unilm_tpu.cli import kosmos_ground_eval as jge
from unilm_tpu.cli import kosmos_seedbench as jsb
from unilm_tpu.cli import train_gpt as jtg
from unilm_tpu.data import vl_loaders as jv
from unilm_tpu.models import kosmos as jk
from unilm_tpu.ops import fused_ce as jce
from unilm_tpu.runtime import optim as joptim
from unilm_tpu.runtime import train as jtrain
from unilm_tpu_torch import scoring_grounding as tsg
from unilm_tpu_torch import scoring_seedbench as tss
from unilm_tpu_torch.cli import kosmos_demo as tdemo
from unilm_tpu_torch.cli import kosmos_ground_eval as tge
from unilm_tpu_torch.cli import kosmos_seedbench as tsb
from unilm_tpu_torch.cli import train_gpt as ttg
from unilm_tpu_torch.convert.from_jax import load_flax_params
from unilm_tpu_torch.data import vl_loaders as tv
from unilm_tpu_torch.models import kosmos as tk

torch.set_num_threads(1)

FLICKR = [
    {"image": None, "caption": "a dog and a cat",
     "phrases": [{"phrase": "a dog", "boxes": [[0.1, 0.2, 0.5, 0.6]]},
                 {"phrase": "a cat", "boxes": [[0.5, 0.5, 0.9, 0.95],
                                               [0.0, 0.0, 0.3, 0.3]]}]},
    {"image": "missing.png", "caption": "a man",
     "phrases": [{"phrase": "A  Man", "boxes": [[0.2, 0.1, 0.8, 0.9]]},
                 {"phrase": "nothing", "boxes": []}]},
]
REFCOCO = [
    {"image": None, "expression": "the left dog", "box": [0.1, 0.1, 0.4, 0.5]},
    {"image": "x.png", "expression": "red car", "box": [0.5, 0.4, 0.9, 0.8]},
    {"image": None, "expression": "a", "box": [0.0, 0.0, 1.0, 1.0]},
]
SEED = [
    {"image": None, "question": "What is  shown?",
     "choices": ["a dog", "a cat", "a car", "a tree"], "answer": "B",
     "question_type": "scene"},
    {"image": "y.png", "question": "How many?",
     "choices": ["one", "two", "three", "four"], "answer": "A",
     "question_type": 3},
    {"image": None, "question": "Color?",
     "choices": ["red", "green", "blue", "black"], "answer": "D",
     "question_type": "scene"},
]
MODEL_FLAGS = ["--image_tokens", "4", "--image_size", "28", "--dim", "32",
               "--layers", "1", "--heads", "2", "--clip_dim", "32"]


@pytest.fixture(autouse=True)
def _no_tiktoken(monkeypatch):
    monkeypatch.setitem(sys.modules, "tiktoken", None)


def _write(path, records):
    path.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return str(path)


def _json_out(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --------------------------------------------------------------------------- #
# the scorers
# --------------------------------------------------------------------------- #

def test_grounding_scores_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        a, b = rng.rand(7, 4), rng.rand(5, 4)
        a[:, 2:] += a[:, :2]
        b[:, 2:] += b[:, :2]
        np.testing.assert_array_equal(tsg.box_iou_np(a, b),
                                      jsg.box_iou_np(a, b))
    assert tsg.box_iou_np(np.zeros((0, 4)), b).shape == (0, 5)
    texts = ["<phrase>A Dog</phrase><object><patch_index_0033>"
             "<patch_index_0300></object> on <phrase>the grass</phrase>"
             "<object><patch_index_0001><patch_index_1023>"
             "</delimiter_of_multi_objects/><patch_index_0500>"
             "<patch_index_0600></object>", "no markup", ""]
    preds = [tsg.grounded_text_to_predictions(t) for t in texts]
    assert preds == [jsg.grounded_text_to_predictions(t) for t in texts]
    gts = [[("a dog", [[0.0, 0.0, 0.35, 0.3]]), ("the grass", [[0.5, 0.4,
                                                              0.8, 0.6]])],
           [("x", [[0.1, 0.1, 0.2, 0.2]])], [("y", [])]]
    for ks in ((1, 5, 10), (1, 2)):
        assert tsg.phrase_grounding_recall(preds, gts, ks) == \
            jsg.phrase_grounding_recall(preds, gts, ks)
    pb = [[0.0, 0.0, 0.3, 0.3], None, [0.5, 0.5], [0.1, 0.1, 0.9, 0.9]]
    gb = [[0.0, 0.0, 0.3, 0.32], [0, 0, 1, 1], [0, 0, 1, 1], [0.5, 0.5, 1, 1]]
    assert tsg.refexp_accuracy(pb, gb) == jsg.refexp_accuracy(pb, gb)
    assert tsg.refexp_accuracy([], []) == jsg.refexp_accuracy([], [])


def test_seedbench_scores_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 9, 40).astype(np.float32) * 3
    tokens = rng.randint(0, 40, size=(6, 9))
    amask = (rng.rand(6, 9) > 0.5).astype(np.float32)
    amask[0] = 0  # an empty answer span
    want = jss.answer_span_logprob(jnp.asarray(logits), jnp.asarray(tokens),
                                   jnp.asarray(amask))
    got = tss.answer_span_logprob(torch.from_numpy(logits),
                                  torch.from_numpy(tokens),
                                  torch.from_numpy(amask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    scores = rng.randn(5, 4)
    scores[2, 1] = scores[2, 3] = scores[2].max() + 1  # a tie: the first
    answers, types = [0, 1, 1, 3, 2], ["a", "b", "a", 3, "b"]
    assert tss.seedbench_accuracy(scores, answers, types) == \
        jss.seedbench_accuracy(scores, answers, types)
    assert tss.seedbench_accuracy(scores, answers) == \
        jss.seedbench_accuracy(scores, answers)
    assert tss.cook_candidates(" Why  so? ", ["a  b", "c"]) == \
        jss.cook_candidates(" Why  so? ", ["a  b", "c"])


# --------------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("task", ["flickr", "refcoco"])
def test_ground_eval_oracle_json_matches_jax(task, tmp_path, capsys):
    data = _write(tmp_path / f"{task}.jsonl",
                  FLICKR if task == "flickr" else REFCOCO)
    argv = ["--task", task, "--data", data, "--oracle"]
    jge.main(argv)
    want = _json_out(capsys)
    tge.main(argv)
    got = _json_out(capsys)
    assert got == want
    assert got.get("R@1", got.get("accuracy")) == 1.0


def test_seedbench_oracle_json_matches_jax(tmp_path, capsys):
    data = _write(tmp_path / "seed.jsonl", SEED)
    jsb.main(["--data", data, "--oracle", "--out", str(tmp_path / "j.json")])
    want = _json_out(capsys)
    tsb.main(["--data", data, "--oracle", "--out", str(tmp_path / "t.json")])
    assert _json_out(capsys) == want and want["accuracy"] == 1.0
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())


def _jax_cli_params(jmodel, arrays, seed):
    """The random params a JAX Kosmos-2 CLI initialises for its batch."""
    tokens, images, imask, segs = (jnp.asarray(a) for a in arrays)
    return jax.device_get(jax.jit(lambda r: jmodel.init(
        r, tokens[:1], images[:1], imask[:1], segs[:1])["params"])(
            jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("task", ["flickr", "refcoco"])
def test_model_generate_matches_jax(task):
    """The prompts equal JAX's (left-filled <pad> before <image> for short
    prefixes) and, on the JAX CLI's weights, the greedy markup too."""
    argv = ["--task", task, "--data", "unused", "--device", "cpu",
            "--max_new_tokens", "6"] + MODEL_FLAGS
    jargs = argparse.Namespace(**vars(tge.build_parser().parse_args(argv)))
    targs = tge.build_parser().parse_args(argv)
    jtok, ttok = jv.VLTokenizer(), tv.VLTokenizer()
    records = FLICKR if task == "flickr" else REFCOCO
    prefixes = ([[]] * len(records) if task == "flickr" else
                [ttok.encode_grounded(f"<phrase>{r['expression']}</phrase>")
                 for r in records])
    tokens, imask, segs, images = tge.build_prompts(targs, ttok, records,
                                                    prefixes)
    if task == "refcoco":  # "a" is shorter: <pad>s fill its prefix
        fill = len(prefixes[0]) - len(prefixes[2])
        assert (tokens[2, 1:1 + fill] == ttok.token("<pad>")).all()
        assert tokens[2, 1 + fill] == ttok.token("<image>")
        assert not imask[2, :2 + fill].any() and segs[2, 1 + fill] == 1
    jmodel, _ = jge.build_model(jargs, jtok)
    params = _jax_cli_params(jmodel, (tokens, images, imask, segs),
                             jargs.seed)
    want = jge.model_generate(jargs, jtok, records, prefixes)
    tmodel = tk.UniGPT(tge.model_config(targs, ttok)).eval()
    load_flax_params(tmodel, params)
    got = tge.model_generate(targs, ttok, records, prefixes, model=tmodel)
    assert got == want


def test_seedbench_model_scores_match_jax():
    argv = ["--data", "unused", "--device", "cpu", "--batch_size", "8"] + \
        MODEL_FLAGS
    jargs = argparse.Namespace(**vars(tsb.build_parser().parse_args(argv)))
    targs = tsb.build_parser().parse_args(argv)
    jtok, ttok = jv.VLTokenizer(), tv.VLTokenizer()
    jp = jsb.pack_candidates(jargs, jtok, SEED)
    tp = tsb.pack_candidates(targs, ttok, SEED)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b)
    params = _jax_cli_params(jsb.build_model(jargs, jtok),
                             (tp[0], tp[4], tp[2], tp[3]), jargs.seed)
    want = jsb.model_scores(jargs, jtok, SEED)
    tmodel = tk.UniGPT(tge.model_config(targs, ttok)).eval()
    load_flax_params(tmodel, params)
    got = tsb.model_scores(targs, ttok, SEED, model=tmodel)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("preset", [False, True])
def test_model_config_precision(preset):
    """The small geometry computes in float32, as the JAX CLIs do;
    --kosmos2 is kosmos2() in bf16 with segment embeddings, and takes the
    preset's image size and latent queries."""
    argv = ["--task", "refcoco", "--data", "unused"] + (
        ["--kosmos2"] if preset else MODEL_FLAGS)
    args = tge.build_parser().parse_args(argv)
    cfg = tge.model_config(args, tv.VLTokenizer(backend="bytes"))
    if preset:
        assert cfg == tk.kosmos2(dtype=torch.bfloat16, segment_emb=True)
        assert (args.image_size, args.image_tokens) == (224, 64)
    else:
        assert cfg.dtype == cfg.clip.dtype == torch.float32
        assert cfg.segment_emb and cfg.image_tower == "clip"


@pytest.mark.parametrize("cli", ["flickr", "refcoco", "seedbench"])
def test_model_modes_print_metrics_and_need_a_card(cli, tmp_path, capsys,
                                                   monkeypatch):
    """--device cpu runs the model mode and prints the metric keys; the
    default --device cuda raises when no card is visible."""
    if cli == "seedbench":
        main, keys = tsb.main, {"accuracy", "total", "per_type"}
        argv = ["--data", _write(tmp_path / "s.jsonl", SEED)]
    else:
        main = tge.main
        keys = ({"R@1", "R@5", "R@10", "num_phrases"} if cli == "flickr"
                else {"accuracy", "num_refs"})
        argv = ["--task", cli, "--data", _write(
            tmp_path / "g.jsonl", FLICKR if cli == "flickr" else REFCOCO),
            "--max_new_tokens", "4"]
    main(argv + MODEL_FLAGS + ["--device", "cpu"])
    assert set(_json_out(capsys)) == keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv + MODEL_FLAGS)


def test_demo_one_shot_with_annotate(tmp_path, capsys):
    """A one-shot caption with --json and --annotate: the printed entities
    are parse_grounded_text's of the raw markup, and the annotated image
    is written at --image_size."""
    from PIL import Image

    from unilm_tpu_torch.data.grounding import parse_grounded_text

    out = tmp_path / "ann.png"
    assert tdemo.main(["--image", str(tmp_path / "none.png"), "--json",
                       "--annotate", str(out), "--max_new_tokens", "5",
                       "--device", "cpu"] + MODEL_FLAGS) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[0])
    clean, ents = parse_grounded_text(res["raw"])
    assert res["caption"] == clean and len(res["entities"]) == len(ents)
    assert lines[1] == f"annotated image -> {out}"
    assert Image.open(out).size == (28, 28)
    assert tdemo.main(["--serve", "--device", "cpu"] + MODEL_FLAGS) in (0, 2)


# --------------------------------------------------------------------------- #
# train_gpt --vl_data
# --------------------------------------------------------------------------- #

VL = ["--dim", "64", "--layers", "2", "--heads", "4", "--ffn", "128",
      "--image_tokens", "4", "--image_size", "28", "--clip_dim", "32",
      "--tokens_per_sample", "48", "--batch_size", "2", "--fused_ce",
      "--ce_chunk", "200", "--warmup", "1", "--lr", "1e-3", "--max_steps",
      "10", "--seed", "1"]


def _shard(tmp_path):
    rng = np.random.RandomState(7)
    words = ["a", "dog", "cat", "on", "the", "grass", "red", "car"]
    recs = []
    for i in range(9):
        ws = [words[j] for j in rng.randint(0, len(words),
                                            size=rng.randint(3, 12))]
        recs.append({"caption": " ".join(ws), "image": None,
                     "objects": [{"span": [0, len(ws[0])],
                                  "boxes": [[0.1, 0.2, 0.5, 0.7]]}]})
    return _write(tmp_path / "vl0.jsonl", recs)


@functools.lru_cache(maxsize=None)
def _jax_vl_run(shard):
    """JAX's --vl_data setup at float32 (the CLI's build_vl_stream, config
    and multimodal loss), its two make_train_step + optax.adamw updates:
    (params, batches, metrics)."""
    args = argparse.Namespace(
        vl_data=shard, quantized_size=32, tokens_per_sample=48,
        image_tokens=4, image_size=28, interleaved=False, image_root="",
        seed=1, batch_size=2)
    stream, tok = jtg.build_vl_stream(args)
    clip = jk.ClipVisionConfig(img_size=28, embed_dim=32, num_layers=2,
                               num_heads=2, ffn_dim=128)
    cfg = jk.UniGPTConfig(
        vocab_size=tok.vocab_size, embed_dim=64, num_layers=2, num_heads=4,
        ffn_dim=128, max_positions=50, subln=True, xpos_rel_pos=True,
        image_tower="clip", latent_query_num=4, clip=clip, segment_emb=True)
    model = jk.UniGPT(cfg)
    batches = [next(stream) for _ in range(2)]
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = model.init(jax.random.PRNGKey(1), b0["tokens"],
                        b0["images"][:, 0], b0["img_mask"], b0["segs"])[
        "params"]

    def loss_fn(p, batch, rng):
        out = model.apply({"params": p}, batch["tokens"],
                          batch["images"][:, 0], batch["img_mask"],
                          batch["segs"], return_features=True)
        s, n = jce.chunked_cross_entropy(
            out[:, :-1], p["embed_tokens"]["embedding"],
            batch["tokens"][:, 1:], mask=batch["loss_mask"][:, 1:],
            chunk=200)
        return s / n, {"ntok": n}

    tx = optax.adamw(joptim.polynomial_decay_schedule(1e-3, 10, 1), b1=0.9,
                     b2=0.98, weight_decay=0.01)
    state = jtrain.TrainState.create(params, tx)
    step = jax.jit(jtrain.make_train_step(loss_fn, tx, clip_grad_norm=2.0))
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(params), batches, metrics


def test_vl_data_steps_match_jax(tmp_path):
    """Two --vl_data steps of the port's build_trainer (float32) on the
    JAX CLI's weights: the same batches as JAX's stream, and loss,
    grad_norm and ntok within 1e-5 relative of make_train_step's."""
    shard = _shard(tmp_path)
    params, batches, jm = _jax_vl_run(shard)
    args = ttg.build_parser().parse_args(
        ["--vl_data", shard, "--device", "cpu"] + VL)
    args.bf16 = False
    tr = ttg.build_trainer(args)
    assert tr.cfg.image_tower == "clip" and tr.cfg.segment_emb
    assert tr.cfg.vocab_size == tv.VLTokenizer().vocab_size
    load_flax_params(tr.model, params)
    for i in range(2):
        batch = tr.next_batch()
        for k, v in batches[i].items():
            np.testing.assert_array_equal(batch[k].numpy(),
                                          v.astype(batch[k].numpy().dtype),
                                          err_msg=k)
        tr.state, m = tr.step_fn(tr.state, batch)
        for k in ("loss", "grad_norm", "ntok"):
            np.testing.assert_allclose(float(m[k]), jm[i][k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")


def test_vl_data_cli_resume_is_bitwise(tmp_path):
    """--vl_data through main(): 4 steps straight equal 2 + save + resume
    + 2 (params, optimizer state, the stream's state, the logged loss)."""
    from unilm_tpu_torch.runtime.checkpoint import CheckpointManager

    base = ["--vl_data", _shard(tmp_path), "--device", "cpu",
            "--update_freq", "2", "--save_every", "2"] + VL
    base[base.index("--batch_size") + 1] = "4"
    ttg.main(base + ["--save_dir", str(tmp_path / "a"), "--max_steps", "4"])
    ttg.main(base + ["--save_dir", str(tmp_path / "b"), "--max_steps", "2"])
    ttg.main(base + ["--save_dir", str(tmp_path / "b"), "--max_steps", "4"])
    sa, da, ma = CheckpointManager(str(tmp_path / "a")).restore(4)
    sb, db, mb = CheckpointManager(str(tmp_path / "b")).restore(4)
    assert sa["step"] == sb["step"] == 4 and da == db and ma == mb
    assert da["source"]["buffer"]  # the shuffle buffer is saved
    for k in sa["model"]:
        assert torch.equal(sa["model"][k], sb["model"][k]), k
    for a, b in zip(sa["opt_state"]["mu"] + sa["opt_state"]["nu"],
                    sb["opt_state"]["mu"] + sb["opt_state"]["nu"]):
        assert torch.equal(a, b)
