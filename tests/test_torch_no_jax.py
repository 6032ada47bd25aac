"""unilm_tpu_torch must import and run without jax, flax or unilm_tpu: the
GPU host that runs it has no jax. A subprocess poisons those modules in
sys.modules (so any import of them raises) and imports every submodule of
the package, then trains a tiny model through the CLI; chip_smoke.py
names none of them either."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unilm_tpu")

_POISON = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
"""

_SCRIPT = _POISON + r"""
import importlib, pkgutil
import unilm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unilm_tpu_torch.__path__,
                                               "unilm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "unilm_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
"""

_TRAIN = _POISON + r"""
import numpy as np
import torch
from unilm_tpu_torch.cli import train_gpt
from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset

torch.set_num_threads(1)
work = sys.argv[1]
rng = np.random.RandomState(0)
build_indexed_dataset(work + "/data", [rng.randint(4, 300, size=40)
                                       for _ in range(8)])
train_gpt.main(["--data", work + "/data", "--save_dir", work + "/ckpt",
                "--dim", "32", "--layers", "1", "--heads", "2", "--ffn", "64",
                "--vocab", "300", "--tokens_per_sample", "16",
                "--batch_size", "2", "--max_steps", "2", "--fused_ce",
                "--ce_chunk", "128", "--log_every", "1", "--device", "cpu"])
"""

_FINETUNE = _POISON + r"""
import os
import numpy as np
import torch
from PIL import Image
from unilm_tpu_torch.cli import train_classification
from unilm_tpu_torch.models import beit

torch.set_num_threads(1)
work = sys.argv[1]
rng = np.random.RandomState(0)
for c in ("a", "b"):
    os.makedirs(f"{work}/imgs/{c}")
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (40, 40, 3)).astype(np.uint8)
                        ).save(f"{work}/imgs/{c}/{i}.png")
beit.beit_tiny = lambda **kw: beit.BeitConfig(
    **{**dict(img_size=32, patch_size=8, embed_dim=32, num_layers=2,
              num_heads=2, ffn_dim=64), **kw})
state = train_classification.main([
    "--model", "beit_tiny", "--data_path", work + "/imgs", "--device", "cpu",
    "--batch_size", "4", "--epochs", "1", "--clip_grad", "3.0",
    "--output_dir", work + "/ckpt"])
print("steps", state.step)
"""

_FUNSD = _POISON + r"""
import numpy as np
import torch
from unilm_tpu_torch.cli import run_funsd
from unilm_tpu_torch.models import layoutlmv3

torch.set_num_threads(1)
cfg = layoutlmv3.LayoutLMv3Config(
    vocab_size=50, hidden_size=64, num_layers=1, num_heads=1, ffn_dim=64,
    max_positions=40, coordinate_size=11, shape_size=10, input_size=32,
    num_labels=7)
model = layoutlmv3.LayoutLMv3ForTokenClassification(cfg).init_weights(
    torch.Generator().manual_seed(0)).eval()
rng = np.random.RandomState(0)
xy = np.sort(rng.randint(0, 900, (2, 12, 2, 2)), axis=2)
batch = dict(input_ids=rng.randint(3, 50, (2, 12)),
             attention_mask=np.ones((2, 12), np.int64),
             bbox=xy.transpose(0, 1, 3, 2).reshape(2, 12, 4),
             labels=rng.randint(0, 7, (2, 12)), segments=rng.randint(0, 3, (2, 12)),
             images=rng.rand(2, 32, 32, 3).astype(np.float32))
logits, labels = run_funsd.evaluate_batches(model, [batch])
print("f1", run_funsd.score(logits, labels)["f1"])
"""

_YOCO = _POISON + r"""
import torch
from unilm_tpu_torch.models import yoco
from unilm_tpu_torch.runtime import generate

torch.set_num_threads(1)
for self_type in ("sliding_window", "gate_retention"):
    cfg = yoco.YOCOConfig(vocab_size=64, dim=32, self_layers=1,
                          cross_layers=1, num_heads=4, kv_heads=2, ffn_dim=64,
                          window_size=4, self_type=self_type)
    model = yoco.YOCO(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    toks, lens = generate.generate(
        generate.GenerationConfig(beam_size=1, max_new_tokens=4, eos=-1),
        *yoco.make_yoco_generate_fns(model, cache_size=9),
        torch.randint(2, 64, (2, 5), generator=torch.Generator().manual_seed(1)))
    print(self_type, tuple(toks.shape), lens.tolist())
"""

_KOSMOS_INFER = _POISON + r"""
import numpy as np
import torch
from PIL import Image
from unilm_tpu_torch.cli import kosmos_infer

torch.set_num_threads(1)
work = sys.argv[1]
Image.fromarray((np.random.RandomState(0).rand(32, 48, 3) * 255).astype(
    np.uint8)).save(work + "/doc.png")
kosmos_infer.main(["--image", work + "/doc.png", "--tiny", "--fp32",
                   "--int8", "--beam", "2", "--max_new_tokens", "3",
                   "--max_patches", "16", "--num_image_tokens", "8",
                   "--image_id", "5", "--image_end_id", "6", "--md_id", "8",
                   "--device", "cpu"])
"""

_KOSMOS2 = _POISON + r"""
import json
import torch
from unilm_tpu_torch.cli import kosmos_ground_eval, kosmos_seedbench, train_gpt

torch.set_num_threads(1)
work = sys.argv[1]
small = ["--image_tokens", "4", "--image_size", "28", "--dim", "32",
         "--layers", "1", "--heads", "2", "--clip_dim", "32",
         "--device", "cpu"]
with open(work + "/ref.jsonl", "w") as f:
    f.write(json.dumps({"image": None, "expression": "a dog",
                        "box": [0.1, 0.1, 0.5, 0.5]}) + "\n")
kosmos_ground_eval.main(["--task", "refcoco", "--data", work + "/ref.jsonl",
                         "--max_new_tokens", "3"] + small)
with open(work + "/seed.jsonl", "w") as f:
    f.write(json.dumps({"image": None, "question": "What?", "answer": "A",
                        "choices": ["a", "b", "c", "d"]}) + "\n")
kosmos_seedbench.main(["--data", work + "/seed.jsonl"] + small)
with open(work + "/vl.jsonl", "w") as f:
    for i in range(4):
        f.write(json.dumps({"caption": f"a dog {i}", "image": None,
                            "objects": [{"span": [0, 5],
                                         "boxes": [[0.1, 0.1, 0.5, 0.5]]}]})
                + "\n")
train_gpt.main(["--vl_data", work + "/vl.jsonl", "--save_dir", work + "/ck",
                "--dim", "32", "--layers", "1", "--heads", "2", "--ffn", "64",
                "--image_tokens", "4", "--image_size", "28", "--clip_dim",
                "32", "--tokens_per_sample", "24", "--batch_size", "2",
                "--max_steps", "1", "--device", "cpu"])
"""

_BEIT_FAMILY = _POISON + r"""
import torch
from unilm_tpu_torch.models import beit2, beit3, dalle_vae, registry, vlmo

torch.set_num_threads(1)
g = torch.Generator().manual_seed(0)
cfg = beit3.BEiT3Config(vocab_size=50, embed_dim=32, num_layers=2,
                        num_heads=4, ffn_dim=64, img_size=16, patch_size=8)
img = torch.randn(2, 16, 16, 3, generator=g)
txt = torch.randint(4, 50, (2, 5), generator=g)
pad = torch.zeros(2, 5, dtype=torch.bool)
pad[1, 3:] = True
with torch.no_grad():
    vqa = beit3.BEiT3ForVisualQuestionAnswering(cfg, num_answers=3)
    print("vqa", tuple(vqa.init_weights(g)(img, txt, pad).shape))
    itm = vlmo.VLMoForImageTextMatching(cfg).init_weights(g)
    print("itm", tuple(itm(img, txt, pad).shape))
    vq = beit2.VQKD(beit2.VQKDConfig(
        img_size=16, patch_size=8, encoder_dim=32, encoder_layers=1,
        encoder_heads=4, decoder_dim=32, decoder_layers=1, decoder_heads=4,
        codebook_size=16, codebook_dim=8, teacher_dim=8)).init_weights(g)
    ids = vq.get_codebook_indices(img)
    vq(img, update_ema=True)
    cls = beit2.BEiT2ForMaskedImageModelingCLS(beit2.Beit2PretrainConfig(
        img_size=16, patch_size=8, embed_dim=32, num_layers=2, num_heads=4,
        vocab_size=16, early_layer=0)).init_weights(g)
    logits, logits_cls = cls(img, torch.ones(2, 4, dtype=torch.bool))
    dalle = dalle_vae.DalleEncoder(dalle_vae.DalleEncoderConfig(
        n_hid=8, n_blk_per_group=1, vocab_size=16)).init_weights(g)
    print("ids", tuple(ids.shape), tuple(logits_cls.shape),
          tuple(dalle.get_codebook_indices(img.sigmoid()).shape))
print("archs", len(registry.names()))
"""

# the modules each slice of the port added; every one must be among them
PORTED = {"core.config", "core.layers", "core.positional", "core.transformer",
          "ops._native", "ops.attention", "ops.flash_attention",
          "ops.paged_attention", "ops.quant", "models.kosmos",
          "runtime.generate", "runtime.paged_kv", "runtime.serving",
          "convert.from_jax", "core.attention", "ops.fused_ce",
          "runtime.train", "runtime.optim", "runtime.checkpoint",
          "runtime.logging", "cli.train_gpt", "data.indexed_dataset",
          "data.iterators", "data.dictionary", "core.embedding",
          "models.beit", "convert.beit", "data.transforms", "scoring",
          "cli.run_class_finetuning", "runtime.device",
          "cli.train_classification", "data.masking", "ops.doc_attention",
          "ops.bucket_bias", "models.layoutlmv3", "convert.layoutlmv3",
          "convert.common", "data.document_datasets", "cli.run_funsd",
          "ops.retention", "models.yoco", "ops.fused", "cli.kosmos_infer",
          "convert.kosmos", "models.trocr", "convert.trocr",
          "data.trocr_datasets", "cli.trocr_infer", "cli.trocr_eval",
          "data.grounding", "data.vl_loaders", "scoring_grounding",
          "scoring_seedbench", "cli.kosmos_ground_eval", "cli.kosmos_demo",
          "cli.kosmos_seedbench", "core.multiway", "models.beit3",
          "models.vlmo", "models.beit2", "models.dalle_vae", "convert.dalle",
          "models.registry", "runtime.metrics", "runtime.criterions",
          "runtime.profiling", "ops.dropout", "ops.collectives", "core.moe",
          "parallel.mesh", "parallel.sharding", "parallel.ring_attention",
          "parallel.long_context", "parallel.pipeline", "parallel.dryrun",
          "models.retrieval", "models.unilm_s2s", "models.translation",
          "models.deltalm", "models.retnet", "models.diff_transformer",
          "models.wavlm", "convert.wavlm", "models.beats", "models.speecht5",
          "models.speechlm"}


_PARALLEL = _POISON + r"""
import numpy as np
import torch
import torch.distributed as dist
from unilm_tpu_torch.cli import train_gpt
from unilm_tpu_torch.core.config import TransformerConfig
from unilm_tpu_torch.data.indexed_dataset import build_indexed_dataset
from unilm_tpu_torch.parallel.long_context import SeqParallelLM
from unilm_tpu_torch.parallel.mesh import make_mesh
from unilm_tpu_torch.parallel.sharding import shard_parameters
from unilm_tpu_torch.runtime.optim import AdamW
from unilm_tpu_torch.runtime.train import TrainState, make_train_step

torch.set_num_threads(1)
work = sys.argv[1]
dist.init_process_group("gloo", init_method=f"file://{work}/init", rank=0,
                        world_size=1)
rng = np.random.RandomState(0)
build_indexed_dataset(work + "/data", [rng.randint(4, 300, size=40)
                                       for _ in range(8)])
args = train_gpt.build_parser().parse_args([
    "--data", work + "/data", "--dim", "32", "--layers", "2", "--heads", "2",
    "--ffn", "64", "--vocab", "300", "--tokens_per_sample", "16",
    "--batch_size", "2", "--moe_freq", "2", "--moe_experts", "2",
    "--device", "cpu"])
tr = train_gpt.build_trainer(args)
sync = shard_parameters(tr.model, make_mesh({"data": -1}))
_, m = tr.step_fn(tr.state, tr.next_batch())
print("moe", sorted(m))
cfg = TransformerConfig(vocab_size=64, embed_dim=32, num_layers=1,
                        num_heads=2, ffn_dim=64, xpos_rel_pos=True)
lm = SeqParallelLM(cfg, make_mesh({"seq": -1}), "seq")
lm.init_weights(torch.Generator().manual_seed(0))
tx = AdamW(1e-3)
_, m = make_train_step(lm.loss_fn, tx, grad_sync=lm)(
    TrainState.create(lm, tx), torch.randint(3, 64, (1, 16)))
print("seq", bool(np.isfinite(float(m["loss"]))))
dist.destroy_process_group()
"""


def test_parallel_layer_runs_without_jax(tmp_path):
    """An MoE train step through the CLI with its parameters placed on a
    one-rank mesh, and a SeqParallelLM step through the ring on a
    one-rank gloo group, reach no JAX module."""
    res = subprocess.run([sys.executable, "-c", _PARALLEL, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "moe ['grad_norm', 'loss', 'moe_overflow', 'ntok']", \
        lines
    assert lines[1] == "seq True", lines


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert {f"unilm_tpu_torch.{m}" for m in PORTED} <= names, res.stdout


def test_train_cli_runs_without_jax(tmp_path):
    """Importing is not enough: the CLI's setup and loop (corpus, stream,
    model, step, checkpoint) must reach no JAX module when they run."""
    res = subprocess.run([sys.executable, "-c", _TRAIN, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "done" in res.stdout.split(), res.stdout


def test_finetune_cli_runs_without_jax(tmp_path):
    """One BEiT fine-tune step (mixup/cutmix, drop-path, layer-decay
    AdamW, EMA, checkpoint) through cli.train_classification reaches no
    JAX module."""
    res = subprocess.run([sys.executable, "-c", _FINETUNE, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "steps 1" in res.stdout, res.stdout


def test_chip_smoke_names_no_jax_module():
    """chip_smoke.py runs on a host without jax: no import statement in it,
    at module level or inside a function, names the JAX package."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "unilm_tpu_torch.data.indexed_dataset" in names


def test_funsd_eval_runs_without_jax():
    """A LayoutLMv3 forward with the fused bias through the FUNSD CLI's
    evaluate_batches and score reaches no JAX module."""
    res = subprocess.run([sys.executable, "-c", _FUNSD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "f1" in res.stdout, res.stdout


def test_yoco_generation_runs_without_jax():
    """YOCO's prefill and greedy decode through runtime.generate, both
    self-layer types, reach no JAX module."""
    res = subprocess.run([sys.executable, "-c", _YOCO], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "sliding_window (2, 9) [9, 9]" in res.stdout, res.stdout
    assert "gate_retention (2, 9) [9, 9]" in res.stdout, res.stdout


def test_kosmos_infer_runs_without_jax(tmp_path):
    """cli/kosmos_infer.py --tiny --int8 --beam 2 on an image (the tower,
    the resampler, the int8 decoder and KV pool, beam search) reaches no
    JAX module and prints the generated ids."""
    res = subprocess.run([sys.executable, "-c", _KOSMOS_INFER,
                          str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    ids = res.stdout.strip().splitlines()[-1].split()
    assert len(ids) == 3 and all(t.isdigit() for t in ids), res.stdout


def test_kosmos2_clis_run_without_jax(tmp_path):
    """The refcoco eval and SEED-Bench CLIs' model modes and one --vl_data
    training step (the CLIP tower, grounding markup, the VL stream)
    reach no JAX module."""
    res = subprocess.run([sys.executable, "-c", _KOSMOS2, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert '"num_refs": 1.0' in lines[0] and '"total": 1' in lines[1], lines
    assert lines[-1] == "done", lines


def test_beit_family_runs_without_jax():
    """BEiT-3 VQA and VLMo ITM forwards (the multiway core), VQ-KD ids and
    an EMA update, the BEiT-2 CLS heads, DALL-E ids and the registry reach
    no JAX module."""
    res = subprocess.run([sys.executable, "-c", _BEIT_FAMILY], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines == ["vqa (2, 3)", "itm (2, 2)", "ids (2, 4) (2, 4, 16) (2, 4)",
                     "archs 28"], lines


_DETECTION = _POISON + r"""
import torch
from unilm_tpu_torch.cli import train_detection, train_segmentation

torch.set_num_threads(1)
common = ["--tiny", "--synthetic", "--synthetic-n", "4", "--img-size", "64",
          "--batch-size", "2", "--steps", "2", "--eval", "--device", "cpu"]
for head in ("fcos", "rcnn"):
    state, res = train_detection.main(["--head", head, *common])
    print(head, state.step, sorted(res)[:3])
state, res = train_segmentation.main(common)
print("upernet", state.step, sorted(res))
"""


def test_detection_clis_run_without_jax():
    """cli/train_detection (both heads) and cli/train_segmentation train and
    evaluate at --tiny --synthetic --device cpu with JAX poisoned."""
    res = subprocess.run([sys.executable, "-c", _DETECTION], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.strip().splitlines()
             if not l.startswith(("step", "{"))]
    assert lines == ["fcos 2 ['AP50', 'AP75', 'AP_class_0']",
                     "rcnn 2 ['AP50', 'AP75', 'AP_class_0']",
                     "upernet 2 ['aAcc', 'mAcc', 'mIoU']"], lines
