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
                "--ce_chunk", "128", "--log_every", "1"])
"""

# the modules each slice of the port added; every one must be among them
PORTED = {"core.config", "core.layers", "core.positional", "core.transformer",
          "ops._native", "ops.attention", "ops.flash_attention",
          "ops.paged_attention", "ops.quant", "models.kosmos",
          "runtime.generate", "runtime.paged_kv", "runtime.serving",
          "convert.from_jax", "core.attention", "ops.fused_ce",
          "runtime.train", "runtime.optim", "runtime.checkpoint",
          "runtime.logging", "cli.train_gpt", "data.indexed_dataset",
          "data.iterators", "data.dictionary"}


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
