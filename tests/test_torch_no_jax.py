"""unilm_tpu_torch must import without jax, flax or unilm_tpu: the GPU
host that runs it has no jax. A subprocess poisons those modules in
sys.modules (so any import of them raises) and imports every submodule of
the package."""

import os
import subprocess
import sys

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "unilm_tpu"):
    sys.modules[name] = None
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

# the modules each slice of the port added; every one must be among them
PORTED = {"core.config", "core.layers", "core.positional", "core.transformer",
          "ops._native", "ops.attention", "ops.flash_attention",
          "ops.paged_attention", "ops.quant", "models.kosmos",
          "runtime.generate", "runtime.paged_kv", "runtime.serving",
          "convert.from_jax"}


def test_port_imports_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert {f"unilm_tpu_torch.{m}" for m in PORTED} <= names, res.stdout
