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
print(len(names))
"""


def test_port_imports_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # core, ops, models, runtime, convert and their modules
    assert int(res.stdout.strip()) >= 15, res.stdout
