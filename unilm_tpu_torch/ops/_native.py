"""Build and bind the hand-written CUDA kernels under csrc/.

Each `csrc/*.cu` file has a plain C interface and is compiled by nvcc, at
first use, into its own shared library under `unilm_tpu_torch/_build/`
(listed in .gitignore), then loaded with ctypes. Pointers and the CUDA
stream go across as `c_void_p`, integers as `c_int`.
Every exported launcher returns `cudaGetLastError()`; `CudaKernel.launch`
raises if it is not 0 and counts the launch only when it succeeded.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "unilm_tpu_torch are built from csrc/ at first use on a CUDA host")


class CudaKernel:
    """One csrc source file, its shared library and its launch counter.

    `launches` is a plain integer: `launch` adds one each time the kernel
    was launched without error, and nothing else touches it except a
    caller resetting it."""

    def __init__(self, source: str, functions: Dict[str, List]):
        self.source = CSRC / source
        self.functions = functions
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def so_path(self) -> Path:
        return BUILD / (self.source.stem + ".so")

    def build(self) -> ctypes.CDLL:
        """Compile (when the library is missing or older than its source)
        and load. Raises RuntimeError with nvcc's stderr on failure."""
        if self._lib is not None:
            return self._lib
        so = self.so_path
        if not so.exists() or so.stat().st_mtime < self.source.stat().st_mtime:
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source.name} "
                    f"(rc {res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def launch(self, name: str, *args) -> None:
        lib = self.build()
        err = getattr(lib, name)(*args)
        if err != 0:
            msg = lib.error_string(err).decode()
            raise RuntimeError(f"{self.source.name}:{name} failed: CUDA "
                               f"error {err} ({msg})")
        self.launches += 1


def check_tensor(name: str, t: torch.Tensor, *, dtype, shape, device) -> None:
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype` and
    `shape`, contiguous and 16-byte aligned (the kernels' vector loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
