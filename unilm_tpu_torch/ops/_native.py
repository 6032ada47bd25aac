"""Build and bind the hand-written CUDA kernels under csrc/.

Each `csrc/*.cu` file has a plain C interface and is compiled by nvcc, at
first use, into its own shared library under `unilm_tpu_torch/_build/`
(listed in .gitignore), then loaded with ctypes. Pointers and the CUDA
stream go across as `c_void_p`, integers as `c_int`.

A library's file name carries a hash of everything that decides its
contents: the `.cu` source, every `csrc/*.cuh` header it includes
(followed transitively), `NVCC_FLAGS` and the output of `nvcc --version`,
e.g. `int8_matmul.3f2a9c0d1e4b5a67.so`. A changed header, flag or
compiler therefore builds a new library instead of loading a stale one.

Every exported launcher returns `cudaGetLastError()`; `CudaKernel.launch`
raises if it is not 0 and counts the launch only when it succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)
_NVCC_VERSION: Dict[str, str] = {}


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


def _nvcc_version(nvcc: str) -> str:
    if nvcc not in _NVCC_VERSION:
        res = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True)
        _NVCC_VERSION[nvcc] = res.stdout
    return _NVCC_VERSION[nvcc]


def _headers(source: Path) -> List[Path]:
    """The csrc/*.cuh files `source` includes, transitively, in a fixed
    order. A quoted include is looked up beside the including file."""
    seen: List[Path] = []
    todo = [source]
    while todo:
        text = todo.pop().read_text()
        for name in _INCLUDE.findall(text):
            path = (source.parent / name).resolve()
            if path not in seen:
                seen.append(path)
                todo.append(path)
    return sorted(seen)


class CudaKernel:
    """One csrc source file, its shared library and its launch counter.

    `launches` is a plain integer: `launch` adds one each time the kernel
    was launched without error, and nothing else touches it except a
    caller resetting it. Two CudaKernel objects may name the same source
    (one counter for each launcher); they share its library."""

    def __init__(self, source: str, functions: Dict[str, List]):
        self.source = CSRC / source
        self.functions = functions
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def so_path(self, nvcc: Optional[str] = None) -> Path:
        """Where the library for the current source, headers, flags and
        compiler lives."""
        nvcc = nvcc or _nvcc()
        h = hashlib.sha256()
        for part in (self.source, *_headers(self.source)):
            h.update(part.name.encode() + b"\0" + part.read_bytes() + b"\0")
        h.update("\0".join(NVCC_FLAGS).encode() + b"\0")
        h.update(_nvcc_version(nvcc).encode())
        return BUILD / f"{self.source.stem}.{h.hexdigest()[:16]}.so"

    def _compile_cmd(self, nvcc: str, out: Path) -> List[str]:
        return [nvcc, *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def ensure_built(self) -> Path:
        """Compile the library unless one for this exact input exists;
        return its path. Raises RuntimeError with nvcc's stderr."""
        return build_all([self])[0]

    def _load(self, so: Path) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(so))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def build(self) -> ctypes.CDLL:
        """Compile when needed and load."""
        if self._lib is None:
            self._load(self.ensure_built())
        return self._lib

    def launch(self, name: str, *args) -> None:
        lib = self.build()
        err = getattr(lib, name)(*args)
        if err != 0:
            msg = lib.error_string(err).decode()
            raise RuntimeError(f"{self.source.name}:{name} failed: CUDA "
                               f"error {err} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> List[Path]:
    """Compile the libraries of `kernels` that are missing, one nvcc per
    source, all started together; return their paths in order."""
    kernels = list(kernels)
    nvcc = _nvcc()
    paths = [k.so_path(nvcc) for k in kernels]
    running = {}
    for kern, so in zip(kernels, paths):
        if so.exists() or so in running:
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(kern._compile_cmd(nvcc, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[so] = (kern, tmp, proc)
    failed = []
    for so, (kern, tmp, proc) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {kern.source.name} "
                          f"(rc {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


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
